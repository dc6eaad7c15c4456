"""Post-processing and scoring of rendered frames: FastBlend, RIFE, ESRGAN
and the image-quality metrics (the JAX package's `extensions/`)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device


def nest_state_dict(sd: Dict, device=None, strip: str = "") -> Dict:
    """A torch state dict (numpy arrays or tensors) -> a dict nested by
    the dotted module names (`strip` removed from the front), of float32
    tensors on `device` (the card unless "cpu"), as the JAX converters
    nest theirs."""
    device = resolve_device(device)
    root: Dict = {}
    for key, val in sd.items():
        parts = key.removeprefix(strip).split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        val = val if torch.is_tensor(val) else torch.from_numpy(np.array(val))
        node[parts[-1]] = val.to(device=device, dtype=torch.float32)
    return root
