"""ModelLogger: periodic LoRA checkpoints as safetensors.

Counterpart of `video_styler_tpu/trainers/logger.py`: saves the LoRA every
`save_steps` steps (`step-N.safetensors`), or at each epoch's end when no
step interval is set (`epoch-N.safetensors`), with reference-style keys.
"""
from __future__ import annotations

import os
from typing import Optional

from ..safetensors_io import save_file
from .lora_train import LoRA, export_lora_state_dict


class ModelLogger:
    def __init__(self, output_path: str, save_steps: Optional[int] = None,
                 rename_blocks_to: Optional[str] = None):
        self.output_path = output_path
        self.save_steps = save_steps
        self.rename_blocks_to = rename_blocks_to
        self.num_steps = 0
        os.makedirs(output_path, exist_ok=True)

    def _export(self, lora: LoRA):
        sd = export_lora_state_dict(lora)
        if self.rename_blocks_to:
            sd = {k.replace("blocks.", self.rename_blocks_to + ".", 1)
                  if k.startswith("blocks.") else k: v for k, v in sd.items()}
        return sd

    def _save(self, lora: LoRA, name: str):
        save_file(self._export(lora), os.path.join(self.output_path, name))

    def on_step_end(self, lora: LoRA):
        self.num_steps += 1
        if self.save_steps and self.num_steps % self.save_steps == 0:
            self._save(lora, f"step-{self.num_steps}.safetensors")

    def on_epoch_end(self, lora: LoRA, epoch_id: int):
        if self.save_steps is None:
            self._save(lora, f"epoch-{epoch_id}.safetensors")
