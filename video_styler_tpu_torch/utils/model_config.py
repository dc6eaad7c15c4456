"""Declarative weight sources, resolved on local disk only.

Counterpart of `video_styler_tpu/utils/model_config.py` (`ModelConfig`
:41-118) without its download transports: a weight source is a local
`path` (a file or a list of shards), or a `model_id` +
`origin_file_pattern` found under `local_model_path` (default
$VIDEO_STYLER_MODEL_DIR, else ./models) in the ModelScope layout
<local_model_path>/<model_id>/<origin_file_pattern>. A source that is not
there raises `FileNotFoundError` naming where it looked; the port fetches
nothing.
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import List, Optional, Union


def default_model_dir() -> str:
    return os.environ.get("VIDEO_STYLER_MODEL_DIR", "./models")


@dataclasses.dataclass
class ModelConfig:
    """path: local file / shard list. model_id + origin_file_pattern:
    files under the local model directory. model_kind overrides structural
    detection (`utils.ckpt.detect_model_kind`)."""
    path: Union[str, List[str], None] = None
    model_id: Optional[str] = None
    origin_file_pattern: Union[str, List[str], None] = None
    local_model_path: Optional[str] = None
    model_kind: Optional[str] = None

    def resolve(self) -> None:
        """Set `path` from model_id + origin_file_pattern, or raise."""
        if self.path is not None:
            return
        if self.model_id is None:
            raise ValueError(
                'No valid model files. Use ModelConfig(path="xxx") or '
                'ModelConfig(model_id="xxx/yyy", origin_file_pattern="zzz").')
        local_dir = os.path.join(self.local_model_path or default_model_dir(),
                                 self.model_id)
        pattern = self.origin_file_pattern or ""
        if pattern == "" or (isinstance(pattern, str) and pattern.endswith("/")):
            found = os.path.join(local_dir, pattern)
            if not os.path.isdir(found):
                raise FileNotFoundError(f"no folder {found!r} (model_id="
                                        f"{self.model_id!r}); the port downloads nothing")
        else:
            found = []
            for pat in pattern if isinstance(pattern, list) else [pattern]:
                found += sorted(_glob.glob(os.path.join(local_dir, pat)))
            if not found:
                raise FileNotFoundError(
                    f"no files matching {pattern!r} under {local_dir!r} (model_id="
                    f"{self.model_id!r}); the port downloads nothing")
            if len(found) == 1:
                found = found[0]
        self.path = found

    def paths(self) -> List[str]:
        self.resolve()
        return [self.path] if isinstance(self.path, str) else list(self.path)
