"""Declarative weight sources: a local path, or a model id fetched once.

Counterpart of `video_styler_tpu/utils/model_config.py` (`ModelConfig`):
a weight source is a local `path` (a file or a list of shards), or a
`model_id` + `origin_file_pattern` resolved in this order:

  1. a copy already under `local_model_path` (default
     $VIDEO_STYLER_MODEL_DIR, else ./models) in the ModelScope layout
     <local_model_path>/<model_id>/<origin_file_pattern>;
  2. the transport registered under `download_resource`
     (`register_transport`; the stock ModelScope and Hugging Face ones of
     `utils.downloader` are registered on first need), called on rank 0
     only while the other ranks wait at a barrier; rank 0's failure is
     raised on every rank. With VIDEO_STYLER_OFFLINE=1 (or
     `skip_download`) nothing is fetched;
  3. else a `FileNotFoundError` naming where it looked.
"""
from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Callable, List, Optional, Union

_TRANSPORTS = {}


def register_transport(name: str, fn: Callable[[str, str, Optional[str]], object]):
    """fn(model_id, local_dir, allow_file_pattern) downloads into local_dir."""
    _TRANSPORTS[name] = fn


def default_model_dir() -> str:
    return os.environ.get("VIDEO_STYLER_MODEL_DIR", "./models")


def _download(resource: str, model_id: str, local_dir: str, allow) -> None:
    """The transport's fetch on rank 0, a barrier for the others, and rank
    0's error (if any) raised on every rank."""
    from ..parallel.distributed import broadcast_object, is_main_process, sync_processes
    transport = _TRANSPORTS.get(resource)
    if transport is None:
        from .downloader import ensure_default_transports
        ensure_default_transports()
        transport = _TRANSPORTS.get(resource)
    if transport is None:
        raise RuntimeError(f"model_id={model_id!r} is not under {local_dir!r} and no "
                           f"transport is registered for {resource!r}: place the files "
                           f"there or register_transport({resource!r}, fn)")
    error = None
    if is_main_process():
        try:
            transport(model_id, local_dir, allow)
        except Exception as e:  # noqa: BLE001 - raised on every rank below
            error = f"{type(e).__name__}: {e}"
    error = broadcast_object(error)
    sync_processes()
    if error is not None:
        raise RuntimeError(f"download of {model_id!r} from {resource} failed: {error}")


@dataclasses.dataclass
class ModelConfig:
    """path: local file / shard list. model_id + origin_file_pattern: files
    under the local model directory, fetched there when missing.
    model_kind overrides structural detection
    (`utils.ckpt.detect_model_kind`)."""
    path: Union[str, List[str], None] = None
    model_id: Optional[str] = None
    origin_file_pattern: Union[str, List[str], None] = None
    download_resource: str = "ModelScope"
    local_model_path: Optional[str] = None
    skip_download: bool = False
    model_kind: Optional[str] = None

    def resolve(self) -> None:
        """Set `path` from model_id + origin_file_pattern, or raise."""
        if self.path is not None:
            return
        if self.model_id is None:
            raise ValueError(
                'No valid model files. Use ModelConfig(path="xxx") or '
                'ModelConfig(model_id="xxx/yyy", origin_file_pattern="zzz").')
        local_dir = os.path.join(self.local_model_path or default_model_dir(), self.model_id)
        pattern = self.origin_file_pattern or ""
        is_folder = pattern == "" or (isinstance(pattern, str) and pattern.endswith("/"))

        def find():
            if is_folder:
                folder = os.path.join(local_dir, pattern)
                return folder if os.path.isdir(folder) else None
            found = []
            for pat in pattern if isinstance(pattern, list) else [pattern]:
                found += sorted(_glob.glob(os.path.join(local_dir, pat)))
            return found or None

        found = find()
        if found is None and not self.skip_download:
            from .downloader import offline
            if offline():
                raise FileNotFoundError(
                    f"no files matching {pattern!r} under {local_dir!r} (model_id="
                    f"{self.model_id!r}), and VIDEO_STYLER_OFFLINE=1 keeps the download off")
            _download(self.download_resource, self.model_id, local_dir,
                      None if is_folder else pattern)
            found = find()
        if found is None:
            raise FileNotFoundError(f"no files matching {pattern!r} under {local_dir!r} "
                                    f"(model_id={self.model_id!r})")
        if isinstance(found, list) and len(found) == 1:
            found = found[0]
        self.path = found

    def paths(self) -> List[str]:
        self.resolve()
        return [self.path] if isinstance(self.path, str) else list(self.path)
