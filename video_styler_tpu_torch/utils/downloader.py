"""HTTP download transports for weights and tokenizers: the ModelScope
repository layout, and Hugging Face's.

Counterpart of `video_styler_tpu/utils/downloader.py`, over stdlib
`urllib` (no SDK), behind `utils.model_config.register_transport`:

  ModelScope:  GET {EP}/api/v1/models/{model_id}/repo/files?Recursive=true
               -> {"Data": {"Files": [{"Path": ...}, ...]}}
               GET {EP}/api/v1/models/{model_id}/repo?FilePath={path}
  HuggingFace: GET {EP}/api/models/{model_id}
               -> {"siblings": [{"rfilename": ...}, ...]}
               GET {EP}/{model_id}/resolve/main/{path}

The endpoints come from VIDEO_STYLER_MODELSCOPE_ENDPOINT and
VIDEO_STYLER_HF_ENDPOINT (or HF_ENDPOINT), else the public hosts; a GET
retries with exponential backoff and writes through a `.part` file that
is renamed when complete. VIDEO_STYLER_OFFLINE=1 refuses every fetch with
a RuntimeError. A transport runs on one process: `ModelConfig` calls it
on rank 0 and holds the others at a barrier.
"""
from __future__ import annotations

import fnmatch
import json
import os
import shutil
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional

DEFAULT_MODELSCOPE_ENDPOINT = "https://modelscope.cn"
DEFAULT_HF_ENDPOINT = "https://huggingface.co"


def offline() -> bool:
    return os.environ.get("VIDEO_STYLER_OFFLINE", "0") == "1"


def _modelscope_endpoint() -> str:
    return os.environ.get("VIDEO_STYLER_MODELSCOPE_ENDPOINT",
                          DEFAULT_MODELSCOPE_ENDPOINT).rstrip("/")


def _hf_endpoint() -> str:
    return os.environ.get("VIDEO_STYLER_HF_ENDPOINT",
                          os.environ.get("HF_ENDPOINT", DEFAULT_HF_ENDPOINT)).rstrip("/")


def _http_get(url: str, dest: Optional[str] = None, retries: int = 3,
              backoff: float = 1.0, timeout: float = 60.0):
    """GET with `retries` attempts, sleeping backoff * 2^i between them.
    Returns the body, or writes it to `dest` (through `dest`.part, renamed
    when complete) and returns the path."""
    if offline():
        raise RuntimeError(f"VIDEO_STYLER_OFFLINE=1: refusing network fetch of {url}")
    last = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(url, headers={"User-Agent": "video-styler/0.1"})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                if dest is None:
                    return r.read()
                os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
                part = dest + ".part"
                with open(part, "wb") as f:
                    shutil.copyfileobj(r, f, length=1 << 20)
                os.replace(part, dest)
                return dest
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            last = e
            if attempt + 1 < retries:
                time.sleep(backoff * (2 ** attempt))
    raise RuntimeError(f"download failed after {retries} attempts: {url} "
                       f"({type(last).__name__}: {last})")


def _match(files: List[str], allow_file_pattern) -> List[str]:
    """The files a `ModelConfig.origin_file_pattern` selects: all for None
    or "", the subtree for "dir/", else fnmatch globs (a pattern or a list
    of them), in listing order without repeats."""
    if not allow_file_pattern:
        return files
    pats = allow_file_pattern if isinstance(allow_file_pattern, list) else [allow_file_pattern]
    out: List[str] = []
    for pat in pats:
        if pat.endswith("/"):
            out += [f for f in files if f.startswith(pat)]
        else:
            out += [f for f in files if fnmatch.fnmatch(f, pat)]
    return list(dict.fromkeys(out))


def _fetch_all(files: List[str], local_dir: str, url_of) -> List[str]:
    got = []
    for f in files:
        dest = os.path.join(local_dir, f)
        if not os.path.exists(dest):
            _http_get(url_of(urllib.parse.quote(f)), dest=dest)
        got.append(dest)
    return got


def modelscope_list_files(model_id: str) -> List[str]:
    url = f"{_modelscope_endpoint()}/api/v1/models/{model_id}/repo/files?Recursive=true"
    entries = (json.loads(_http_get(url)).get("Data") or {}).get("Files") or []
    return [e["Path"] for e in entries if e.get("Type", "blob") != "tree" and "Path" in e]


def modelscope_transport(model_id: str, local_dir: str, allow_file_pattern=None) -> List[str]:
    """The repository's files that the pattern selects, into `local_dir`
    under their repository paths (files already there are kept)."""
    files = _match(modelscope_list_files(model_id), allow_file_pattern)
    if not files:
        raise FileNotFoundError(f"ModelScope repo {model_id!r} has no files matching "
                                f"{allow_file_pattern!r}")
    ep = _modelscope_endpoint()
    return _fetch_all(files, local_dir,
                      lambda f: f"{ep}/api/v1/models/{model_id}/repo?FilePath={f}")


def huggingface_list_files(model_id: str) -> List[str]:
    data = json.loads(_http_get(f"{_hf_endpoint()}/api/models/{model_id}"))
    return [s["rfilename"] for s in data.get("siblings", []) if "rfilename" in s]


def huggingface_transport(model_id: str, local_dir: str, allow_file_pattern=None) -> List[str]:
    """`modelscope_transport` against the Hugging Face layout."""
    files = _match(huggingface_list_files(model_id), allow_file_pattern)
    if not files:
        raise FileNotFoundError(f"HuggingFace repo {model_id!r} has no files matching "
                                f"{allow_file_pattern!r}")
    ep = _hf_endpoint()
    return _fetch_all(files, local_dir, lambda f: f"{ep}/{model_id}/resolve/main/{f}")


_REGISTERED = False


def ensure_default_transports() -> None:
    """Register the two transports under the names `ModelConfig` takes in
    `download_resource` ("ModelScope", "HuggingFace"), once."""
    global _REGISTERED
    if _REGISTERED:
        return
    from .model_config import register_transport
    register_transport("ModelScope", modelscope_transport)
    register_transport("HuggingFace", huggingface_transport)
    _REGISTERED = True


# the umT5-XXL tokenizer's files, fetched on demand (the package ships no
# third-party assets)
UMT5_TOKENIZER_FILES = ["spiece.model", "tokenizer.json", "tokenizer_config.json",
                        "special_tokens_map.json"]


def download_tokenizer(model_id: str = "google/umt5-xxl", local_dir: Optional[str] = None,
                       files: Optional[List[str]] = None) -> str:
    """The tokenizer's files of `model_id` in the model directory (fetched
    unless the first is there): ModelScope first, then Hugging Face.
    Returns the directory."""
    from .model_config import default_model_dir
    local_dir = local_dir or os.path.join(default_model_dir(), model_id)
    want = files or UMT5_TOKENIZER_FILES
    if os.path.isfile(os.path.join(local_dir, want[0])):
        return local_dir
    errors = []
    for transport in (modelscope_transport, huggingface_transport):
        try:
            transport(model_id, local_dir, list(want))
            return local_dir
        except Exception as e:  # noqa: BLE001 - the next source
            errors.append(f"{transport.__name__}: {e}")
    raise RuntimeError(f"could not fetch tokenizer {model_id!r}: " + "; ".join(errors))
