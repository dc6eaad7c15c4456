"""Multi-provider image-editing API client with retry/backoff.

Counterpart of `video_styler_tpu/agent/image_generation.py` (its own copy;
the reference's src/utils/image_generation.py): one
`image_generation_tool(image, prompt, provider, ...)` entry, providers behind
a registry, exponential-backoff retry, data-URL encoding helpers. Network
providers (gemini/openai/qwen/doubao) are HTTP clients that need egress; the
`mock` provider applies a deterministic local stylization so the whole agent
pipeline runs offline (and in tests).
"""
from __future__ import annotations

import base64
import io
import os
import time
from typing import Callable, Dict, Optional

from PIL import Image, ImageEnhance, ImageFilter, ImageOps


def pil_to_data_url(image: Image.Image, fmt: str = "PNG") -> str:
    buf = io.BytesIO()
    image.save(buf, format=fmt)
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f"data:image/{fmt.lower()};base64,{b64}"


def data_url_to_pil(url: str) -> Image.Image:
    b64 = url.split(",", 1)[1]
    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def retry_with_backoff(fn: Callable, max_retries: int = 3, base_delay: float = 1.0,
                       max_delay: float = 30.0):
    """Exponential backoff (image_generation.py:80-129 behavior): transient
    failures (5xx/429/network) retry; auth/validation (4xx) raise at once
    via the reference's retryability classification."""
    from .providers import is_retryable_error
    last_err = None
    for attempt in range(max_retries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — API clients raise varied errors
            if not is_retryable_error(e):
                raise
            last_err = e
            delay = min(base_delay * (2 ** attempt), max_delay)
            time.sleep(delay)
    raise RuntimeError(f"image generation failed after {max_retries} retries: "
                       f"{last_err}")


# ---------------------------------------------------------------- providers

def _mock_provider(image: Image.Image, prompt: str, **kwargs) -> Image.Image:
    """Deterministic local 'stylization': tint + posterize + edge enhance,
    keyed on the prompt hash so different prompts give different looks."""
    h = sum(ord(c) for c in prompt) % 3
    out = image.convert("RGB")
    if h == 0:
        out = ImageOps.posterize(out, 4)
        out = ImageEnhance.Color(out).enhance(1.6)
    elif h == 1:
        out = out.filter(ImageFilter.EDGE_ENHANCE_MORE)
        out = ImageEnhance.Contrast(out).enhance(1.3)
    else:
        out = ImageOps.autocontrast(out)
        out = ImageEnhance.Brightness(out).enhance(1.1)
    return out


def _real_provider(name: str):
    """Bind a real REST client from agent/providers.py (the Gemini / Qwen /
    Doubao / OpenAI wire formats of reference src/utils/image_generation.py)."""
    def provider(image: Image.Image, prompt: str,
                 target_ratio: Optional[float] = None,
                 model: Optional[str] = None, **kwargs) -> Image.Image:
        from . import providers as P
        fn = {"gemini": P.gemini_edit, "qwen": P.qwen_edit,
              "doubao": P.doubao_edit, "openai": P.openai_edit}[name]
        if target_ratio is None:
            target_ratio = (image.width / image.height) if image is not None \
                else 1.0
        return fn(image, prompt, target_ratio=target_ratio, model=model)
    return provider


PROVIDERS: Dict[str, Callable] = {
    "mock": _mock_provider,
    "gemini": _real_provider("gemini"),
    "openai": _real_provider("openai"),
    "qwen": _real_provider("qwen"),
    "doubao": _real_provider("doubao"),
}


def image_generation_tool(image: Image.Image, prompt: str,
                          provider: str = "mock", max_retries: int = 3,
                          **kwargs) -> Image.Image:
    if provider not in PROVIDERS:
        raise ValueError(f"unknown provider {provider} "
                         f"(available: {', '.join(PROVIDERS)})")
    fn = PROVIDERS[provider]
    return retry_with_backoff(lambda: fn(image, prompt, **kwargs),
                              max_retries=max_retries)
