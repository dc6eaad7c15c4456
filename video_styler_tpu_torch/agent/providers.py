"""Real image-edit provider clients (Gemini / Qwen / Doubao / OpenAI-Azure).

The reference drives these through vendor SDKs (google-genai, dashscope,
volcenginesdkarkruntime, openai — the reference's src/utils/
image_generation.py:167-632); this is the port's own copy of
`video_styler_tpu/agent/providers.py`. This build speaks the same REST wire formats
those SDKs produce, over stdlib urllib — no SDK dependency — with
env-overridable endpoints so the offline test suite can validate the exact
request/response schemas against canned responses:

  gemini : POST {EP}/v1beta/models/{model}:generateContent   (x-goog-api-key)
           contents=[{parts:[{inline_data:{mime_type,data}},...,{text}]}],
           generationConfig.imageConfig.aspectRatio snapped to the reference
           ratio table (image_generation.py:344-350)
  qwen   : POST {EP}/api/v1/services/aigc/multimodal-generation/generation
           (Authorization: Bearer DASHSCOPE_API_KEY) — the
           MultiModalConversation.call wire shape (image_generation.py:183-195)
  doubao : POST {EP}/api/v3/images/generations (Bearer ARK_IMAGE_API_KEY),
           size snapped to the Ark table (image_generation.py:266-269)
  openai : POST {EP}/images/edits (multipart, input image + prompt) or
           {EP}/images/generations (no image), size snapped to the three
           OpenAI sizes (image_generation.py:464-469); b64_json or url result

All four return a PIL.Image; remote result URLs are downloaded with the same
retry discipline. Retryability classification mirrors the reference's
_is_retryable_error (5xx/429/timeouts retry; 4xx auth/validation do not).
"""
from __future__ import annotations

import base64
import io
import json
import os
import re
import urllib.error
import urllib.request
import uuid
from typing import List, Optional, Tuple

from PIL import Image


# ---------------------------------------------------------------- plumbing

class NonRetryableError(RuntimeError):
    """4xx-class failure: retrying cannot help (auth, validation, 404)."""


def is_retryable_error(err: Exception) -> bool:
    """Reference classification (image_generation.py:36-78): 5xx and 429
    retry, other 4xx don't, network/timeout errors retry."""
    if isinstance(err, NonRetryableError):
        return False
    s = str(err).lower()
    if isinstance(err, urllib.error.HTTPError):
        code = err.code
    else:
        m = re.search(r"status[_\s]*[=:]?\s*(\d{3})", s) or \
            re.search(r"\bhttp\s+(\d{3})\b", s) or \
            re.search(r"\b(\d{3})\b", s)
        code = int(m.group(1)) if m else None
    if code is not None:
        if code >= 500 or code == 429:
            return True
        if 400 <= code < 500:
            return False
    return isinstance(err, (urllib.error.URLError, TimeoutError, OSError))


def _endpoint(env: str, default: str) -> str:
    return os.environ.get(env, default).rstrip("/")


def _post_json(url: str, payload: dict, headers: dict,
               timeout: float = 120.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")[:500]
        err = RuntimeError(f"HTTP {e.code} from {url}: {body}")
        raise err if e.code >= 500 or e.code == 429 else \
            NonRetryableError(str(err))


def _get_bytes(url: str, timeout: float = 30.0) -> bytes:
    with urllib.request.urlopen(
            urllib.request.Request(url), timeout=timeout) as r:
        return r.read()


def _require_key(env: str) -> str:
    key = os.environ.get(env)
    if not key:
        raise NonRetryableError(f"{env} environment variable is not set")
    return key


def image_to_bytes(image: Image.Image, fmt: str = "PNG") -> Tuple[bytes, str]:
    buf = io.BytesIO()
    image.convert("RGB").save(buf, format=fmt)
    return buf.getvalue(), f"image/{fmt.lower()}"


def _bytes_to_image(data: bytes) -> Image.Image:
    return Image.open(io.BytesIO(data)).convert("RGB")


def _image_field_to_image(field: str) -> Image.Image:
    """Decode a data-URL or download an http(s) result URL (the reference's
    two result shapes, image_generation.py:216-242)."""
    if field.startswith("data:"):
        return _bytes_to_image(base64.b64decode(field.split(",", 1)[1]))
    if field.startswith("http"):
        return _bytes_to_image(_get_bytes(field))
    raise RuntimeError(f"unsupported image field format: {field[:40]}")


def snap_ratio(target_ratio: float, table: dict) -> str:
    """Pick the table key whose ratio is closest to target_ratio — the
    reference's min-abs-diff snapping (image_generation.py:268,348)."""
    return min(table, key=lambda k: abs(table[k] - target_ratio))


# ------------------------------------------------------------------ gemini

GEMINI_RATIOS = {"1:1": 1.0, "3:2": 1.5, "2:3": 2 / 3, "3:4": 0.75,
                 "4:3": 4 / 3, "4:5": 0.8, "5:4": 1.25, "9:16": 9 / 16,
                 "16:9": 16 / 9, "21:9": 21 / 9}


def gemini_edit(image: Optional[Image.Image], prompt: str,
                target_ratio: float = 1.0,
                model: Optional[str] = None) -> Image.Image:
    """generateContent with inline image parts + ImageConfig.aspectRatio
    (image_generation.py:319-438)."""
    key = _require_key("GEMINI_API_KEY")
    ep = _endpoint("GEMINI_API_ENDPOINT",
                   "https://generativelanguage.googleapis.com")
    model = model or os.environ.get("GEMINI_IMAGE_MODEL",
                                    "gemini-2.5-flash-image")
    parts: List[dict] = []
    if image is not None:
        data, mime = image_to_bytes(image)
        parts.append({"inline_data": {
            "mime_type": mime, "data": base64.b64encode(data).decode()}})
    if prompt:
        parts.append({"text": prompt})
    payload = {
        "contents": [{"parts": parts}],
        "generationConfig": {
            "candidateCount": 1,
            "temperature": float(os.environ.get("IMAGE_GEN_TEMPERATURE",
                                                "0.7")),
            "imageConfig": {
                "aspectRatio": snap_ratio(target_ratio, GEMINI_RATIOS)},
        },
    }
    resp = _post_json(f"{ep}/v1beta/models/{model}:generateContent", payload,
                      {"x-goog-api-key": key})
    cands = resp.get("candidates") or []
    if not cands or cands[0].get("finishReason", "STOP") != "STOP":
        reason = cands[0].get("finishReason") if cands else "No candidates"
        raise RuntimeError(f"Gemini image generation failed: {reason}")
    for part in cands[0].get("content", {}).get("parts", []):
        inline = part.get("inlineData") or part.get("inline_data")
        if inline and inline.get("data"):
            return _bytes_to_image(base64.b64decode(inline["data"]))
    raise RuntimeError("No image data found in Gemini response")


# -------------------------------------------------------------------- qwen

def qwen_edit(image: Optional[Image.Image], prompt: str,
              target_ratio: float = 1.0,
              model: Optional[str] = None) -> Image.Image:
    """DashScope multimodal-generation wire format — messages of
    {image}/{text} content items, watermark off, blank negative prompt
    (image_generation.py:183-195)."""
    key = _require_key("DASHSCOPE_API_KEY")
    ep = _endpoint("DASHSCOPE_API_ENDPOINT", "https://dashscope.aliyuncs.com")
    content: List[dict] = []
    if image is not None:
        data, mime = image_to_bytes(image)
        content.append({"image": f"data:{mime};base64,"
                                 f"{base64.b64encode(data).decode()}"})
    content.append({"text": prompt})
    payload = {
        "model": model or "qwen-image-edit",
        "input": {"messages": [{"role": "user", "content": content}]},
        "parameters": {"watermark": False, "negative_prompt": " "},
    }
    resp = _post_json(
        f"{ep}/api/v1/services/aigc/multimodal-generation/generation",
        payload, {"Authorization": f"Bearer {key}"})
    try:
        items = resp["output"]["choices"][0]["message"]["content"]
    except (KeyError, IndexError, TypeError):
        raise RuntimeError(f"QWEN response missing output.choices: "
                           f"{str(resp)[:200]}")
    for item in items:
        if isinstance(item, dict) and item.get("image"):
            return _image_field_to_image(item["image"])
    raise RuntimeError("QWEN response did not contain an image field")


# ------------------------------------------------------------------ doubao

# Ark size table (image_generation.py:266-267)
DOUBAO_SIZES = {"1:1": "2048x2048", "4:3": "2304x1728", "3:4": "1728x2304",
                "16:9": "2560x1440", "9:16": "1440x2560", "3:2": "2496x1664",
                "2:3": "1664x2496", "21:9": "3024x1296"}
DOUBAO_RATIOS = {k: int(v.split("x")[0]) / int(v.split("x")[1])
                 for k, v in DOUBAO_SIZES.items()}


def doubao_edit(image: Optional[Image.Image], prompt: str,
                target_ratio: float = 1.0,
                model: Optional[str] = None) -> Image.Image:
    """Volcengine Ark images/generations wire format
    (image_generation.py:244-317)."""
    key = _require_key("ARK_IMAGE_API_KEY")
    ep = _endpoint("ARK_API_ENDPOINT", "https://ark.cn-beijing.volces.com")
    payload = {
        "model": model or "doubao-seedream-4-0-250828",
        "prompt": prompt,
        "size": DOUBAO_SIZES[snap_ratio(target_ratio, DOUBAO_RATIOS)],
        "sequential_image_generation": "disabled",
        "response_format": "url",
        "watermark": False,
    }
    if image is not None:
        data, mime = image_to_bytes(image)
        payload["image"] = [f"data:{mime};base64,"
                            f"{base64.b64encode(data).decode()}"]
    resp = _post_json(f"{ep}/api/v3/images/generations", payload,
                      {"Authorization": f"Bearer {key}"})
    data0 = (resp.get("data") or [{}])[0]
    if data0.get("url"):
        return _bytes_to_image(_get_bytes(data0["url"]))
    b64 = data0.get("b64_json") or data0.get("b64") or data0.get("base64")
    if b64:
        return _bytes_to_image(base64.b64decode(b64))
    raise RuntimeError("Could not find generated image in Ark response")


# ------------------------------------------------------------------ openai

OPENAI_SIZES = {"1024x1024": 1.0, "1024x1536": 1024 / 1536,
                "1536x1024": 1536 / 1024}
# the reference appends this structure-preservation suffix to edit prompts
# (image_generation.py:553)
OPENAI_EDIT_SUFFIX = ("keep the image to be edited's content/structure/"
                      "position/oritention.")


def _multipart(fields: dict, files: List[Tuple[str, str, bytes, str]]
               ) -> Tuple[bytes, str]:
    """Encode multipart/form-data (OpenAI images.edit takes file uploads;
    the SDK does this under the hood)."""
    boundary = uuid.uuid4().hex
    out = io.BytesIO()
    for name, value in fields.items():
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"{name}\"\r\n\r\n{value}\r\n".encode())
    for name, filename, data, mime in files:
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"{name}\"; filename=\"{filename}\"\r\n"
                  f"Content-Type: {mime}\r\n\r\n".encode())
        out.write(data)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


def openai_edit(image: Optional[Image.Image], prompt: str,
                target_ratio: float = 1.0,
                model: Optional[str] = None) -> Image.Image:
    """images/edits (multipart, with input image) or images/generations
    (JSON, text-only) — the reference's Azure-OpenAI path
    (image_generation.py:439-632)."""
    key = _require_key("AZURE_API_KEY")
    ep = _endpoint("AZURE_ENDPOINT",
                   "https://api.openai.com/v1")
    deployment = model or os.environ.get("AZURE_DEPLOYMENT", "gpt-image-1")
    size = snap_ratio(target_ratio, OPENAI_SIZES)
    if image is None:
        resp = _post_json(f"{ep}/images/generations",
                          {"model": deployment, "prompt": prompt, "n": 1,
                           "size": size},
                          {"Authorization": f"Bearer {key}"})
    else:
        data, mime = image_to_bytes(image)
        body, ctype = _multipart(
            {"model": deployment,
             "prompt": prompt + OPENAI_EDIT_SUFFIX,
             "n": "1", "size": size, "input_fidelity": "high"},
            [("image", "image.png", data, mime)])
        req = urllib.request.Request(
            f"{ep}/images/edits", data=body,
            headers={"Content-Type": ctype,
                     "Authorization": f"Bearer {key}"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                resp = json.loads(r.read())
        except urllib.error.HTTPError as e:
            bodytxt = e.read().decode(errors="replace")[:500]
            err = RuntimeError(f"HTTP {e.code} from images/edits: {bodytxt}")
            raise err if e.code >= 500 or e.code == 429 else \
                NonRetryableError(str(err))
    items = resp.get("data") or []
    if not items:
        raise RuntimeError("OpenAI/Azure response did not contain data array")
    item = items[0]
    if item.get("b64_json"):
        return _bytes_to_image(base64.b64decode(item["b64_json"]))
    if item.get("url"):
        return _bytes_to_image(_get_bytes(item["url"]))
    raise RuntimeError(
        "OpenAI/Azure response did not contain image data (b64_json or url)")
