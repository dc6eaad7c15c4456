"""Omost regional prompting: the LLM's canvas code -> region prompts and masks.

Counterpart of `video_styler_tpu/prompters/omost.py` (host code): the
Omost LLM writes a ```python``` block that builds a `Canvas` (one global
description and located local ones); `Canvas.process` gives the 90x90
colour map, the full-frame prompt, and each region's prompt and binary
mask, nearest components last. `OmostPrompter` is a `prompt_extender` for
the SD and SDXL pipelines (`pipelines.sd_image`, `pipelines.sdxl_image`):
it fills `prompt`, `prompts` (the local prompts) and `masks` (PIL images)
for their masked blending. The LLM is a callable(messages) -> text. The
CSS colour names come from `PIL.ImageColor`, read when first needed.
"""
from __future__ import annotations

import difflib
import re
from functools import lru_cache
from typing import Callable, Optional

import numpy as np

# 90x90 canvas-grid semantics (omost.py:60-93)
VALID_LOCATIONS = {
    "in the center": (45, 45), "on the left": (15, 45),
    "on the right": (75, 45), "on the top": (45, 15),
    "on the bottom": (45, 75), "on the top-left": (15, 15),
    "on the top-right": (75, 15), "on the bottom-left": (15, 75),
    "on the bottom-right": (75, 75),
}
VALID_OFFSETS = {
    "no offset": (0, 0), "slightly to the left": (-10, 0),
    "slightly to the right": (10, 0), "slightly to the upper": (0, -10),
    "slightly to the lower": (0, 10), "slightly to the upper-left": (-10, -10),
    "slightly to the upper-right": (10, -10),
    "slightly to the lower-left": (-10, 10),
    "slightly to the lower-right": (10, 10),
}
VALID_AREAS = {
    "a small square area": (50, 50), "a small vertical area": (40, 60),
    "a small horizontal area": (60, 40),
    "a medium-sized square area": (60, 60),
    "a medium-sized vertical area": (50, 80),
    "a medium-sized horizontal area": (80, 50),
    "a large square area": (70, 70), "a large vertical area": (60, 90),
    "a large horizontal area": (90, 60),
}


@lru_cache(maxsize=1)
def valid_colors() -> dict:
    """CSS3 colour names -> RGB, from PIL."""
    from PIL import ImageColor
    return {name: ImageColor.getrgb(hex_) for name, hex_ in ImageColor.colormap.items()}


def _safe_str(x: str) -> str:
    return x.strip(",. ") + "."


def _closest_name(value: str, options) -> str:
    value = value.lower()
    match = difflib.get_close_matches(value, list(options), n=1, cutoff=0.5)
    if not match:
        raise ValueError(f"The value [{value}] is not valid!")
    return match[0]


class Canvas:
    """The DSL object the Omost LLM's generated code instantiates
    (omost.py:110-231)."""

    @staticmethod
    def from_bot_response(response: str) -> "Canvas":
        matched = re.search(r"```python\n(.*?)\n```", response, re.DOTALL)
        if not matched:
            raise ValueError("Response does not contain a ```python``` block")
        code = matched.group(1)
        if "canvas = Canvas()" not in code:
            raise ValueError("Code block must build a `canvas` variable")
        local_vars = {"Canvas": Canvas}
        exec(code, {"__builtins__": {}}, local_vars)
        canvas = local_vars.get("canvas")
        if not isinstance(canvas, Canvas):
            raise ValueError("Code block must produce a Canvas instance")
        return canvas

    def __init__(self, record_tags: bool = True):
        self.components = []
        self.color = None
        self.record_tags = record_tags
        self.prefixes = []
        self.suffixes = []

    def set_global_description(self, description: str,
                               detailed_descriptions: list, tags: str,
                               HTML_web_color_name: str):
        colors = valid_colors()
        color = _closest_name(HTML_web_color_name, colors)
        self.color = np.array([[colors[color]]], np.uint8)
        self.prefixes = [_safe_str(description)]
        suffixes = list(detailed_descriptions)
        if self.record_tags:
            suffixes = suffixes + [tags]
        self.suffixes = [_safe_str(x) for x in suffixes]

    def add_local_description(self, location: str, offset: str, area: str,
                              distance_to_viewer: float, description: str,
                              detailed_descriptions: list, tags: str,
                              atmosphere: str, style: str, quality_meta: str,
                              HTML_web_color_name: str):
        location = _closest_name(location, VALID_LOCATIONS)
        offset = _closest_name(offset, VALID_OFFSETS)
        area = _closest_name(area, VALID_AREAS)
        colors = valid_colors()
        color_name = _closest_name(HTML_web_color_name, colors)
        xb, yb = VALID_LOCATIONS[location]
        xo, yo = VALID_OFFSETS[offset]
        w, h = VALID_AREAS[area]
        rect = (yb + yo - h // 2, yb + yo + h // 2,
                xb + xo - w // 2, xb + xo + w // 2)
        rect = [max(0, min(90, v)) for v in rect]
        suffixes = list(detailed_descriptions)
        if self.record_tags:
            suffixes = suffixes + [tags, atmosphere, style, quality_meta]
        self.components.append({
            "rect": rect,
            "distance_to_viewer": float(distance_to_viewer),
            "color": np.array([[colors[color_name]]], np.uint8),
            "prefixes": [_safe_str(x) for x in self.prefixes + [description]],
            "suffixes": [_safe_str(x) for x in suffixes],
            "location": location,
        })

    def process(self) -> dict:
        """-> {initial_latent (90,90,3) u8, bag_of_conditions: [{mask,
        prefixes, suffixes, location}]} — far components painted first
        (omost.py:199-231)."""
        components = sorted(self.components,
                            key=lambda c: c["distance_to_viewer"],
                            reverse=True)
        initial = np.zeros((90, 90, 3), np.float32) + self.color
        for c in components:
            a, b, cc, d = c["rect"]
            initial[a:b, cc:d] = 0.7 * c["color"] + 0.3 * initial[a:b, cc:d]
        bag = [{"mask": np.ones((90, 90), np.float32),
                "prefixes": self.prefixes, "suffixes": self.suffixes,
                "location": "full"}]
        for c in components:
            a, b, cc, d = c["rect"]
            m = np.zeros((90, 90), np.float32)
            m[a:b, cc:d] = 1.0
            bag.append({"mask": m, "prefixes": c["prefixes"],
                        "suffixes": c["suffixes"],
                        "location": c["location"]})
        return {"initial_latent": initial.clip(0, 255).astype(np.uint8),
                "bag_of_conditions": bag}


class OmostPrompter:
    """OmostPromter analog (omost.py:235-322): runs the Omost LLM over the
    raw prompt (llm: callable(messages) -> response text, served host-side),
    parses the Canvas block, and expands a prompt dict with the global
    prompt, per-region prompts, and PIL masks for local-prompt blending."""

    DEFAULT_TEMPLATE = (
        "You are a helpful AI assistant to compose images using the below "
        "python class `Canvas`: set_global_description(description, "
        "detailed_descriptions, tags, HTML_web_color_name) and "
        "add_local_description(location, offset, area, distance_to_viewer, "
        "description, detailed_descriptions, tags, atmosphere, style, "
        "quality_meta, HTML_web_color_name)."
    )

    def __init__(self, llm: Optional[Callable] = None, template: str = ""):
        self.llm = llm
        self.template = template or self.DEFAULT_TEMPLATE

    def __call__(self, prompt_dict: dict) -> dict:
        raw_prompt = prompt_dict["prompt"]
        response = self.llm([
            {"role": "system", "content": self.template},
            {"role": "user", "content": raw_prompt},
        ])
        canvas_output = Canvas.from_bot_response(response).process()
        prompts = [" ".join(c["prefixes"] + c["suffixes"][:2])
                   for c in canvas_output["bag_of_conditions"]]
        canvas_output["prompt"] = prompts[0]
        canvas_output["prompts"] = prompts[1:]
        from PIL import Image
        masks = []
        for cond in canvas_output["bag_of_conditions"][1:]:
            m = np.where(cond["mask"] > 0.5, 255, 0).astype(np.uint8)
            masks.append(Image.fromarray(np.stack([m] * 3, axis=-1)))
        canvas_output["masks"] = masks
        prompt_dict.update(canvas_output)
        return prompt_dict
