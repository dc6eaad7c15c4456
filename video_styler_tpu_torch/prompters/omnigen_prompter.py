"""The OmniGen prompter: a multimodal prompt -> ids, masks and positions.

Counterpart of `video_styler_tpu/prompters/omnigen_prompter.py` (host
code): the instruction template, the `<|image_k|>` placeholders replaced by
runs of h * w / 256 ids for the reference images' patches, the mask
(causal over [text | time], open for the image tokens and within each
reference image's run) and the position ids, one sample a CFG branch
(cond, uncond on `NEGATIVE_PROMPT`, and with reference images the
image-only branch). `crop_arr_size` gives a reference image's size.

The tokenizer is a callable returning an object with `input_ids` (Phi-3's
through `fetch_tokenizer`, which imports `transformers` when called;
`StubPhi3Tokenizer` stands in for it on random weights).
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

NEGATIVE_PROMPT = (
    "low quality, jpeg artifacts, ugly, duplicate, morbid, mutilated, extra "
    "fingers, mutated hands, poorly drawn hands, poorly drawn face, "
    "mutation, deformed, blurry, dehydrated, bad anatomy, bad proportions, "
    "extra limbs, cloned face, disfigured, gross proportions, malformed "
    "limbs, missing arms, missing legs, extra arms, extra legs, fused "
    "fingers, too many fingers.")


def crop_arr_size(width: int, height: int, max_image_size: int = 1024):
    """Target size from the reference crop_arr (omnigen_prompter.py:14-41)."""
    w, h = width, height
    while min(w, h) >= 2 * max_image_size:
        w, h = w // 2, h // 2
    if max(w, h) > max_image_size:
        scale = max_image_size / max(w, h)
        w, h = round(w * scale), round(h * scale)
    if min(w, h) < 16:
        scale = 16 / min(w, h)
        w, h = round(w * scale), round(h * scale)
    return w - w % 16, h - h % 16


class OmniGenPrompter:

    def __init__(self, tokenizer=None, max_image_size: int = 1024):
        self.tokenizer = tokenizer
        self.max_image_size = max_image_size

    def fetch_tokenizer(self, path: str):
        from transformers import AutoTokenizer
        self.tokenizer = AutoTokenizer.from_pretrained(path)

    @staticmethod
    def add_prefix_instruction(prompt: str) -> str:
        return ("<|user|>\nGenerate an image according to the following "
                f"instructions\n{prompt}<|end|>\n<|assistant|>\n<|diffusion|>")

    def process_multi_modal_prompt(self, text: str,
                                   image_sizes_hw: List) -> Dict:
        """image_sizes_hw: (h, w) pixel sizes of the (already-cropped)
        reference images, in <|image_k|> id order."""
        text = self.add_prefix_instruction(text)
        if not image_sizes_hw:
            ids = self.tokenizer(text).input_ids
            return {"input_ids": ids, "image_sizes": []}
        pattern = r"<\|image_\d+\|>"
        chunks = [self.tokenizer(c).input_ids for c in re.split(pattern, text)]
        for i in range(1, len(chunks)):
            if chunks[i] and chunks[i][0] == 1:
                chunks[i] = chunks[i][1:]
        tags = re.findall(pattern, text)
        image_ids = [int(s.split("|")[1].split("_")[-1]) for s in tags]
        ordered = [image_sizes_hw[x - 1] for x in image_ids]
        all_ids, img_inx = [], []
        for i, c in enumerate(chunks):
            all_ids.extend(c)
            if i != len(chunks) - 1:
                start = len(all_ids)
                size = ordered[i][0] * ordered[i][1] // 256
                img_inx.append([start, start + size])
                all_ids.extend([0] * size)
        return {"input_ids": all_ids, "image_sizes": img_inx}

    @staticmethod
    def create_position(text_len: int, img_tokens: int) -> np.ndarray:
        return np.arange(text_len + img_tokens + 1, dtype=np.int64)[None]

    @staticmethod
    def create_mask(text_len: int, img_tokens: int) -> np.ndarray:
        """(1, S, S): causal over [text|time], full rows for image tokens."""
        s = text_len + img_tokens + 1
        m = np.zeros((s, s), np.int64)
        m[:text_len + 1, :text_len + 1] = np.tril(
            np.ones((text_len + 1, text_len + 1), np.int64))
        m[text_len + 1:] = 1
        return m[None]

    @staticmethod
    def adjust_mask_for_input_images(mask: np.ndarray,
                                     image_sizes: List) -> np.ndarray:
        for start, end in image_sizes:
            mask[0, start:end, start:end] = 1
        return mask

    def __call__(self, prompt: str, reference_image_sizes_hw: List,
                 height: int, width: int, use_img_cfg: bool = True) -> List[Dict]:
        """-> list of per-branch dicts [cond, uncond(, img_cond)] with
        input_ids / image_sizes / attention_mask / position_ids."""
        img_tokens = height * width // 256
        branches = [self.process_multi_modal_prompt(prompt,
                                                    reference_image_sizes_hw)]
        branches.append(self.process_multi_modal_prompt(NEGATIVE_PROMPT, []))
        if use_img_cfg and reference_image_sizes_hw:
            tags = " ".join(f"<img><|image_{i+1}|></img>"
                            for i in range(len(reference_image_sizes_hw)))
            branches.append(self.process_multi_modal_prompt(
                tags, reference_image_sizes_hw))
        out = []
        for b in branches:
            text_len = len(b["input_ids"])
            mask = self.create_mask(text_len, img_tokens)
            mask = self.adjust_mask_for_input_images(mask, b["image_sizes"])
            out.append({
                "input_ids": np.asarray(b["input_ids"], np.int64)[None],
                "image_sizes": {0: b["image_sizes"]} if b["image_sizes"]
                else {},
                "attention_mask": mask,
                "position_ids": self.create_position(text_len, img_tokens),
            })
        return out



class StubPhi3Tokenizer:
    """Deterministic stand-in for the Phi-3 tokenizer: BOS 1, then one id
    per special tag, word or punctuation mark (crc32 into the vocabulary)."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, text: str):
        import types
        import zlib
        pieces = re.findall(r"<\|[^|]+\|>|\w+|[^\w\s]", text)
        ids = [1] + [2 + zlib.crc32(t.encode()) % (self.vocab - 2) for t in pieces]
        return types.SimpleNamespace(input_ids=ids)
