"""Qwen2.5-VL multimodal embedder (text and vision) in PyTorch.

Counterpart of `video_styler_tpu/models/qwen_vl_embedder.py`: `QwenVL`
runs the text tower (`llm_decoder`) under the multimodal RoPE, with the
vision tower's (`qwen_vl_vision`) merged tokens written over the image-pad
tokens' embeddings; `QwenVLStep1xEmbedder` is FLUX Step1x's conditioning
embedder on it. The tokenizer is the caller's (an HF tokenizer or any
callable with its `__call__`); `StubQwenTokenizer` stands in for it in the
smoke runs and tests.

Where the port departs from JAX: `encode_ids` runs the sequence at its own
length (JAX pads it to a multiple of 32 under a key mask to bucket its jit
shapes; the real rows are the same).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .llm_decoder import (DecoderLM, DecoderLMConfig, convert_decoder_lm,
                          decoder_lm_forward, detect_decoder_lm_config, init_decoder_lm_,
                          init_linears_)
from .qwen_vl_vision import (IMAGE_TOKEN_ID, VIDEO_TOKEN_ID, QwenVLVision,
                             QwenVLVisionConfig, convert_qwen_vl_vision,
                             detect_vision_config, get_rope_index,
                             preprocess_image, vision_forward, vision_plan)

MROPE_SECTION = (16, 24, 24)   # Qwen2.5-VL-7B
VISION_END_TOKEN_ID = 151653

# the Qwen2.5-VL chat template of one user turn with the generation prompt
# and the default system prompt
CHAT_PREFIX = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
               "<|im_start|>user\n")
CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"
IMG_BLOCK = "<|vision_start|><|image_pad|><|vision_end|>"

# Step1x's prompt-enhancement prefix
STEP1X_PREFIX = '''Given a user prompt, generate an "Enhanced prompt" that provides detailed visual descriptions suitable for image generation. Evaluate the level of detail in the user prompt:
- If the prompt is simple, focus on adding specifics about colors, shapes, sizes, textures, and spatial relationships to create vivid and concrete scenes.
- If the prompt is already detailed, refine and enhance the existing details slightly without overcomplicating.\n
Here are examples of how to transform or refine prompts:
- User Prompt: A cat sleeping -> Enhanced: A small, fluffy white cat curled up in a round shape, sleeping peacefully on a warm sunny windowsill, surrounded by pots of blooming red flowers.
- User Prompt: A busy city street -> Enhanced: A bustling city street scene at dusk, featuring glowing street lamps, a diverse crowd of people in colorful clothing, and a double-decker bus passing by towering glass skyscrapers.\n
Please generate only the enhanced description for the prompt below and avoid including any additional commentary or evaluations:
User Prompt:'''

# Qwen2.5's special tokens and their ids
SPECIAL_TOKENS = {"<|im_start|>": 151644, "<|im_end|>": 151645,
                  "<|vision_start|>": 151652, "<|vision_end|>": 151653,
                  "<|image_pad|>": IMAGE_TOKEN_ID, "<|video_pad|>": VIDEO_TOKEN_ID}


class StubQwenTokenizer:
    """Deterministic stand-in for the Qwen2.5 tokenizer (smoke runs, tests):
    each special token to its id, each word (with its leading space), each
    punctuation mark and each newline to one id (crc32 into the vocabulary
    below the special tokens). Where the vocabulary is smaller than Qwen's,
    the special tokens take its top ids (`special_ids`)."""

    _PIECE = re.compile(r"\s?\w+|[^\w\s]|\n|\s+")

    def __init__(self, vocab: int):
        self.vocab = vocab
        if vocab > max(SPECIAL_TOKENS.values()):
            self.special_ids = dict(SPECIAL_TOKENS)
        else:
            self.special_ids = {t: vocab - 1 - i for i, t in enumerate(SPECIAL_TOKENS)}
        self.n_words = min(self.special_ids.values())
        self._split = re.compile("(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")

    def encode(self, text: str) -> List[int]:
        import zlib
        ids = []
        for part in self._split.split(text):
            if part in self.special_ids:
                ids.append(self.special_ids[part])
            elif part:
                ids += [zlib.crc32(p.encode()) % self.n_words
                        for p in self._PIECE.findall(part) if p.strip() or p == "\n"]
        return ids

    def __call__(self, text, max_length: Optional[int] = None, return_tensors=None, **kw):
        texts = [text] if isinstance(text, str) else list(text)
        rows = [self.encode(t)[:max_length] for t in texts]
        width = max(len(r) for r in rows)
        ids = np.zeros((len(rows), width), np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class QwenVL:
    """Text (and images) -> the text tower's last hidden states.

    `text`: a `DecoderLM`; `vision`: a `QwenVLVision` or None (text only).
    `from_state_dict` builds both from one Qwen2.5-VL checkpoint (the
    `visual.` / `model.` split of the HF layout)."""

    def __init__(self, text: DecoderLM, vision: Optional[QwenVLVision], tokenizer,
                 mrope_section=None, image_token_id: int = IMAGE_TOKEN_ID,
                 video_token_id: int = VIDEO_TOKEN_ID,
                 vision_end_token_id: int = VISION_END_TOKEN_ID,
                 min_pixels: int = 56 * 56, max_pixels: int = 28 * 28 * 1280):
        self.text, self.vision = text, vision
        self.text_cfg: DecoderLMConfig = text.cfg
        self.vision_cfg: Optional[QwenVLVisionConfig] = None if vision is None else vision.cfg
        self.tokenizer = tokenizer
        self.mrope_section = tuple(mrope_section or MROPE_SECTION)
        self.image_token_id = image_token_id
        self.video_token_id = video_token_id
        self.vision_end_token_id = vision_end_token_id
        # the HF Qwen2VLImageProcessor's class defaults
        self.min_pixels, self.max_pixels = min_pixels, max_pixels

    @property
    def device(self) -> torch.device:
        return self.text.embed.device

    @classmethod
    def from_state_dict(cls, state_dict: Dict, tokenizer, device=None,
                        dtype=torch.bfloat16, text_cfg=None, vision_cfg=None,
                        **kwargs) -> "QwenVL":
        """Both towers from an HF Qwen2.5-VL state dict (tensors or lazy
        checkpoint tensors), read onto `device` in `dtype`."""
        from ..utils.ckpt import build_module
        dev = resolve_device(device)
        text_sd = {k: v for k, v in state_dict.items() if "visual" not in k}
        text_cfg = text_cfg or detect_decoder_lm_config(text_sd, family="qwen")
        text = build_module(DecoderLM, text_cfg, convert_decoder_lm(text_sd, text_cfg), dev,
                            dtype)
        vision = None
        if any(k.startswith(("visual.", "model.visual.")) for k in state_dict):
            vsd = {k[len("model."):] if k.startswith("model.visual.") else k: v
                   for k, v in state_dict.items() if "visual" in k}
            vision_cfg = vision_cfg or detect_vision_config(vsd)
            vision = build_module(QwenVLVision, vision_cfg,
                                  convert_qwen_vl_vision(vsd, vision_cfg), dev, dtype)
        return cls(text, vision, tokenizer, **kwargs)

    @classmethod
    def from_files(cls, paths, tokenizer, device=None, dtype=torch.bfloat16) -> "QwenVL":
        """Both towers from a checkpoint (a file or list of shards, HF names;
        the vision tower where it has `visual.*` weights), with `tokenizer` a
        callable or a tokenizer directory (read through `transformers`)."""
        from ..utils.ckpt import load_state_dict_files
        if isinstance(tokenizer, str):
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(tokenizer)
        sd = load_state_dict_files(paths if isinstance(paths, list) else [paths], lazy=True)
        return cls.from_state_dict(sd, tokenizer, device=device, dtype=dtype)

    @classmethod
    def from_configs(cls, text_cfg: DecoderLMConfig, vision_cfg: Optional[QwenVLVisionConfig],
                     tokenizer, seed: int = 0, device=None, dtype=torch.bfloat16,
                     **kwargs) -> "QwenVL":
        """Random towers drawn on the device from one seeded generator."""
        dev = resolve_device(device)
        gen = torch.Generator(dev).manual_seed(seed)
        with torch.device("meta"):
            text = DecoderLM(text_cfg, dtype=dtype)
            vision = None if vision_cfg is None else QwenVLVision(vision_cfg, dtype=dtype)
        text = init_decoder_lm_(text.to_empty(device=dev), gen).eval()
        if vision is not None:
            vision = init_linears_(vision.to_empty(device=dev), gen).eval()
        return cls(text, vision, tokenizer, **kwargs)

    # ------------------------------------------------------------- helpers

    def _expand_image_pads(self, text: str, grids) -> str:
        """Each <|image_pad|> -> as many as the image's merged tokens (the HF
        processor's expansion)."""
        out, rest = [], text
        for (t, h, w) in grids:
            n = t * h * w // (self.vision_cfg.merge ** 2)
            head, _, rest = rest.partition("<|image_pad|>")
            out.append(head + "<|image_pad|>" * n)
        return "".join(out) + rest

    @torch.no_grad()
    def embed_images(self, images: Sequence, min_pixels=None, max_pixels=None):
        """-> (vision embeds (sum n_i, hidden), grids)."""
        pats, grids = [], []
        for im in images:
            p, g = preprocess_image(im, self.vision_cfg, min_pixels or self.min_pixels,
                                    max_pixels or self.max_pixels)
            pats.append(p)
            grids.append(g)
        patches = torch.from_numpy(np.concatenate(pats, 0)).to(self.device,
                                                               self.text.embed.dtype)
        return vision_forward(self.vision, patches, vision_plan(grids, self.vision_cfg)), grids

    @torch.no_grad()
    def encode_ids(self, ids, img_emb=None, grids=()):
        """ids (L,) with the image-pad runs already expanded -> hidden (1, L,
        hidden) float32 on the device."""
        ids = np.asarray(ids, np.int64)
        pos = get_rope_index(
            ids, list(grids), merge=(self.vision_cfg.merge if grids else 2),
            tokens_per_second=(self.vision_cfg.tokens_per_second if grids else 2),
            image_token_id=self.image_token_id, video_token_id=self.video_token_id)
        ids_t = torch.from_numpy(ids).to(self.device)[None]
        embeds = self.text.embed[ids_t]
        if img_emb is not None:
            positions = torch.from_numpy(np.where(ids == self.image_token_id)[0]).to(self.device)
            embeds[0, positions] = img_emb.to(embeds.dtype)
        hidden = decoder_lm_forward(self.text, ids_t, inputs_embeds=embeds, position_ids=pos,
                                    mrope_section=self.mrope_section)
        return hidden.float()

    def encode(self, text: str, images: Optional[Sequence] = None, min_pixels=None,
               max_pixels=None):
        """-> (hidden (1, L, hidden) float32, input ids (L,)); `text` holds one
        <|vision_start|><|image_pad|><|vision_end|> block per image."""
        grids, img_emb = [], None
        if images:
            img_emb, grids = self.embed_images(images, min_pixels, max_pixels)
            text = self._expand_image_pads(text, grids)
        ids = np.asarray(self.tokenizer(text, return_tensors="np")["input_ids"][0], np.int64)
        return self.encode_ids(ids, img_emb, grids), ids


def _split_string(s: str):
    """Step1x's splitting: after character 155, each character of a
    double-quoted span becomes its own quoted piece (forcing their
    character-level tokenisation)."""
    s = s.replace("“", '"').replace("”", '"').replace("'", '"')
    result, in_quotes, temp = [], False, ""
    for idx, char in enumerate(s):
        if char == '"' and idx > 155:
            temp += char
            if not in_quotes:
                result.append(temp)
                temp = ""
            in_quotes = not in_quotes
            continue
        if in_quotes:
            result.append("“" + char + "”")
        else:
            temp += char
    if temp:
        result.append(temp)
    return result


class QwenVLStep1xEmbedder:
    """callable(captions, ref_images) -> (embs (B, 640, hidden) float32,
    masks (B, 640) int64), host numpy: FLUX Step1x's conditioning: the chat
    template with the enhancement prefix, the image and the caption, the
    quoted characters re-tokenised and spliced in after <|vision_end|>,
    then hidden[0, 217:][:640]."""

    def __init__(self, vl: QwenVL, max_length: int = 640):
        self.vl = vl
        self.max_length = max_length

    def __call__(self, captions: List[str], ref_images: List):
        hid = self.vl.text_cfg.hidden
        embs = np.zeros((len(captions), self.max_length, hid), np.float32)
        masks = np.zeros((len(captions), self.max_length), np.int64)
        tok = self.vl.tokenizer
        for i, (txt, img) in enumerate(zip(captions, ref_images)):
            text = (CHAT_PREFIX + STEP1X_PREFIX + "Picture 1: " + IMG_BLOCK + txt
                    + CHAT_SUFFIX)
            img_emb, grids = self.vl.embed_images([img], min_pixels=256 * 28 * 28,
                                                  max_pixels=324 * 28 * 28)
            old_ids = tok(self.vl._expand_image_pads(text, grids),
                          return_tensors="np")["input_ids"][0]
            toks = []
            for piece in _split_string(text):
                t = tok(piece, return_tensors="np")["input_ids"][0]
                # the “ ” wrapper's tokens (ids 2073 and 854) come off
                if len(t) >= 2 and t[0] == 2073 and t[-1] == 854:
                    t = t[1:-1]
                toks.append(t)
            new_ids = np.concatenate(toks)
            ve = self.vl.vision_end_token_id
            ve_old = int(np.where(old_ids == ve)[0][0])
            ve_new = int(np.where(new_ids == ve)[0][0])
            ids = np.concatenate([old_ids[:ve_old], new_ids[ve_new:]])
            emb = self.vl.encode_ids(ids, img_emb, grids)[0, 217:][:self.max_length]
            embs[i, :emb.shape[0]] = emb.cpu().numpy()
            masks[i, :emb.shape[0]] = 1
        return embs, masks
