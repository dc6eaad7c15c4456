"""Prompt encoding for the SD3 pipeline: CLIP-L, CLIP-G (OpenCLIP bigG) and
an optional T5 v1.1-XXL.

Counterpart of `video_styler_tpu/prompters/sd3_prompter.py` (:15-66): each
CLIP tokenizer pads to 77 ids; CLIP-L's and CLIP-G's hidden states (taken
two layers before the end) are concatenated on width and zero-padded to
4096, then T5's `t5_sequence_length` rows follow (zeros when there is no
T5); pooled is CLIP-L's pooled embedding then CLIP-G's projected one. A
tokenizer is any callable with the Hugging Face call signature.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.sd3_text_encoder import ClipTextEncoder, sd3_text_encoder_1_forward
from ..models.sdxl import SDXLTextEncoder2, sdxl_text_encoder_2_forward
from ..models.t5 import T5Encoder, t5_encode
from .flux_prompter import CLIP_LENGTH, FluxPrompter

CONTEXT_DIM = 4096


class SD3Prompter:
    def __init__(self, tokenizer_1: Optional[Callable] = None,
                 tokenizer_2: Optional[Callable] = None,
                 tokenizer_3: Optional[Callable] = None,
                 te1: Optional[ClipTextEncoder] = None, te2: Optional[SDXLTextEncoder2] = None,
                 t5: Optional[T5Encoder] = None):
        self.tokenizer_1 = tokenizer_1      # CLIP-L
        self.tokenizer_2 = tokenizer_2      # CLIP-G
        self.tokenizer_3 = tokenizer_3      # T5 (only with a T5 tower)
        self.te1 = te1
        self.te2 = te2
        self.t5 = t5

    def fetch_tokenizers(self, path_1: Optional[str] = None, path_2: Optional[str] = None,
                         path_3: Optional[str] = None):
        if path_1 or path_2:
            from transformers import CLIPTokenizer
            if path_1:
                self.tokenizer_1 = CLIPTokenizer.from_pretrained(path_1)
            if path_2:
                self.tokenizer_2 = CLIPTokenizer.from_pretrained(path_2)
        if path_3:
            from transformers import T5TokenizerFast
            self.tokenizer_3 = T5TokenizerFast.from_pretrained(path_3)

    @torch.no_grad()
    def encode_prompt(self, prompt: str, t5_sequence_length: int = 77, dtype=torch.bfloat16):
        """-> (prompt_emb (1, 77 + t5_sequence_length, 4096), pooled (1,
        CLIP-L + CLIP-G widths))."""
        needed = ["tokenizer_1", "tokenizer_2", "te1", "te2"]
        if self.t5 is not None:
            needed.append("tokenizer_3")
        missing = [name for name in needed if getattr(self, name) is None]
        if missing:
            raise RuntimeError(f"the SD3 prompter has no {', '.join(missing)}")
        ids = FluxPrompter._ids
        dev = self.te1.position_embeds.device
        pooled_1, emb_1 = sd3_text_encoder_1_forward(
            self.te1, torch.from_numpy(ids(self.tokenizer_1, prompt, CLIP_LENGTH)).to(dev))
        pooled_2, emb_2 = sdxl_text_encoder_2_forward(
            self.te2, torch.from_numpy(ids(self.tokenizer_2, prompt, CLIP_LENGTH)).to(dev))
        clip = torch.cat([emb_1, emb_2], dim=-1)
        clip = torch.nn.functional.pad(clip, (0, CONTEXT_DIM - clip.shape[-1]))
        if self.t5 is None:
            t5 = clip.new_zeros((clip.shape[0], t5_sequence_length, CONTEXT_DIM))
        else:
            t5 = t5_encode(self.t5, torch.from_numpy(
                ids(self.tokenizer_3, prompt, t5_sequence_length)).to(dev))
        prompt_emb = torch.cat([clip, t5.to(clip.dtype)], dim=-2)
        pooled = torch.cat([pooled_1, pooled_2], dim=-1)
        return prompt_emb.to(dtype), pooled.to(dtype)

