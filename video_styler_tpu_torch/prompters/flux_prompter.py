"""Prompt encoding for the FLUX pipeline: the CLIP-L pooled embedding and
the T5 v1.1 sequence embedding.

Counterpart of `video_styler_tpu/prompters/flux_prompter.py`. The CLIP
tokenizer pads to 77 ids, the T5 tokenizer to `t5_sequence_length`; no mask
reaches either tower, and `text_ids` are zeros. A tokenizer is any callable
with the Hugging Face call signature; `transformers` is imported only when a
tokenizer path is given.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from ..models.sd3_text_encoder import ClipTextEncoder, sd3_text_encoder_1_forward
from ..models.t5 import T5Encoder, t5_encode

CLIP_LENGTH = 77


class FluxPrompter:
    def __init__(self, tokenizer_1: Optional[Callable] = None,
                 tokenizer_2: Optional[Callable] = None,
                 clip: Optional[ClipTextEncoder] = None, t5: Optional[T5Encoder] = None):
        self.tokenizer_1 = tokenizer_1      # CLIP (77 ids)
        self.tokenizer_2 = tokenizer_2      # T5
        self.clip = clip
        self.t5 = t5

    def fetch_tokenizers(self, tokenizer_1_path: Optional[str] = None,
                         tokenizer_2_path: Optional[str] = None):
        if tokenizer_1_path:
            from transformers import CLIPTokenizer
            self.tokenizer_1 = CLIPTokenizer.from_pretrained(tokenizer_1_path)
        if tokenizer_2_path:
            from transformers import T5TokenizerFast
            self.tokenizer_2 = T5TokenizerFast.from_pretrained(tokenizer_2_path)

    @staticmethod
    def _ids(tokenizer, prompt: str, max_length: int) -> np.ndarray:
        out = tokenizer([prompt], padding="max_length", max_length=max_length,
                        truncation=True, return_tensors="np")
        return np.asarray(out["input_ids"], np.int64)

    @torch.no_grad()
    def encode_prompt(self, prompt: str, t5_sequence_length: int = 512,
                      dtype=torch.bfloat16, stage: Optional[Callable] = None):
        """-> (prompt_emb (1, L, 4096), pooled (1, 768), text_ids (L, 3)).
        stage(name): a context manager around each tower's encode
        (`clip_encode`, `t5_encode`), as the pipeline times its stages."""
        missing = [name for name in ("tokenizer_1", "tokenizer_2", "clip", "t5")
                   if getattr(self, name) is None]
        if missing:
            raise RuntimeError(f"the FLUX prompter has no {', '.join(missing)}")
        stage = stage or (lambda name: nullcontext())
        with stage("clip_encode"):
            ids1 = self._ids(self.tokenizer_1, prompt, CLIP_LENGTH)
            pooled, _ = sd3_text_encoder_1_forward(
                self.clip, torch.from_numpy(ids1).to(self.clip.position_embeds.device))
        with stage("t5_encode"):
            ids2 = self._ids(self.tokenizer_2, prompt, t5_sequence_length)
            prompt_emb = t5_encode(self.t5,
                                   torch.from_numpy(ids2).to(self.t5.token_embedding.device))
        text_ids = np.zeros((ids2.shape[1], 3), np.float64)
        return prompt_emb.to(dtype), pooled.to(dtype), text_ids


class StubClipTokenizer:
    """Deterministic stand-in for the CLIP tokenizer (smoke runs, tests): the
    start id, one id per word (crc32 into the vocabulary's middle), the end
    id, padding with the end id, as CLIP pads. The end id is the vocabulary's
    largest, so the pooled position is the first end, as with real ids."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, texts, max_length: int = CLIP_LENGTH, **kw):
        import zlib
        bos, eos = self.vocab - 2, self.vocab - 1
        words = [1 + zlib.crc32(w.encode()) % (self.vocab - 3) for w in texts[0].split()]
        ids = [bos] + words[:max_length - 2] + [eos]
        ids += [eos] * (max_length - len(ids))
        return {"input_ids": np.asarray([ids], np.int64)}


class StubT5Tokenizer:
    """Deterministic stand-in for the T5 tokenizer: one id per word (crc32),
    then the end id 1, padding 0."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, texts, max_length: int = 512, **kw):
        import zlib
        words = [2 + zlib.crc32(w.encode()) % (self.vocab - 2) for w in texts[0].split()]
        ids = (words[:max_length - 1] + [1] + [0] * max_length)[:max_length]
        return {"input_ids": np.asarray([ids], np.int64)}
