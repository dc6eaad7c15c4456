"""Prompt encoding for the Wan pipeline.

Counterpart of `video_styler_tpu/prompters/wan_prompter.py`: clean the
prompt, tokenize to `text_len` with padding, run the umT5 encoder, and zero
the embeddings past the sequence length. The tokenizer is any callable with
the Hugging Face call signature; `transformers` (and `ftfy`, for cleaning)
are imported only when a tokenizer path is given or a prompt is cleaned.
"""
from __future__ import annotations

import html
import re
from typing import Callable, Optional

import numpy as np
import torch

from ..models.t5 import T5Encoder, t5_encode


def basic_clean(text: str) -> str:
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class StubTokenizer:
    """Deterministic stand-in for the umT5 tokenizer when no tokenizer files
    are at hand (smoke runs, tests): n words -> ids 1..n+1, padded to
    `text_len`."""

    def __init__(self, text_len: int):
        self.text_len = text_len

    def __call__(self, texts, **kw):
        n = min(len(texts[0].split()) + 1, self.text_len)
        ids = np.zeros((1, self.text_len), np.int64)
        ids[0, :n] = np.arange(1, n + 1)
        mask = np.zeros((1, self.text_len), np.int64)
        mask[0, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}


class WanPrompter:
    """Tokenize and encode prompts with a `T5Encoder`."""

    def __init__(self, tokenizer: Optional[Callable] = None,
                 text_len: int = 512,
                 text_encoder: Optional[T5Encoder] = None):
        self.tokenizer = tokenizer
        self.text_len = text_len
        self.text_encoder = text_encoder

    def fetch_tokenizer(self, tokenizer_path: str):
        from transformers import AutoTokenizer
        self.tokenizer = AutoTokenizer.from_pretrained(tokenizer_path)

    def tokenize(self, prompt: str):
        cleaned = whitespace_clean(basic_clean(prompt))
        enc = self.tokenizer([cleaned], padding="max_length", truncation=True,
                             max_length=self.text_len, return_tensors="np")
        return (np.asarray(enc["input_ids"]).astype(np.int32),
                np.asarray(enc["attention_mask"]).astype(np.int32))

    @torch.no_grad()
    def encode_prompt(self, prompt: str, dtype=torch.bfloat16) -> torch.Tensor:
        """-> (1, text_len, dim) embeddings, zeroed past the sequence length."""
        if self.tokenizer is None or self.text_encoder is None:
            raise RuntimeError("prompter needs a tokenizer and a text encoder")
        ids, mask = self.tokenize(prompt)
        dev = self.text_encoder.token_embedding.device
        emb = t5_encode(self.text_encoder, torch.from_numpy(ids).to(dev),
                        torch.from_numpy(mask).to(dev))
        seq_len = int(mask.sum())
        keep = (torch.arange(self.text_len, device=dev) < seq_len)[None, :, None]
        return (emb * keep).to(dtype)
