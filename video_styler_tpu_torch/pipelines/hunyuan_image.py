"""HunyuanDiT text-to-image (and image-to-image) in PyTorch.

Counterpart of `video_styler_tpu/pipelines/hunyuan_image.py`
(`HunyuanImagePipeline.__call__` :95-178): the enhanced DDIM scheduler with
v-prediction (betas 0.00085..0.03), the Chinese CLIP-BERT over 77 tokens and
mT5-XL over 256 tokens, each with its padding mask, the size condition
[w, h, w, h, 0, 0], two-pass CFG on the negative prompt, the DDIM update in
fp32 and the SDXL VAE (fp32, the SD scaling, as the JAX pipeline decodes).
Image-to-image encodes `input_image` and noises it to the first timestep.

A tokenizer is a callable with the Hugging Face call signature returning
`input_ids` and `attention_mask` (`StubBertTokenizer` and
`StubMT5Tokenizer` stand in for them on random weights) or a tokenizer
directory (read through `transformers`, imported when called). The VAE file
holds the encoder's and decoder's state dicts under `encoder.` and
`decoder.`: the JAX `from_pretrained` hands one state dict to both its
encoder and its decoder.

Runs on `cuda` unless constructed with `device="cpu"`; each stage's wall
time is kept in `stage_times` and, on the card, the running peak in
`stage_peak_bytes`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import hunyuan_image_dit as H
from ..models import sd as SD
from ..models.t5 import MT5_XL, T5Config, T5Encoder, convert_hf_t5, init_t5_, t5_encode
from ..schedulers.ddim import EnhancedDDIMScheduler
from ..utils import ckpt as C
from .flux_image import FluxImagePipeline
from .wan_video import _image_array, _preprocess_images, generate_noise


class StubBertTokenizer:
    """Deterministic stand-in for the BERT tokenizer: [CLS], one id per
    word (crc32), [SEP], padding 0, and the attention mask."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, texts, max_length: int = 77, **kw):
        import zlib
        text = texts[0] if isinstance(texts, (list, tuple)) else texts
        words = [3 + zlib.crc32(w.encode()) % (self.vocab - 3) for w in text.split()]
        ids = [1] + words[:max_length - 2] + [2]
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        ids += [0] * (max_length - len(ids))
        return {"input_ids": np.asarray([ids], np.int64),
                "attention_mask": np.asarray([mask], np.int64)}


class StubMT5Tokenizer:
    """Deterministic stand-in for the mT5 tokenizer: one id per word
    (crc32), the end id 1, padding 0, and the attention mask."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, texts, max_length: int = 256, **kw):
        import zlib
        text = texts[0] if isinstance(texts, (list, tuple)) else texts
        words = [2 + zlib.crc32(w.encode()) % (self.vocab - 2) for w in text.split()]
        ids = words[:max_length - 1] + [1]
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        ids += [0] * (max_length - len(ids))
        return {"input_ids": np.asarray([ids], np.int64),
                "attention_mask": np.asarray([mask], np.int64)}


def split_vae_file(sd):
    """A VAE file's `encoder.` and `decoder.` state dicts."""
    return tuple({k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
                 for p in ("encoder.", "decoder."))


class HunyuanImagePipeline:

    _stage = FluxImagePipeline._stage
    vae_output_to_image = staticmethod(FluxImagePipeline.vae_output_to_image)

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = EnhancedDDIMScheduler(prediction_type="v_prediction",
                                               beta_start=0.00085, beta_end=0.03)
        self.dit: Optional[H.HunyuanImageDiT] = None
        self.dit_cfg: H.HunyuanImageDiTConfig = H.HUNYUAN_DIT
        self.vae_encoder: Optional[SD.SDVAEEncoder] = None
        self.vae_decoder: Optional[SD.SDVAEDecoder] = None
        self.bert: Optional[H.HunyuanBert] = None
        self.t5: Optional[T5Encoder] = None
        self.tokenizer: Optional[Callable] = None
        self.tokenizer_t5: Optional[Callable] = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, dit_cfg: H.HunyuanImageDiTConfig, bert_cfg: H.HunyuanBertConfig,
                     t5_cfg: T5Config, tokenizer: Callable, tokenizer_t5: Callable,
                     seed: int = 0, device=None, dtype=torch.bfloat16,
                     vae: bool = True) -> "HunyuanImagePipeline":
        """Random weights drawn on the device from one seeded generator: the
        DiT, the BERT and mT5 in `dtype`, the SDXL VAE in fp32 (not with
        vae=False)."""
        pipe = cls(device=device, dtype=dtype)
        pipe.dit_cfg = dit_cfg
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)

        def draw(module, init):
            return init(module.to_empty(device=dev), gen).eval()

        with torch.device("meta"):
            dit = H.HunyuanImageDiT(dit_cfg, dtype=dtype)
            bert = H.HunyuanBert(bert_cfg, dtype=dtype)
            t5 = T5Encoder(t5_cfg, dtype=dtype)
            enc = SD.SDVAEEncoder(dtype=torch.float32)
            dec = SD.SDVAEDecoder(dtype=torch.float32)
        pipe.dit = draw(dit, H.init_hunyuan_image_dit_)
        pipe.bert = draw(bert, H.init_hunyuan_image_dit_)
        pipe.t5 = draw(t5, init_t5_)
        if vae:
            pipe.vae_encoder = draw(enc, SD.init_sd_module_)
            pipe.vae_decoder = draw(dec, SD.init_sd_module_)
        pipe.tokenizer, pipe.tokenizer_t5 = tokenizer, tokenizer_t5
        return pipe

    @classmethod
    def from_pretrained(cls, dit_path=None, vae_path=None, bert_path=None, t5_paths=None,
                        tokenizer_path=None, tokenizer_t5_path=None, device=None,
                        dtype=torch.bfloat16) -> "HunyuanImagePipeline":
        """The DiT (DiffSynth or raw names), the SDXL VAE (`encoder.` /
        `decoder.`), the BERT (HF `BertModel`), mT5-XL (HF `T5EncoderModel`,
        shards) and the two tokenizer directories."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if dit_path:
            sd = C.load_state_dict_files(dit_path if isinstance(dit_path, list) else [dit_path],
                                         lazy=True)
            pipe.dit = C.build_module(H.HunyuanImageDiT, pipe.dit_cfg,
                                      H.convert_hunyuan_image_dit(sd, pipe.dit_cfg), dev, dtype)
        if vae_path:
            enc, dec = split_vae_file(C.load_state_dict(vae_path, lazy=True))
            pipe.vae_encoder = C.build_module(SD.SDVAEEncoder, None, SD.convert_sd_module(enc),
                                              dev, torch.float32)
            pipe.vae_decoder = C.build_module(SD.SDVAEDecoder, None, SD.convert_sd_module(dec),
                                              dev, torch.float32)
        if bert_path:
            pipe.bert = C.build_module(H.HunyuanBert, H.HUNYUAN_BERT, H.convert_hunyuan_bert(
                C.load_state_dict(bert_path, lazy=True)), dev, dtype)
        if t5_paths:
            sd = C.load_state_dict_files(t5_paths if isinstance(t5_paths, list) else [t5_paths],
                                         lazy=True)
            pipe.t5 = C.build_module(T5Encoder, MT5_XL, convert_hf_t5(sd, MT5_XL), dev, dtype)
        if tokenizer_path:
            from transformers import BertTokenizer
            pipe.tokenizer = BertTokenizer.from_pretrained(tokenizer_path)
        if tokenizer_t5_path:
            from transformers import AutoTokenizer
            pipe.tokenizer_t5 = AutoTokenizer.from_pretrained(tokenizer_t5_path)
        return pipe

    # ---------------- encoders ----------------

    def _tokens(self, tokenizer, prompt: str, length: int):
        out = tokenizer([prompt], padding="max_length", truncation=True, max_length=length,
                        return_tensors="np")
        return tuple(torch.from_numpy(np.asarray(out[k], np.int64)).to(self.device)
                     for k in ("input_ids", "attention_mask"))

    @torch.no_grad()
    def encode_prompt(self, prompt: str, clip_skip: int = 1) -> dict:
        """-> text_emb / text_emb_t5 and their masks, timed as `bert_encode`
        and `t5_encode`."""
        missing = [n for n, v in (("bert", self.bert), ("t5", self.t5),
                                  ("tokenizer", self.tokenizer),
                                  ("tokenizer_t5", self.tokenizer_t5)) if v is None]
        if missing:
            raise RuntimeError(f"the HunyuanDiT pipeline has no {', '.join(missing)}")
        cfg = self.dit_cfg
        with self._stage("bert_encode"):
            ids, mask = self._tokens(self.tokenizer, prompt, cfg.text_length)
            emb = H.hunyuan_bert_forward(self.bert, ids, mask, clip_skip=clip_skip)
        with self._stage("t5_encode"):
            ids5, mask5 = self._tokens(self.tokenizer_t5, prompt, cfg.t5_length)
            emb5 = t5_encode(self.t5, ids5)
        return {"text_emb": emb.to(self.dtype), "text_emb_t5": emb5.to(self.dtype),
                "text_emb_mask": mask.to(torch.int32), "text_emb_mask_t5": mask5.to(torch.int32)}

    def _forward(self, latents, t, cond, size, cos, sin):
        return H.hunyuan_image_dit_forward(self.dit, latents, cond["text_emb"],
                                           cond["text_emb_t5"], cond["text_emb_mask"],
                                           cond["text_emb_mask_t5"], t, size, cos, sin)

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 7.5,
        clip_skip: int = 1,
        input_image=None,
        denoising_strength: float = 1.0,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 20,
        seed: Optional[int] = None,
        progress_bar_cmd=None,
        return_latents: bool = False,
    ):
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        height = (height + 15) // 16 * 16
        width = (width + 15) // 16 * 16
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        noise = generate_noise((1, 4, height // 8, width // 8), seed=seed).to(dev, dtype)
        if input_image is not None:
            with self._stage("vae_encode"):
                img = _preprocess_images(_image_array(input_image, width, height)[None])[:, :, 0]
                z = SD.sd_vae_encoder_forward(self.vae_encoder, torch.from_numpy(img).to(dev))
            latents = self.scheduler.add_noise(z.float(), noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        else:
            latents = noise

        posi = self.encode_prompt(prompt, clip_skip)
        nega = self.encode_prompt(negative_prompt, clip_skip) if cfg_scale != 1.0 else None
        size = torch.tensor([[width, height, width, height, 0, 0]], dtype=torch.float32,
                            device=dev)
        cos, sin = H._rope_on(self.dit_cfg, height // 8, width // 8, dev)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = self.scheduler.timesteps[i]
            tt = torch.tensor([float(t)], dtype=torch.float32, device=dev)
            with self._stage(f"denoise_step_{i}"):
                pred = self._forward(latents, tt, posi, size, cos, sin)
                if nega is not None:
                    pred_n = self._forward(latents, tt, nega, size, cos, sin)
                    pred = pred_n + cfg_scale * (pred - pred_n)
                latents = self.scheduler.step(pred.float(), t, latents.float()).to(dtype)

        if return_latents:
            return latents
        with self._stage("vae_decode"):
            image = SD.sd_vae_decoder_forward(self.vae_decoder, latents.float())
        return self.vae_output_to_image(image)
