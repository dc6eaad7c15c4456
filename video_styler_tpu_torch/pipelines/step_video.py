"""StepVideo text-to-video in PyTorch.

Counterpart of `video_styler_tpu/pipelines/step_video.py`
(`StepVideoPipeline.__call__` :96-144): flow matching at shift 13 with the
sigmas reversed over one train timestep, `frames // 17 * 3` latent frames
of 64 channels at 1/16 of the size, the Euler update in fp32, two-pass CFG
(9 by default) on the negative prompt, and the chunked fp32 VAE decode.

The prompt (`fetch_text_encoders`, the JAX method of that name :59-94): the
bilingual CLIP (HunyuanDiT's Chinese CLIP-BERT, `hunyuan_image_dit.
hunyuan_bert_forward`) over 77 tokens and the Step-1 LLM over 320, the
LLM's mask left-padded with ones for the 77 CLIP rows. Tokenizers: a
callable(prompt, max_length) -> (ids, mask) for the LLM
(`stepvideo_llm.make_stepchat_tokenize` reads the StepChat sentencepiece
model; `stub_stepchat_tokenize` stands in for it) and a BERT tokenizer
callable or directory (`transformers`, imported when called). A request
without a text encoder raises a RuntimeError: the JAX runner never builds
one and its request calls None.

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
from ..models import stepvideo_dit as D
from ..models import stepvideo_llm as L
from ..models import stepvideo_vae as V
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils import ckpt as C
from .flux_image import FluxImagePipeline
from .wan_video import WanVideoPipeline, generate_noise

CLIP_LENGTH = 77
LLM_LENGTH = 320


class StepVideoPipeline:

    _stage = FluxImagePipeline._stage

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(sigma_min=0.0, extra_one_step=True, shift=13.0,
                                            reverse_sigmas=True, num_train_timesteps=1)
        self.dit: Optional[D.StepVideoDiT] = None
        self.dit_cfg: D.StepVideoDiTConfig = D.STEP_VIDEO
        self.vae: Optional[V.StepVideoVAE] = None
        self.text_encoder: Optional[Callable] = None   # prompt -> (llm, clip, mask)
        self.llm: Optional[L.Step1LLM] = None
        self.clip: Optional[H.HunyuanBert] = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, dit_cfg: D.StepVideoDiTConfig, vae_cfg: V.StepVAEConfig,
                     seed: int = 0, device=None, dtype=torch.bfloat16,
                     dit: bool = True, vae: bool = True) -> "StepVideoPipeline":
        """Random weights drawn on the device from a seeded generator: the
        DiT in `dtype` (not with dit=False), the VAE in fp32 (not with
        vae=False). The text towers come from `fetch_text_encoders`."""
        pipe = cls(device=device, dtype=dtype)
        pipe.dit_cfg = dit_cfg
        gen = torch.Generator(pipe.device).manual_seed(seed)
        if vae:
            with torch.device("meta"):
                model = V.StepVideoVAE(vae_cfg, dtype=torch.float32)
            pipe.vae = V.init_step_vae_(model.to_empty(device=pipe.device), gen).eval()
        if dit:
            pipe.build_dit(seed + 1)
        return pipe

    def build_dit(self, seed: int):
        """A random DiT of `dit_cfg` from `seed`, on the device."""
        gen = torch.Generator(self.device).manual_seed(seed)
        with torch.device("meta"):
            dit = D.StepVideoDiT(self.dit_cfg, dtype=self.dtype)
        self.dit = D.init_step_video_dit_(dit.to_empty(device=self.device), gen).eval()

    @classmethod
    def from_pretrained(cls, dit_paths=None, vae_path=None, device=None,
                        dtype=torch.bfloat16) -> "StepVideoPipeline":
        """The DiT (shards) and the VAE, the reference's names."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if dit_paths:
            sd = C.load_state_dict_files(dit_paths if isinstance(dit_paths, list)
                                         else [dit_paths], lazy=True)
            pipe.dit = C.build_module(D.StepVideoDiT, pipe.dit_cfg,
                                      D.convert_step_video_dit(sd, pipe.dit_cfg), dev, dtype)
        if vae_path:
            pipe.vae = C.build_module(V.StepVideoVAE, V.STEP_VAE, V.convert_step_vae(
                C.load_state_dict(vae_path, lazy=True)), dev, torch.float32)
        return pipe

    def fetch_text_encoders(self, clip, clip_tokenizer, llm, llm_tokenize,
                            llm_max_length: int = LLM_LENGTH):
        """Encode prompts with the bilingual CLIP `clip` (a `HunyuanBert`, or
        a file of HF `BertModel` names) under `clip_tokenizer` (a callable
        or a directory) and the Step-1 LLM `llm` (a `Step1LLM`, or a file /
        list of shards) under `llm_tokenize` (callable(prompt, max_length)
        -> (ids, mask), or the StepChat sentencepiece model's path)."""
        if not isinstance(clip, torch.nn.Module):
            clip = C.build_module(H.HunyuanBert, H.HUNYUAN_BERT, H.convert_hunyuan_bert(
                C.load_state_dict(clip, lazy=True)), self.device, self.dtype)
        if not isinstance(llm, torch.nn.Module):
            sd = C.load_state_dict_files(llm if isinstance(llm, list) else [llm], lazy=True)
            llm = C.build_module(L.Step1LLM, L.STEP1_LLM, L.convert_step1_llm(sd), self.device,
                                 self.dtype)
        if isinstance(clip_tokenizer, str):
            from transformers import BertTokenizer
            clip_tokenizer = BertTokenizer.from_pretrained(clip_tokenizer)
        if isinstance(llm_tokenize, str):
            llm_tokenize = L.make_stepchat_tokenize(llm_tokenize)
        self.clip, self.llm = clip, llm

        @torch.no_grad()
        def encode(prompt: str):
            dev = clip.embeddings.word_embeddings.weight.device
            with self._stage("clip_encode"):
                enc = clip_tokenizer([prompt], padding="max_length", max_length=CLIP_LENGTH,
                                     truncation=True, return_attention_mask=True,
                                     return_tensors="np")
                ids = torch.from_numpy(np.asarray(enc["input_ids"], np.int64)).to(dev)
                cmask = torch.from_numpy(np.asarray(enc["attention_mask"], np.int64)).to(dev)
                clip_emb = H.hunyuan_bert_forward(clip, ids, cmask)
            with self._stage("llm_encode"):
                ids, mask = llm_tokenize(prompt, llm_max_length)
                llm_emb = L.step1_llm_forward(
                    llm, torch.from_numpy(np.asarray(ids, np.int64)).to(
                        llm.tok_embeddings.word_embeddings.weight.device))
            mask = np.pad(np.asarray(mask), ((0, 0), (clip_emb.shape[1], 0)), constant_values=1)
            return (llm_emb.to(self.dtype), clip_emb.to(self.dtype),
                    torch.from_numpy(mask.astype(np.int64)).to(self.device))

        self.text_encoder = encode
        return self

    @torch.no_grad()
    def decode_video(self, latents):
        """latents (1, T_lat, 64, h, w) -> uint8 (T, H, W, 3)."""
        with self._stage("vae_decode"):
            video = V.vae_decode(self.vae, latents.float())
        return WanVideoPipeline.vae_output_to_video(video.clamp(-1, 1))

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 9.0,
        height: int = 544,
        width: int = 992,
        num_frames: int = 204,
        num_inference_steps: int = 30,
        seed: Optional[int] = None,
        progress_bar_cmd=None,
        return_latents: bool = False,
    ):
        if self.text_encoder is None:
            raise RuntimeError("the StepVideo pipeline has no text encoder "
                               "(fetch_text_encoders)")
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        self.scheduler.set_timesteps(num_inference_steps)
        t_lat = max(num_frames // 17 * 3, 1)
        latents = generate_noise((1, t_lat, 64, height // 16, width // 16),
                                 seed=seed).to(dev, dtype)
        posi = self.text_encoder(prompt)
        nega = self.text_encoder(negative_prompt) if cfg_scale != 1.0 else None

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = torch.tensor([float(self.scheduler.timesteps[i])], dtype=torch.float32,
                             device=dev)
            with self._stage(f"denoise_step_{i}"):
                v = D.step_video_dit_forward(self.dit, latents, t, *posi)
                if nega is not None:
                    v_nega = D.step_video_dit_forward(self.dit, latents, t, *nega)
                    v = v_nega + cfg_scale * (v - v_nega)
                sigma, sigma_next = self.scheduler.sigma_pair(i)
                latents = (latents.float() + v.float() * (sigma_next - sigma)).to(dtype)
        if return_latents:
            return latents
        return self.decode_video(latents)
