"""HunyuanVideo text-, video- and image-to-video in PyTorch.

Counterpart of `video_styler_tpu/pipelines/hunyuan_video.py`
(`HunyuanVideoPipeline.__call__` :226-333): flow matching with shift 7,
sigma_min 0 and the extra step, the embedded guidance through the DiT's
guidance embedder (CFG 1 is the default; `cfg_scale != 1` runs a second
pass on the negative prompt), the Euler update in fp32, and the 3-D tiled
VAE decode. Options: video-to-video (`input_video`, `denoising_strength`:
the tiled encode and the scheduler's noising), image-to-video
(`input_images`: the first latent frame pinned to the image's encode every
step, with the i2v stability mix of noise and image at the start) and
TeaCache (`tea_cache_l1_thresh`: the trunk skipped while the rescaled
change of block 0's modulated input stays under the threshold; the stored
residual replayed).

The prompt: the LLaMA-3-8B tower's hidden states two layers from the top,
without the final norm, under the video template, its first 95 rows
dropped and 256 kept with their mask (`fetch_llm`, backend "native": the
port's `models.llm_decoder`), and CLIP-L's pooled output. A tokenizer is a
callable with the Hugging Face call signature or a tokenizer directory
(read through `transformers`, imported when called). A request without a
text tower or tokenizer raises a RuntimeError naming what it lacks (the
JAX runner builds no CLIP-L and its request calls None). The
`transformers` backend (JAX's host fallback to HF's LlamaModel) is not
ported: it raises `NotImplementedError`.

Runs on `cuda` unless constructed with `device="cpu"`. Each stage's wall
time (synchronised with the card) is kept in `stage_times`, and on the card
the running peak of `torch.cuda.max_memory_allocated` in `stage_peak_bytes`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import hunyuan_video_dit as D
from ..models import hunyuan_video_vae as V
from ..models.llm_decoder import (DecoderLM, DecoderLMConfig, convert_decoder_lm,
                                  decoder_lm_forward, detect_decoder_lm_config,
                                  init_decoder_lm_)
from ..models.sd3_text_encoder import (CLIP_L, ClipTextConfig, ClipTextEncoder,
                                       convert_sd3_text_encoder_1, init_clip_text_,
                                       sd3_text_encoder_1_forward)
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils import ckpt as C
from .flux_image import FluxImagePipeline, FluxTeaCache
from .wan_video import WanVideoPipeline, _image_array, _preprocess_images, generate_noise

PROMPT_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by detailing the "
    "following aspects: 1. The main content and theme of the video. 2. The color, shape, "
    "size, texture, quantity, text, and spatial relationships of the objects. 3. Actions, "
    "events, behaviors temporal relationships, physical movement changes of the objects. "
    "4. background environment, light, style and atmosphere. 5. camera angles, movements, "
    "and transitions used in the video.<|eot_id|><|start_header_id|>user<|end_header_id|>"
    "\n\n{}<|eot_id|>")
CROP_START = 95
CLIP_LENGTH = 77
BACKENDS = ("native", "transformers")


class StubLlamaTokenizer:
    """Deterministic stand-in for the LLaMA-3 tokenizer (smoke runs, tests,
    the card's runs): one id per special token, newline run, word and
    punctuation mark (crc32 into the vocabulary), right padding with id 0
    to `max_length`, and the attention mask. The video template's prefix
    comes to 93 such ids where LLaMA-3's tokenizer gives 94 after its
    begin id, so the stand-in begins with two begin ids: the prompt starts
    at row `CROP_START` as with the real tokenizer."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, text, max_length: int = CROP_START + 256, **kw):
        import re
        import zlib
        text = text[0] if isinstance(text, (list, tuple)) else text
        pieces = re.findall(r"<\|[^|]+\|>|\n+|\w+|[^\w\s]", text)
        ids = ([1, 1] + [2 + zlib.crc32(t.encode()) % (self.vocab - 2) for t in pieces])
        ids = ids[:max_length]
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        ids += [0] * (max_length - len(ids))
        return {"input_ids": np.asarray([ids], np.int64),
                "attention_mask": np.asarray([mask], np.int64)}


class HunyuanTeaCache(FluxTeaCache):
    """HunyuanVideo's TeaCache: FLUX's rule (the relative L1 change of block
    0's modulated input, reduced on the device, rescaled by a fixed poly(4)
    and accumulated until it passes the threshold) with HunyuanVideo's
    polynomial, on component_a of the first double block."""

    COEFFS = [7.33226126e+02, -4.01131952e+02, 6.75869174e+01,
              -3.14987800e+00, 9.61237896e-02]


class HunyuanVideoPipeline:

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(shift=7.0, sigma_min=0.0, extra_one_step=True)
        self.dit: Optional[D.HunyuanVideoDiT] = None
        self.dit_cfg: D.HunyuanVideoDiTConfig = D.HUNYUAN_VIDEO
        self.vae_encoder: Optional[V.HunyuanVAEEncoder] = None
        self.vae_decoder: Optional[V.HunyuanVAEDecoder] = None
        self.vae_cfg: V.HunyuanVAEConfig = V.HUNYUAN_VAE
        self.clip: Optional[ClipTextEncoder] = None
        self.clip_tokenizer: Optional[Callable] = None
        self.llm: Optional[Callable] = None          # prompt -> (emb, mask)
        self.llm_model: Optional[DecoderLM] = None
        self.llm_tokenizer: Optional[Callable] = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, dit_cfg: D.HunyuanVideoDiTConfig, clip_cfg: ClipTextConfig,
                     llm_cfg: DecoderLMConfig, vae_cfg: V.HunyuanVAEConfig,
                     clip_tokenizer: Callable, llm_tokenizer: Callable, seed: int = 0,
                     device=None, dtype=torch.bfloat16) -> "HunyuanVideoPipeline":
        """Random weights drawn on the device from one seeded generator: the
        DiT, CLIP-L and the LLM in `dtype`, the VAE in fp32."""
        pipe = cls(device=device, dtype=dtype)
        pipe.dit_cfg, pipe.vae_cfg = dit_cfg, vae_cfg
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)

        def draw(module, init):
            return init(module.to_empty(device=dev), gen).eval()

        with torch.device("meta"):
            dit = D.HunyuanVideoDiT(dit_cfg, dtype=dtype)
            clip = ClipTextEncoder(clip_cfg, dtype=dtype)
            llm = DecoderLM(llm_cfg, dtype=dtype)
            enc = V.HunyuanVAEEncoder(vae_cfg, dtype=torch.float32)
            dec = V.HunyuanVAEDecoder(vae_cfg, dtype=torch.float32)
        pipe.dit = draw(dit, D.init_hunyuan_video_dit_)
        pipe.clip = draw(clip, init_clip_text_)
        pipe.clip_tokenizer = clip_tokenizer
        pipe.use_llm(draw(llm, init_decoder_lm_), llm_tokenizer)
        pipe.vae_encoder = draw(enc, V.init_hunyuan_vae_)
        pipe.vae_decoder = draw(dec, V.init_hunyuan_vae_)
        return pipe

    @classmethod
    def from_pretrained(cls, dit_path=None, vae_encoder_path=None, vae_decoder_path=None,
                        clip_path=None, clip_tokenizer_path=None, device=None,
                        dtype=torch.bfloat16) -> "HunyuanVideoPipeline":
        """Build from checkpoint files: the DiT (DiffSynth or civitai layout,
        `HUNYUAN_VIDEO`), the VAE encoder and decoder (the reference's
        module state dicts), CLIP-L (the reference's SD3TextEncoder1 names)
        and the CLIP tokenizer directory. The LLM comes from `fetch_llm`."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if dit_path:
            sd = C.load_state_dict_files(dit_path if isinstance(dit_path, list) else [dit_path],
                                         lazy=True)
            pipe.dit = C.build_module(D.HunyuanVideoDiT, pipe.dit_cfg,
                                      D.convert_hunyuan_video_dit(sd, pipe.dit_cfg), dev, dtype)
        for attr, cls_, path in (("vae_encoder", V.HunyuanVAEEncoder, vae_encoder_path),
                                 ("vae_decoder", V.HunyuanVAEDecoder, vae_decoder_path)):
            if path:
                setattr(pipe, attr, C.build_module(
                    cls_, pipe.vae_cfg, V.convert_hunyuan_vae(C.load_state_dict(path, lazy=True)),
                    dev, torch.float32))
        if clip_path:
            pipe.clip = C.build_module(
                ClipTextEncoder, CLIP_L,
                convert_sd3_text_encoder_1(C.load_state_dict(clip_path, lazy=True)), dev, dtype)
        if clip_tokenizer_path:
            from transformers import CLIPTokenizer
            pipe.clip_tokenizer = CLIPTokenizer.from_pretrained(clip_tokenizer_path)
        return pipe

    def fetch_llm(self, model_path, tokenizer, template: Optional[str] = None,
                  backend: str = "native"):
        """The LLaMA text tower from `model_path` (a file or a list of shards,
        HF names; its config from the shapes), with `tokenizer` a callable or
        a tokenizer directory.

        backend="transformers": HF's `LlamaModel` from the model directory
        `model_path`, on the pipeline's device and dtype, taking the native
        path's layer: `hidden_states[-3]`, the output of layer n - 2 without
        the final norm."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown LLM backend {backend!r}; one of {BACKENDS}")
        if isinstance(tokenizer, str):
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(tokenizer)
        if backend == "transformers":
            from transformers import LlamaModel
            model = LlamaModel.from_pretrained(model_path, dtype=self.dtype).to(
                self.device).eval()
            self._use_encoder(model, tokenizer, template,
                              lambda ids, mask: model(input_ids=ids, attention_mask=mask,
                                                      output_hidden_states=True
                                                      ).hidden_states[-3])
            return
        sd = C.load_state_dict_files(model_path if isinstance(model_path, list)
                                     else [model_path], lazy=True)
        cfg = detect_decoder_lm_config(sd, family="llama")
        model = C.build_module(DecoderLM, cfg, convert_decoder_lm(sd, cfg), self.device,
                               self.dtype)
        self.use_llm(model, tokenizer, template)

    def use_llm(self, model: DecoderLM, tokenizer: Callable, template: Optional[str] = None):
        """Encode prompts with `model`: the template, `CROP_START` rows
        dropped, the hidden states two layers from the top without the
        final norm, the DiT's `txt_len` rows and their mask."""
        self._use_encoder(model, tokenizer, template, lambda ids, mask: decoder_lm_forward(
            model, ids, mask, stop_skip_layers=2, final_norm=False))

    def _use_encoder(self, model, tokenizer: Callable, template: Optional[str],
                     hidden_fn: Callable):
        template = template or PROMPT_TEMPLATE
        self.llm_model, self.llm_tokenizer = model, tokenizer

        @torch.no_grad()
        def encode(prompt: str, max_length: Optional[int] = None):
            # the text rows the DiT takes (256: the JAX encoder's max_length)
            max_length = max_length or self.dit_cfg.txt_len
            out = tokenizer(template.format(prompt), return_tensors="np", padding="max_length",
                            max_length=max_length + CROP_START, truncation=True)
            dev = next(model.parameters()).device
            ids = torch.from_numpy(np.asarray(out["input_ids"], np.int64)).to(dev)
            mask = torch.from_numpy(np.asarray(out["attention_mask"], np.int64)).to(dev)
            hidden = hidden_fn(ids, mask)
            return hidden[:, CROP_START:].to(self.dtype), mask[:, CROP_START:].to(torch.int32)

        self.llm = encode

    # ---------------- helpers ----------------

    _stage = FluxImagePipeline._stage

    @torch.no_grad()
    def encode_prompt(self, prompt: str):
        """-> (prompt_emb (1, 256, 4096), text_mask (1, 256), pooled (1, 768)),
        timed as `llm_encode` and `clip_encode`."""
        missing = [name for name, v in (("llm (fetch_llm)", self.llm),
                                        ("clip (clip_path)", self.clip),
                                        ("clip_tokenizer (clip_tokenizer_path)",
                                         self.clip_tokenizer)) if v is None]
        if missing:
            raise RuntimeError(f"the HunyuanVideo pipeline has no {', '.join(missing)}")
        with self._stage("llm_encode"):
            emb, mask = self.llm(prompt)
        with self._stage("clip_encode"):
            out = self.clip_tokenizer([prompt], padding="max_length", max_length=CLIP_LENGTH,
                                      truncation=True, return_tensors="np")
            ids = torch.from_numpy(np.asarray(out["input_ids"], np.int64)).to(
                self.clip.position_embeds.device)
            pooled, _ = sd3_text_encoder_1_forward(self.clip, ids)
        return emb, mask, pooled.to(self.dtype)

    @torch.no_grad()
    def encode_video(self, video_np: np.ndarray, tile_size=(17, 30, 30),
                     tile_stride=(12, 20, 20)):
        """(1, 3, T, H, W) in [-1, 1] -> latents in `dtype`, through pixel
        tiles of the latent tile size and stride."""
        ts = ((tile_size[0] - 1) * 4 + 1, tile_size[1] * 8, tile_size[2] * 8)
        st = (tile_stride[0] * 4, tile_stride[1] * 8, tile_stride[2] * 8)
        video = torch.from_numpy(np.asarray(video_np, np.float32)).to(self.device)
        return V.tiled_encode(self.vae_encoder, video, tile_size=ts, tile_stride=st).to(self.dtype)

    @torch.no_grad()
    def decode_video(self, latents, tile_size=(17, 30, 30), tile_stride=(12, 20, 20)):
        return V.tiled_decode(self.vae_decoder, latents.float(), tile_size=tuple(tile_size),
                              tile_stride=tuple(tile_stride))

    def _branch(self, latents, timestep, cond, guidance, tea_cache):
        emb, mask, pooled = cond
        img, txt, vec, cos, sin, grid = D.hunyuan_embed(self.dit, latents, timestep, emb, mask,
                                                        pooled, guidance)
        if tea_cache is not None:
            skip = tea_cache.check(D.hunyuan_modulated_input(self.dit, img, vec))
            if skip and tea_cache.previous_residual is not None:
                return D.hunyuan_head(self.dit, img + tea_cache.previous_residual, vec, grid)
        h = D.hunyuan_trunk(self.dit, img, txt, vec, cos, sin)
        if tea_cache is not None:
            tea_cache.store(h - img)
        return D.hunyuan_head(self.dit, h, vec, grid)

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        input_video=None,
        input_images=None,
        i2v_stability: bool = True,
        denoising_strength: float = 1.0,
        seed: Optional[int] = None,
        height: int = 720,
        width: int = 1280,
        num_frames: int = 129,
        embedded_guidance: float = 6.0,
        cfg_scale: float = 1.0,
        num_inference_steps: int = 30,
        tea_cache_l1_thresh: Optional[float] = None,
        tile_size=(17, 30, 30),
        tile_stride=(12, 20, 20),
        progress_bar_cmd=None,
        return_latents: bool = False,
    ):
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        kw = dict(tile_size=tile_size, tile_stride=tile_stride)
        t_lat = (num_frames - 1) // 4 + 1
        noise = generate_noise((1, 16, t_lat, height // 8, width // 8), seed=seed).to(dev, dtype)

        image_latents = None
        if input_images is not None:
            with self._stage("vae_encode_image"):
                img = _preprocess_images(_image_array(input_images[0], width, height)[None])
                image_latents = V.vae_encode(
                    self.vae_encoder, torch.from_numpy(img).to(dev)).to(dtype)

        if input_video is not None:
            with self._stage("vae_encode"):
                z = self.encode_video(_preprocess_images(input_video), **kw)
            latents = self.scheduler.add_noise(z.float(), noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        elif image_latents is not None and i2v_stability:
            t_mix = 0.999      # the i2v stability mix
            latents = (noise * t_mix + image_latents.repeat(1, 1, t_lat, 1, 1)
                       * (1 - t_mix)).to(dtype)
        else:
            latents = noise

        posi = self.encode_prompt(prompt)
        nega = self.encode_prompt(negative_prompt) if cfg_scale != 1.0 else None
        guidance = torch.tensor([embedded_guidance], dtype=torch.float32, device=dev)
        tea_cache = None
        if tea_cache_l1_thresh is not None:
            tea_cache = HunyuanTeaCache(num_inference_steps, tea_cache_l1_thresh)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t = torch.tensor([float(self.scheduler.timesteps[i])], dtype=torch.float32,
                             device=dev)
            with self._stage(f"denoise_step_{i}"):
                if image_latents is not None:
                    latents = torch.cat([image_latents, latents[:, :, 1:]], dim=2)
                v = self._branch(latents, t, posi, guidance, tea_cache)
                if cfg_scale != 1.0:
                    v_nega = self._branch(latents, t, nega, guidance, None)
                    v = v_nega + cfg_scale * (v - v_nega)
                sigma, sigma_next = self.scheduler.sigma_pair(i)
                if image_latents is not None:
                    tail = (latents[:, :, 1:].float() + v[:, :, 1:].float()
                            * (sigma_next - sigma)).to(dtype)
                    latents = torch.cat([image_latents, tail], dim=2)
                else:
                    latents = (latents.float() + v.float() * (sigma_next - sigma)).to(dtype)

        if return_latents:
            return latents
        with self._stage("vae_decode"):
            video = self.decode_video(latents, **kw)
        return WanVideoPipeline.vae_output_to_video(video.clamp(-1, 1))
