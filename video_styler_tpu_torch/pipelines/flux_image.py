"""FLUX.1 text-to-image (and img2img, Kontext) pipeline in PyTorch.

Counterpart of `video_styler_tpu/pipelines/flux_image.py`
(`FluxImagePipeline.__call__` :358-637): the CLIP-L pooled embedding and
the T5 v1.1 sequence embedding of the prompt, noise of (1, 16, H/8, W/8)
from `generate_noise`, the flow-match Euler loop (shift 3) with the
embedded guidance through the DiT's guidance embedder (CFG 1 is the
distilled default; `cfg_scale != 1` runs a second pass on the negative
prompt), the Euler update in fp32, and the 16-channel VAE decode. Options
of the base pipeline: img2img (`input_image`, `denoising_strength`: the
VAE encoder and the scheduler's noising), Kontext reference images (extra
tokens with f_id = 1), FLUX TeaCache (`tea_cache_l1_thresh`) and a merged
FLUX LoRA (`load_lora`).

The adapters, in the JAX `__call__`'s order (:418-629), each with its
loader (:157-217):
  - value control (`load_value_controllers`): tokens appended to the text
    of both CFG branches;
  - the LoRA encoder (`load_lora_encoder`): a LoRA's tokens, times
    `lora_encoder_scale`, appended to the positive branch's text;
  - InfiniteYou (`load_infiniteyou`): the projected ArcFace identity
    (`infinityou_id_emb`, or `infiniteyou_face_embedder` applied to
    `infinityou_id_image`) replaces the ControlNet branch's prompt tokens,
    `infinityou_guidance` its guidance;
  - EliGen (`eligen_entity_prompts`, `eligen_entity_masks`): the entities'
    prompts ahead of the prompt and an attention bias on the positive
    branch (the exact `sdpa`);
  - the ControlNet (`load_controlnet`, `controlnet_image`, plain or union
    with `controlnet_processor_id`): the VAE-encoded control image through
    the ControlNet trunk per CFG branch, residuals times `controlnet_scale`;
  - the IP-Adapter (`load_ipadapter`, `ipadapter_images`): keys and values
    of the `ipadapter_image_encoder` embedding (the SigLIP tower is the
    caller's callable, as in JAX), zeros' for the negative branch;
  - Flex (`flex_condition`, `flex_uncondition`): channels concatenated to
    the latents, the uncondition from `flex_control_stop_timestep` down;
  - Nexus-Gen (`nexus_gen`, a callable(prompt, ref_image=None) -> (embed,
    ref_embed, grids), such as `models.nexus_gen.NexusGenARModel`): the
    predicted image embedding through the generation adapter
    (`nexus_gen_generation_adapter`) or, with `nexus_gen_reference_image`,
    with the reference's through the editing merger
    (`nexus_gen_editing_adapter`) replaces the positive branch's prompt
    tokens, with zero text ids or the editing grids' ids;
  - Step1x (`step1x_reference_image`, with `fetch_qwenvl`'s embedder and a
    `step1x_connector`): the Qwen2.5-VL embedding of the prompt and the
    image goes through the connector every step, at timestep / 1000, for
    the positive branch's prompt tokens (zero text ids) and pooled vector;
    the reference image's latent rides the Kontext tokens with f_id 0.
`fetch_qwenvl` builds Step1x's Qwen2.5-VL embedder (`models.qwen_vl_embedder.
QwenVLStep1xEmbedder`).

Runs on `cuda` unless constructed with `device="cpu"`. Each stage's wall
time (synchronised with the card) is kept in `stage_times`, and on the card
the running peak of `torch.cuda.max_memory_allocated` in `stage_peak_bytes`.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..flux_lora import convert_flux_lora
from ..lora import merge_lora
from ..models import flux_adapters as FA
from ..models import flux_controlnet as FC
from ..models import flux_dit as F
from ..models import nexus_gen as NG
from ..models import sd3_vae as V
from ..models import step1x as S1
from ..models.sd3_text_encoder import (CLIP_L, ClipTextConfig, ClipTextEncoder,
                                       convert_sd3_text_encoder_1, init_clip_text_)
from ..models.t5 import T5_V11_XXL, T5Config, T5Encoder, convert_hf_t5, init_t5_
from ..prompters.flux_prompter import FluxPrompter
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils import ckpt as C
from .wan_video import _image_array, _preprocess_images, generate_noise

# the JAX `__call__`'s defaults for the adapters' scalar settings
ADAPTER_SETTINGS = dict(flex_control_stop_timestep=0.0, controlnet_scale=1.0,
                        controlnet_processor_id=None, ipadapter_scale=1.0,
                        infinityou_guidance=1.0, lora_encoder_scale=1.0)


class FluxTeaCache:
    """FLUX TeaCache: a fixed poly(4) rescale of the relative L1 change of
    block 0's modulated input, accumulated until it passes the threshold.
    The change is reduced on the device; one number reaches the host."""

    COEFFS = [4.98651651e+02, -2.83781631e+02, 5.58554382e+01,
              -3.82021401e+00, 2.64230861e-01]

    def __init__(self, num_inference_steps: int, rel_l1_thresh: float):
        self.num_inference_steps = num_inference_steps
        self.rel_l1_thresh = rel_l1_thresh
        self.step = 0
        self.accumulated = 0.0
        self.previous_modulated = None
        self.previous_residual = None

    def check(self, modulated) -> bool:
        """True -> skip the trunk this step and reuse the stored residual."""
        modulated = modulated.float()
        if self.step == 0 or self.step == self.num_inference_steps - 1:
            should_calc = True
            self.accumulated = 0.0
        else:
            prev = self.previous_modulated
            rel = ((modulated - prev).abs().mean() / prev.abs().mean()).item()
            self.accumulated += float(np.polyval(self.COEFFS, rel))
            should_calc = self.accumulated >= self.rel_l1_thresh
            if should_calc:
                self.accumulated = 0.0
        self.previous_modulated = modulated
        self.step = (self.step + 1) % self.num_inference_steps
        return not should_calc

    def store(self, residual):
        self.previous_residual = residual


class FluxImagePipeline:

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(shift=3.0)
        self.prompter = FluxPrompter()
        self.dit: Optional[F.FluxDiT] = None
        self.dit_cfg: F.FluxDiTConfig = F.FLUX_DEV
        self.vae_encoder: Optional[V.SD3VAEEncoder] = None
        self.vae_decoder: Optional[V.SD3VAEDecoder] = None
        self.vae_cfg: V.SD3VAEConfig = V.FLUX_VAE
        self.t5_cfg: T5Config = T5_V11_XXL
        self.controlnet: Optional[FC.FluxControlNet] = None
        self.ipadapter: Optional[FC.FluxIpAdapter] = None
        # callable(list of 384x384 PIL images) -> (B, 1152) SigLIP embedding
        self.ipadapter_image_encoder: Optional[Callable] = None
        self.infiniteyou_projector: Optional[FA.InfiniteYouProjector] = None
        # callable(PIL image) -> (n, 512) ArcFace embedding
        self.infiniteyou_face_embedder: Optional[Callable] = None
        self.value_controllers: Optional[List[FA.SingleValueEncoder]] = None
        self.lora_encoder: Optional[FA.FluxLoRAEncoder] = None
        # Step1x's embedder: callable(captions, ref_images) -> (embs, masks)
        self.qwenvl = None
        self.step1x_connector: Optional[S1.Step1xConnector] = None
        # Nexus-Gen: callable(prompt, ref_image=None) -> (embed, ref_embed, grids)
        self.nexus_gen: Optional[Callable] = None
        self.nexus_gen_generation_adapter: Optional[NG.NexusGenAdapter] = None
        self.nexus_gen_editing_adapter: Optional[NG.NexusGenMerger] = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, dit_cfg: F.FluxDiTConfig, clip_cfg: ClipTextConfig,
                     t5_cfg: T5Config, vae_cfg: V.SD3VAEConfig, tokenizer_1: Callable,
                     tokenizer_2: Callable, seed: int = 0, device=None,
                     dtype=torch.bfloat16) -> "FluxImagePipeline":
        """Random weights drawn on the device from one seeded generator: the
        DiT, CLIP-L and T5 in `dtype`, the VAE in fp32."""
        pipe = cls(device=device, dtype=dtype)
        pipe.dit_cfg, pipe.t5_cfg, pipe.vae_cfg = dit_cfg, t5_cfg, vae_cfg
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)

        def draw(module, init):
            return init(module.to_empty(device=dev), gen).eval()

        with torch.device("meta"):
            dit = F.FluxDiT(dit_cfg, dtype=dtype)
            clip = ClipTextEncoder(clip_cfg, dtype=dtype)
            t5 = T5Encoder(t5_cfg, dtype=dtype)
            enc = V.SD3VAEEncoder(vae_cfg, dtype=torch.float32)
            dec = V.SD3VAEDecoder(vae_cfg, dtype=torch.float32)
        pipe.dit = draw(dit, F.init_flux_dit_)
        pipe.prompter = FluxPrompter(tokenizer_1, tokenizer_2, draw(clip, init_clip_text_),
                                     draw(t5, init_t5_))
        pipe.vae_encoder = draw(enc, V.init_sd3_vae_)
        pipe.vae_decoder = draw(dec, V.init_sd3_vae_)
        return pipe

    @classmethod
    def from_pretrained(cls, dit_path=None, vae_path=None, clip_path=None, t5_paths=None,
                        tokenizer_1_path=None, tokenizer_2_path=None, device=None,
                        dtype=torch.bfloat16) -> "FluxImagePipeline":
        """Build from checkpoint files: the DiT (DiffSynth or BFL layout;
        FLUX.1-schnell where the file has no guidance embedder), the VAE
        (the encoder's and decoder's module state dicts under `encoder.` and
        `decoder.`), CLIP-L (the reference's SD3TextEncoder1 names) and the
        T5 v1.1 shards (HF `T5EncoderModel` names). Tensors go from the
        files to `device` in their stored dtype and are cast there."""
        pipe = cls(device=device, dtype=dtype)
        dev = pipe.device
        if dit_path:
            sd = C.load_state_dict_files(dit_path if isinstance(dit_path, list) else [dit_path],
                                         lazy=True)
            pipe.dit_cfg = F.flux_config_for(sd)
            pipe.dit = C.build_module(F.FluxDiT, pipe.dit_cfg,
                                      F.convert_flux_dit(sd, pipe.dit_cfg), dev, dtype)
        if vae_path:
            enc, dec = V.split_vae_state_dict(C.load_state_dict(vae_path, lazy=True))
            pipe.vae_encoder = C.build_module(V.SD3VAEEncoder, pipe.vae_cfg,
                                              V.convert_sd3_vae(enc), dev, torch.float32)
            pipe.vae_decoder = C.build_module(V.SD3VAEDecoder, pipe.vae_cfg,
                                              V.convert_sd3_vae(dec), dev, torch.float32)
        if clip_path:
            pipe.prompter.clip = C.build_module(
                ClipTextEncoder, CLIP_L,
                convert_sd3_text_encoder_1(C.load_state_dict(clip_path, lazy=True)), dev, dtype)
        if t5_paths:
            sd = C.load_state_dict_files(t5_paths if isinstance(t5_paths, list) else [t5_paths],
                                         lazy=True)
            pipe.prompter.t5 = C.build_module(T5Encoder, pipe.t5_cfg,
                                              convert_hf_t5(sd, pipe.t5_cfg), dev, dtype)
        pipe.prompter.fetch_tokenizers(tokenizer_1_path, tokenizer_2_path)
        return pipe

    def load_lora(self, path=None, state_dict=None, alpha: float = 1.0):
        """Merge a FLUX LoRA (any public key layout, `flux_lora`) into the
        DiT's weights."""
        sd = state_dict if state_dict is not None else C.load_state_dict(path)
        merge_lora(self.dit, convert_flux_lora(sd), alpha=alpha)

    def fetch_qwenvl(self, model_paths, tokenizer):
        """Step1x's Qwen2.5-VL embedder (text and vision towers) from a
        checkpoint (a file or list of shards, HF names), with `tokenizer` a
        callable or a tokenizer directory (read through `transformers`)."""
        from ..models.qwen_vl_embedder import QwenVL, QwenVLStep1xEmbedder
        self.qwenvl = QwenVLStep1xEmbedder(QwenVL.from_files(model_paths, tokenizer,
                                                             self.device, self.dtype))

    def _load(self, kind, path, state_dict, cfg=None):
        sd = state_dict if state_dict is not None else C.load_state_dict(path, lazy=True)
        return C.build_image_module(kind, sd, self.dit_cfg, self.device, self.dtype, cfg)

    def load_controlnet(self, path=None, state_dict=None, cfg=None):
        """A FLUX ControlNet in the DiffSynth layout; its block counts, union
        mode table and conditioning width from the file."""
        self.controlnet = self._load("flux_controlnet", path, state_dict, cfg)

    def load_ipadapter(self, path=None, state_dict=None, image_encoder=None):
        """A FLUX IP-Adapter (DiffSynth or InstantX layout), one k/v pair for
        each DiT block; `image_encoder` the SigLIP callable."""
        self.ipadapter = self._load("flux_ipadapter", path, state_dict)
        if image_encoder is not None:
            self.ipadapter_image_encoder = image_encoder

    def load_infiniteyou(self, path=None, state_dict=None):
        """The InfiniteYou image projector: the published bundle
        ({"image_proj": {...}}) or a flat projector state dict."""
        self.infiniteyou_projector = self._load("flux_infiniteyou_projector", path, state_dict)

    def load_value_controllers(self, paths=None, state_dicts=None):
        """SingleValueEncoders, one for each controlled value."""
        if state_dicts is None:
            state_dicts = [C.load_state_dict(p, lazy=True) for p in paths]
        self.value_controllers = [self._load("flux_value_encoder", None, sd)
                                  for sd in state_dicts]

    def load_lora_encoder(self, path=None, state_dict=None):
        """The FLUX LoRA encoder (conditioning on a LoRA itself)."""
        self.lora_encoder = self._load("flux_lora_encoder", path, state_dict)

    # ---------------- helpers ----------------

    @contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.stage_peak_bytes.append((name, torch.cuda.max_memory_allocated(self.device)))
        self.stage_times.append((name, time.perf_counter() - t0))

    @staticmethod
    def check_resize(height: int, width: int):
        return (height + 15) // 16 * 16, (width + 15) // 16 * 16

    def encode_prompt(self, prompt: str, t5_sequence_length: int = 512):
        """-> (prompt_emb, pooled, text_ids), timed as `clip_encode` and
        `t5_encode`."""
        return self.prompter.encode_prompt(prompt, t5_sequence_length, dtype=self.dtype,
                                           stage=self._stage)

    @torch.no_grad()
    def encode_image(self, image_np: np.ndarray):
        z = V.sd3_vae_encoder_forward(
            self.vae_encoder, torch.from_numpy(image_np).to(self.device, torch.float32),
            self.vae_cfg)
        return z.to(self.dtype)

    @torch.no_grad()
    def decode_image(self, latents):
        return V.sd3_vae_decoder_forward(self.vae_decoder, latents.float(), self.vae_cfg)

    def _image(self, image, width: int, height: int) -> np.ndarray:
        """A PIL image or uint8 (H, W, 3) array -> (1, 3, height, width) in
        [-1, 1]."""
        return _preprocess_images(_image_array(image, width, height)[None])[:, :, 0]

    def _controlnet_res(self, latents, cn_cond, timestep, prompt_emb, pooled, guidance,
                        processor_id, scale: float):
        """The ControlNet trunk's residual stacks, aligned to the DiT's block
        counts and scaled."""
        res, single = FC.flux_controlnet_forward(self.controlnet, latents, cn_cond, timestep,
                                                 prompt_emb, pooled, guidance,
                                                 processor_id=processor_id)
        res = FC.align_res_stack(res, self.dit_cfg.num_joint_blocks)
        single = FC.align_res_stack(single, self.dit_cfg.num_single_blocks)
        return (None if res is None else res * scale,
                None if single is None else single * scale)

    def _branch(self, latents, timestep, prompt_emb, pooled, guidance, kontext, tea_cache,
                cn=None, ip_kv=None, ip_scale: float = 1.0, attn_bias=None, text_ids=None):
        kl, ki = kontext if kontext is not None else (None, None)
        x, ctx, temb, cos, sin, n_img = F.flux_embed(
            self.dit, latents, timestep, prompt_emb, pooled, guidance, text_ids=text_ids,
            kontext_latents=kl, kontext_ids=ki)
        height, width = latents.shape[-2:]
        if tea_cache is not None:
            skip = tea_cache.check(F.flux_modulated_input(self.dit, x, temb))
            if skip and tea_cache.previous_residual is not None:
                h = x + tea_cache.previous_residual
                return F.flux_head(self.dit, h[:, :n_img], temb, height, width)
        cn_res, cn_single = cn if cn is not None else (None, None)
        h = F.flux_trunk(self.dit, x, ctx, temb, cos, sin, controlnet_res=cn_res,
                         controlnet_single_res=cn_single, ip_kv=ip_kv, ip_scale=ip_scale,
                         attn_bias=attn_bias)
        if tea_cache is not None:
            tea_cache.store(h - x)
        return F.flux_head(self.dit, h[:, :n_img], temb, height, width)

    @staticmethod
    def _nexus_gen_editing_text_ids(lat_h: int, lat_w: int, embed_grid, ref_grid):
        """Per-embedding position grids scaled to the latent resolution; the
        reference grid's f_id is 1."""
        def ids(grid, f_id):
            h, w = int(grid[1]), int(grid[2])
            out = np.zeros((h // 2, w // 2, 3), np.float64)
            out[..., 0] = f_id
            out[..., 1] = np.arange(h // 2)[:, None] * (lat_h / h)
            out[..., 2] = np.arange(w // 2)[None, :] * (lat_w / w)
            return out.reshape(-1, 3)

        return np.concatenate([ids(embed_grid, 0), ids(ref_grid, 1)], axis=0)

    def _tensor(self, x):
        """A host array or a tensor -> a tensor on the device in `dtype`."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32))
        return x.to(self.device, self.dtype)

    def _encode_masks(self, masks, width: int, height: int) -> np.ndarray:
        """EliGen's entity masks -> (1, N, 1, H/8, W/8) {0, 1} float32 (L,
        NEAREST resize, > 127)."""
        from PIL import Image
        arrs = [(np.asarray(m.convert("L").resize((width // 8, height // 8), Image.NEAREST),
                            np.float32) > 127).astype(np.float32) for m in masks]
        return np.stack(arrs)[None, :, None]

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 1.0,
        embedded_guidance: float = 3.5,
        t5_sequence_length: int = 512,
        input_image=None,
        denoising_strength: float = 1.0,
        height: int = 1024,
        width: int = 1024,
        seed: Optional[int] = None,
        sigma_shift: Optional[float] = None,
        num_inference_steps: int = 30,
        kontext_images=None,
        eligen_entity_prompts=None,
        eligen_entity_masks=None,
        nexus_gen_reference_image=None,
        step1x_reference_image=None,
        flex_condition=None,
        flex_uncondition=None,
        flex_control_stop_timestep: float = 0.0,
        controlnet_image=None,
        controlnet_scale: float = 1.0,
        controlnet_processor_id: Optional[int] = None,
        ipadapter_images=None,
        ipadapter_scale: float = 1.0,
        infinityou_id_image=None,
        infinityou_id_emb=None,
        infinityou_guidance: float = 1.0,
        value_controller_inputs=None,
        lora_encoder_inputs=None,
        lora_encoder_scale: float = 1.0,
        tea_cache_l1_thresh: Optional[float] = None,
        progress_bar_cmd=None,
        return_latents: bool = False,
    ):
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        height, width = self.check_resize(height, width)
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength,
                                     shift=sigma_shift)

        noise = generate_noise((1, 16, height // 8, width // 8), seed=seed).to(dev, dtype)
        if input_image is not None:
            with self._stage("vae_encode"):
                input_latents = self.encode_image(self._image(input_image, width, height))
            latents = self.scheduler.add_noise(input_latents.float(), noise.float(),
                                               self.scheduler.timesteps[0]).to(dtype)
        else:
            latents = noise

        prompt_emb, pooled, _ = self.encode_prompt(prompt, t5_sequence_length)
        nega = None
        if cfg_scale != 1.0:
            nega = self.encode_prompt(negative_prompt, t5_sequence_length)

        # value control: token blocks appended to both CFG branches' text
        if value_controller_inputs is not None and self.value_controllers is not None:
            if not isinstance(value_controller_inputs, list):
                value_controller_inputs = [value_controller_inputs]
            with self._stage("value_encode"):
                value_emb = FA.multi_value_encoder_forward(
                    self.value_controllers, value_controller_inputs)[None].to(dtype)
            prompt_emb = torch.cat([prompt_emb, value_emb], dim=1)
            if nega is not None:
                nega = (torch.cat([nega[0], value_emb], dim=1),) + tuple(nega[1:])

        # the LoRA encoder: a LoRA's tokens on the positive branch only
        if lora_encoder_inputs is not None and self.lora_encoder is not None:
            if not isinstance(lora_encoder_inputs, list):
                lora_encoder_inputs = [lora_encoder_inputs]
            with self._stage("lora_encode"):
                embs = [FA.flux_lora_encoder_forward(
                    self.lora_encoder, convert_flux_lora(
                        item if isinstance(item, dict) else C.load_state_dict(item)))
                        for item in lora_encoder_inputs]
                lora_emb = torch.cat(embs, dim=1) * lora_encoder_scale
            prompt_emb = torch.cat([prompt_emb, lora_emb.to(dtype)], dim=1)

        # InfiniteYou: the projected identity replaces the ControlNet
        # branch's prompt tokens and guidance
        iy = None
        if self.infiniteyou_projector is not None and (
                infinityou_id_image is not None or infinityou_id_emb is not None):
            if infinityou_id_emb is None:
                if self.infiniteyou_face_embedder is None:
                    raise ValueError("infinityou_id_image needs a face embedder "
                                     "(insightface/arcface); pass infinityou_id_emb "
                                     "instead for a precomputed identity")
                infinityou_id_emb = self.infiniteyou_face_embedder(infinityou_id_image)
            with self._stage("infiniteyou_encode"):
                id_emb = FA.infiniteyou_projector_forward(
                    self.infiniteyou_projector,
                    torch.as_tensor(np.asarray(infinityou_id_emb, np.float32)).to(
                        dev, dtype).reshape(1, -1, 512))
            iy = (id_emb, torch.tensor([infinityou_guidance], dtype=torch.float32, device=dev))

        # EliGen: [entity prompts | prompt | image], each entity's text tied
        # to its mask's region
        attn_bias = None
        if eligen_entity_prompts and eligen_entity_masks:
            embs = [self.encode_prompt(p, t5_sequence_length)[0] for p in eligen_entity_prompts]
            prompt_emb = torch.cat(embs + [prompt_emb], dim=1)
            n_img = (height // 16) * (width // 16)
            attn_bias = torch.from_numpy(F.build_entity_attention_bias(
                self._encode_masks(eligen_entity_masks, width, height), embs[0].shape[1],
                n_img)).to(dev)

        # Nexus-Gen: the predicted image embedding replaces the prompt tokens
        text_ids = None
        if self.nexus_gen is not None:
            with self._stage("nexus_gen_encode"):
                if nexus_gen_reference_image is None:
                    embed, _, _ = self.nexus_gen(prompt)
                    prompt_emb = NG.nexus_gen_adapter_forward(
                        self.nexus_gen_generation_adapter, self._tensor(embed)[None])
                    text_ids = np.zeros((prompt_emb.shape[1], 3), np.float64)
                else:
                    embed, ref_embed, grids = self.nexus_gen(prompt, nexus_gen_reference_image)
                    grids = np.asarray(grids)
                    prompt_emb = NG.nexus_gen_merger_forward(
                        self.nexus_gen_editing_adapter, self._tensor(embed)[None], grids[1:2],
                        self._tensor(ref_embed)[None], grids[0:1])
                    text_ids = self._nexus_gen_editing_text_ids(height // 8, width // 8,
                                                                grids[1], grids[0])

        guidance = torch.tensor([embedded_guidance], dtype=torch.float32, device=dev)

        kontext = None
        if kontext_images is not None:
            if not isinstance(kontext_images, list):
                kontext_images = [kontext_images]
            k_lats, k_ids = [], []
            with self._stage("vae_encode_kontext"):
                for im in kontext_images:
                    w0, h0 = ((im.width, im.height) if hasattr(im, "width")
                              else (im.shape[1], im.shape[0]))
                    z = self.encode_image(self._image(im, w0 // 16 * 16, h0 // 16 * 16))
                    k_ids.append(F.prepare_image_ids(1, z.shape[2] // 2, z.shape[3] // 2))
                    k_lats.append(F.patchify(z))
            kontext = (torch.cat(k_lats, dim=1), np.concatenate(k_ids, axis=0))

        # the ControlNet's conditioning: the VAE-encoded control image
        cn_cond = None
        if controlnet_image is not None and self.controlnet is not None:
            with self._stage("vae_encode_controlnet"):
                cn_cond = self.encode_image(self._image(controlnet_image, width, height))

        # IP-Adapter keys and values: the positive branch from the pictures'
        # embedding, the negative from zeros
        ip_posi = ip_nega = None
        if ipadapter_images is not None and self.ipadapter is not None:
            if not isinstance(ipadapter_images, list):
                ipadapter_images = [ipadapter_images]
            with self._stage("ipadapter_encode"):
                emb = torch.as_tensor(np.asarray(self.ipadapter_image_encoder(
                    [im.convert("RGB").resize((384, 384)) for im in ipadapter_images]),
                    np.float32)).to(dev, dtype)
                ip_posi = FC.flux_ipadapter_kv(self.ipadapter, emb)
                if cfg_scale != 1.0:
                    ip_nega = FC.flux_ipadapter_kv(self.ipadapter, torch.zeros_like(emb))

        # Step1x: the Qwen2.5-VL embedding of the prompt and the image, through
        # the connector every step; the image's latent rides the Kontext
        # tokens with f_id 0
        step1x = None
        if step1x_reference_image is not None and self.qwenvl is not None:
            with self._stage("qwenvl_encode"):
                embs, masks = self.qwenvl([prompt], [step1x_reference_image])
            with self._stage("vae_encode_step1x"):
                ref_z = self.encode_image(self._image(step1x_reference_image, width, height))
            ref_tok = F.patchify(ref_z)
            ref_ids = F.prepare_image_ids(0, ref_z.shape[2] // 2, ref_z.shape[3] // 2)
            kontext = (ref_tok, ref_ids) if kontext is None else (
                torch.cat([kontext[0], ref_tok], dim=1),
                np.concatenate([kontext[1], ref_ids], axis=0))
            step1x = (self._tensor(embs[0:1]),
                      torch.as_tensor(np.asarray(masks[0:1])).to(dev))

        tea_cache = None
        if tea_cache_l1_thresh is not None:
            tea_cache = FluxTeaCache(num_inference_steps, tea_cache_l1_thresh)

        steps = range(len(self.scheduler.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        for i in steps:
            t_host = float(self.scheduler.timesteps[i])
            timestep = torch.tensor([t_host], dtype=torch.float32, device=dev)
            with self._stage(f"denoise_step_{i}"):
                if step1x is not None:
                    prompt_emb, pooled = S1.step1x_connector_forward(
                        self.step1x_connector, step1x[0], timestep / 1000.0, step1x[1])
                    text_ids = np.zeros((prompt_emb.shape[1], 3), np.float64)
                lat_in = latents
                if flex_condition is not None:
                    flex = (flex_condition if t_host >= flex_control_stop_timestep
                            else flex_uncondition)
                    lat_in = torch.cat([latents, torch.as_tensor(flex).to(dev, dtype)], dim=1)
                cn = None
                if cn_cond is not None:
                    cn = self._controlnet_res(lat_in, cn_cond, timestep,
                                              prompt_emb if iy is None else iy[0], pooled,
                                              guidance if iy is None else iy[1],
                                              controlnet_processor_id, controlnet_scale)
                v = self._branch(lat_in, timestep, prompt_emb, pooled, guidance, kontext,
                                 tea_cache, cn=cn, ip_kv=ip_posi, ip_scale=ipadapter_scale,
                                 attn_bias=attn_bias, text_ids=text_ids)
                if cfg_scale != 1.0:
                    cn_n = None
                    if cn_cond is not None:
                        cn_n = self._controlnet_res(lat_in, cn_cond, timestep,
                                                    nega[0] if iy is None else iy[0], nega[1],
                                                    guidance if iy is None else iy[1],
                                                    controlnet_processor_id, controlnet_scale)
                    v_nega = self._branch(lat_in, timestep, nega[0], nega[1], guidance,
                                          kontext, None, cn=cn_n, ip_kv=ip_nega)
                    v = v_nega + cfg_scale * (v - v_nega)
                sigma, sigma_next = self.scheduler.sigma_pair(i)
                latents = (latents.float() + v.float() * (sigma_next - sigma)).to(dtype)

        if return_latents:
            return latents
        with self._stage("vae_decode"):
            image = self.decode_image(latents)
        return self.vae_output_to_image(image)

    @staticmethod
    def vae_output_to_image(image):
        """(1, 3, H, W) in [-1, 1] -> a PIL image. Raises on a non-finite
        value rather than writing it out as black pixels."""
        from PIL import Image
        if not bool(torch.isfinite(image).all()):
            raise FloatingPointError("decoded image holds non-finite values")
        arr = image[0].float().cpu().numpy().transpose(1, 2, 0)
        return Image.fromarray(np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8))
