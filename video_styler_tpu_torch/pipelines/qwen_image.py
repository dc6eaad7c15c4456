"""Qwen-Image text-to-image, edit and adapters, in PyTorch.

Counterpart of `video_styler_tpu/pipelines/qwen_image.py`
(`QwenImagePipeline.__call__` :272-443): flow matching with the exponential
shift that follows the image's token count and a terminal shift of 0.02,
Qwen2.5-VL prompt conditioning (the chat template, the first 34 rows
dropped), two-pass CFG, and the Wan2.1 VAE on one frame. Options:
img2img (`input_image`, `denoising_strength`), inpaint pinning
(`inpaint_mask`: the unmasked region held to the re-noised input after each
step), Qwen-Image-Edit (`edit_image`, one image or several: through the
vision tower into the prompt's embedding, first 64 rows dropped, and as
extra latents, more RoPE frames), `context_image` (an extra latent), EliGen
(entity prompts ahead of the prompt and an attention bias on the positive
pass: the exact `sdpa`), and block-wise ControlNets
(`blockwise_controlnet_inputs`, each active between its `start` and `end`
fractions of the schedule; the inpaint variant zeroes the masked pixels and
appends the inverse mask as a latent channel). The output goes through
FLUX's `vae_output_to_image`.

The text encoder: `fetch_text_encoder` builds the Qwen2.5-VL towers from a
checkpoint (backend "native") with a tokenizer callable or a tokenizer path
(read through `transformers`, imported when called); `use_text_encoder`
takes a built `QwenVL`. A request without one raises a RuntimeError naming
what it lacks (the JAX runner never fetches one, and its request calls
None). The `transformers` backend (JAX's host fallback to HF's model) is
not ported: it raises `NotImplementedError`.

Runs on `cuda` unless constructed with `device="cpu"`. Each stage's wall
time (synchronised with the card) is kept in `stage_times`, and on the card
the running peak of `torch.cuda.max_memory_allocated` in `stage_peak_bytes`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import qwen_image_controlnet as QC
from ..models import qwen_image_dit as D
from ..models import qwen_image_vae as QV
from ..models import wan_vae as WV
from ..models.qwen_vl_embedder import QwenVL
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils import ckpt as C
from ..models.flux_dit import init_flux_dit_
from .flux_image import FluxImagePipeline
from .wan_video import _preprocess_images, generate_noise

T2I_TEMPLATE = ("<|im_start|>system\nDescribe the image by detailing the "
                "color, shape, size, texture, quantity, text, spatial "
                "relationships of the objects and background:<|im_end|>\n"
                "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n")
T2I_DROP_IDX = 34
EDIT_TEMPLATE = (
    "<|im_start|>system\nDescribe the key features of the input image "
    "(color, shape, size, texture, objects, background), then explain how "
    "the user's text instruction should alter or modify the image. Generate "
    "a new image that meets the user's requirements while maintaining "
    "consistency with the original input where appropriate.<|im_end|>\n"
    "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>{}"
    "<|im_end|>\n<|im_start|>assistant\n")
EDIT_TEMPLATE_MULTI = (
    "<|im_start|>system\nDescribe the key features of the input image "
    "(color, shape, size, texture, objects, background), then explain how "
    "the user's text instruction should alter or modify the image. Generate "
    "a new image that meets the user's requirements while maintaining "
    "consistency with the original input where appropriate.<|im_end|>\n"
    "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n")
EDIT_IMG_BLOCK = "Picture {}: <|vision_start|><|image_pad|><|vision_end|>"
EDIT_DROP_IDX = 64
BACKENDS = ("native", "transformers")


@dataclass
class ControlNetInput:
    """One block-wise ControlNet's input: which ControlNet, its scale, the
    schedule fractions it is active between (start >= progress >= end), the
    control image and, for the inpaint variant, the mask."""
    controlnet_id: int = 0
    scale: float = 1.0
    start: float = 1.0
    end: float = 0.0
    image: object = None
    inpaint_mask: object = None
    processor_id: Optional[str] = None


class QwenImagePipeline:

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(
            sigma_min=0.0, sigma_max=1.0, extra_one_step=True, exponential_shift=True,
            exponential_shift_mu=0.8, shift_terminal=0.02)
        self.dit: Optional[D.QwenImageDiT] = None
        self.dit_cfg: D.QwenImageDiTConfig = D.QWEN_IMAGE
        self.vae: Optional[WV.WanVAE] = None
        self.vae_cfg: WV.WanVAEConfig = WV.WAN21_VAE
        self.text_encoder: Optional[Callable] = None   # prompt -> (emb, mask)
        self._vl: Optional[QwenVL] = None
        self.blockwise_controlnets: Optional[List[QC.QwenBlockwiseControlNet]] = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    # ---------------- loading ----------------

    @classmethod
    def from_configs(cls, dit_cfg: D.QwenImageDiTConfig, vl: Optional[QwenVL],
                     vae_cfg: WV.WanVAEConfig = WV.WAN21_VAE, seed: int = 0, device=None,
                     dtype=torch.bfloat16) -> "QwenImagePipeline":
        """Random DiT (in `dtype`) and VAE (fp32) drawn on the device from one
        seeded generator; `vl` the text encoder (or None)."""
        pipe = cls(device=device, dtype=dtype)
        pipe.dit_cfg, pipe.vae_cfg = dit_cfg, vae_cfg
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)
        with torch.device("meta"):
            dit = D.QwenImageDiT(dit_cfg, dtype=dtype)
            vae = WV.WanVAE(vae_cfg, dtype=torch.float32)
        # FLUX's init: linear weights N(0, 1/in), biases 0, norm weights 1
        pipe.dit = init_flux_dit_(dit.to_empty(device=dev), gen).eval()
        pipe.vae = WV.init_wan_vae_(vae.to_empty(device=dev), gen).eval()
        if vl is not None:
            pipe.use_text_encoder(vl)
        return pipe

    @classmethod
    def from_pretrained(cls, dit_paths=None, vae_path=None, device=None,
                        dtype=torch.bfloat16) -> "QwenImagePipeline":
        """The DiT (the reference's names, `|`-free list of shards, the
        QWEN_IMAGE config) and the VAE (diffusers names) from files; no text
        encoder (`fetch_text_encoder`)."""
        pipe = cls(device=device, dtype=dtype)
        if dit_paths:
            sd = C.load_state_dict_files(dit_paths if isinstance(dit_paths, list)
                                         else [dit_paths], lazy=True)
            pipe.dit = C.build_module(D.QwenImageDiT, pipe.dit_cfg,
                                      D.convert_qwen_image_dit(sd, pipe.dit_cfg),
                                      pipe.device, dtype)
        if vae_path:
            pipe.vae = C.build_module(
                WV.WanVAE, pipe.vae_cfg,
                QV.convert_qwen_image_vae(C.load_state_dict(vae_path, lazy=True)),
                pipe.device, torch.float32)
        return pipe

    def load_blockwise_controlnet(self, path=None, state_dict=None):
        """Append a block-wise ControlNet (its block count and widths from the
        file), addressed by `ControlNetInput.controlnet_id`."""
        sd = state_dict if state_dict is not None else C.load_state_dict(path, lazy=True)
        cfg = QC.blockwise_cn_config_for(sd)
        model = C.build_module(QC.QwenBlockwiseControlNet, cfg,
                               QC.convert_qwen_blockwise_controlnet(sd, cfg), self.device,
                               self.dtype)
        self.blockwise_controlnets = (self.blockwise_controlnets or []) + [model]

    def fetch_text_encoder(self, model_path, tokenizer, backend: str = "native"):
        """The Qwen2.5-VL towers from `model_path` (a file or list of shards,
        HF names; the vision tower where the file has `visual.*` weights),
        with `tokenizer` a callable or a tokenizer directory.

        backend="transformers": HF's `Qwen2_5_VLForConditionalGeneration`
        from the model directory `model_path`, on the pipeline's device and
        dtype; a prompt's embedding is `hidden_states[-1]` (the final norm
        applied) without its first T2I_DROP_IDX rows, as the native path
        computes it. Text prompts only: the edit's vision path is native."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown text-encoder backend {backend!r}; one of {BACKENDS}")
        if backend == "transformers":
            self._use_transformers_encoder(model_path, tokenizer)
            return
        self.use_text_encoder(QwenVL.from_files(model_path, tokenizer, self.device,
                                                self.dtype))

    def _use_transformers_encoder(self, model_dir: str, tokenizer):
        from transformers import AutoTokenizer, Qwen2_5_VLForConditionalGeneration
        if isinstance(tokenizer, str):
            tokenizer = AutoTokenizer.from_pretrained(tokenizer)
        model = Qwen2_5_VLForConditionalGeneration.from_pretrained(
            model_dir, dtype=self.dtype).to(self.device).eval()
        self._vl = None

        @torch.no_grad()
        def encode(prompt: str):
            out = tokenizer([T2I_TEMPLATE.format(prompt)], max_length=4096 + T2I_DROP_IDX,
                            padding=True, truncation=True, return_tensors="np")
            ids, mask = (torch.from_numpy(np.asarray(out[k], np.int64)).to(self.device)
                         for k in ("input_ids", "attention_mask"))
            hidden = model(input_ids=ids, attention_mask=mask,
                           output_hidden_states=True).hidden_states[-1]
            return (hidden[:, T2I_DROP_IDX:].to(self.dtype),
                    mask[:, T2I_DROP_IDX:].to(torch.int32))

        self.text_encoder = encode

    def use_text_encoder(self, vl: QwenVL):
        """Encode prompts with `vl` (the T2I template, 34 rows dropped)."""
        self._vl = vl

        def encode(prompt: str):
            txt = T2I_TEMPLATE.format(prompt)
            ids = vl.tokenizer([txt], max_length=4096 + T2I_DROP_IDX, padding=True,
                               truncation=True, return_tensors="np")["input_ids"][0]
            emb = vl.encode_ids(ids)[:, T2I_DROP_IDX:].to(self.dtype)
            return emb, torch.ones((1, emb.shape[1]), dtype=torch.int32, device=emb.device)

        self.text_encoder = encode

    # ---------------- helpers ----------------

    _stage = FluxImagePipeline._stage

    def encode_prompt(self, prompt: str):
        """-> (emb (1, L, text_dim), mask (1, L))."""
        if self.text_encoder is None:
            raise RuntimeError("the Qwen-Image pipeline has no text encoder: call "
                               "fetch_text_encoder(model_path, tokenizer) (image_gen: "
                               "--text_encoder_path and --tokenizer_path)")
        with self._stage("text_encode"):
            return self.text_encoder(prompt)

    @staticmethod
    def _resize_vl(image, target_area: int = 384 * 384):
        """The several-image edit's resize of each image for the vision tower."""
        ratio = image.size[0] / image.size[1]
        width = math.sqrt(target_area * ratio)
        height = width / ratio
        return image.resize((round(width / 32) * 32, round(height / 32) * 32))

    def encode_prompt_edit(self, prompt: str, edit_images, _cache=None):
        """Qwen-Image-Edit's prompt: the edit image(s) through the vision
        tower into the prompt's embedding (64 rows dropped). -> (emb, mask,
        vision cache); the cache serves the negative prompt's call."""
        vl = self._vl
        if vl is None:
            raise RuntimeError("the edit prompt needs the native Qwen2.5-VL towers "
                               "(fetch_text_encoder(..., backend='native'))")
        if len(edit_images) == 1:
            txt = EDIT_TEMPLATE.format(prompt)
            imgs = list(edit_images)
        else:
            base = "".join(EDIT_IMG_BLOCK.format(i + 1) for i in range(len(edit_images)))
            txt = EDIT_TEMPLATE_MULTI.format(base + prompt)
            imgs = [self._resize_vl(im) for im in edit_images]
        if _cache is None:
            with self._stage("vision_encode"):
                _cache = vl.embed_images(imgs)
        img_emb, grids = _cache
        ids = vl.tokenizer(vl._expand_image_pads(txt, grids), return_tensors="np")["input_ids"][0]
        with self._stage("text_encode_edit"):
            emb = vl.encode_ids(ids, img_emb, grids)[:, EDIT_DROP_IDX:].to(self.dtype)
        return emb, torch.ones((1, emb.shape[1]), dtype=torch.int32, device=emb.device), _cache

    @torch.no_grad()
    def encode_image(self, image_np: np.ndarray):
        z = QV.qwen_vae_encode(self.vae, torch.from_numpy(image_np).to(self.device,
                                                                       torch.float32))
        return z.to(self.dtype)

    @torch.no_grad()
    def decode_image(self, latents):
        return QV.qwen_vae_decode(self.vae, latents.to(self.device, torch.float32))

    # ---------------- EliGen ----------------

    def _entity_attention_bias(self, n_img_tokens: int, seq_lens, entity_masks, height: int,
                               width: int):
        """Each entity's prompt sees (and is seen by) its own region only, and
        no other entity's prompt. -> (1, 1, S, S) fp32 (0 / fp32 minimum)."""
        total = sum(seq_lens) + n_img_tokens
        allow = np.ones((total, total), bool)
        cum = np.cumsum([0] + list(seq_lens))
        img0 = cum[-1]
        for i, m in enumerate(entity_masks):
            m = np.asarray(m, np.float32)
            c = m.shape[0]
            patched = m.reshape(c, height // 16, 2, width // 16, 2).transpose(1, 3, 0, 2, 4)
            img_mask = patched.reshape((height // 16) * (width // 16), -1).sum(axis=-1) > 0
            img_mask = np.tile(img_mask, n_img_tokens // img_mask.shape[0])
            allow[cum[i]:cum[i + 1], img0:] = img_mask[None, :]
            allow[img0:, cum[i]:cum[i + 1]] = img_mask[:, None]
        n = len(entity_masks)
        for i in range(n):
            for j in range(n):
                if i != j:
                    allow[cum[i]:cum[i + 1], cum[j]:cum[j + 1]] = False
        bias = np.where(allow, 0.0, float(np.finfo(np.float32).min)).astype(np.float32)
        return torch.from_numpy(bias)[None, None].to(self.device)

    def _prepare_eligen(self, entity_prompts, entity_masks, prompt_emb, height: int,
                        width: int, n_img_tokens: int):
        """-> ([entity prompts | prompt] embedding, attention bias, lengths)."""
        embs, lens = [], []
        for p in entity_prompts:
            e, m = self.encode_prompt(p)
            embs.append(e)
            lens.append(int(m.sum()))
        embs.append(prompt_emb)
        lens.append(prompt_emb.shape[1])
        joint = torch.cat([e[:, :n] for e, n in zip(embs, lens)], dim=1)
        masks = [(np.asarray(img.convert("L").resize((width // 8, height // 8)), np.float32)
                  / 255.0 > 0.5)[None] for img in entity_masks]
        return joint, self._entity_attention_bias(n_img_tokens, lens, masks, height,
                                                  width), lens

    def _encode_controlnet_inputs(self, inputs, width: int, height: int):
        """-> [(ControlNet, control tokens, input)], each control image VAE-
        encoded (the inpaint variant's masked pixels zeroed and its inverse
        mask appended as a latent channel) and lifted once."""
        from PIL import Image
        out = []
        for ci in inputs:
            img = ci.image.resize((width, height))
            if ci.inpaint_mask is not None:
                m = np.asarray(ci.inpaint_mask.convert("L").resize((width, height)),
                               np.float32) / 255.0
                arr = np.array(img)
                arr[m > 0.5] = 0
                img = Image.fromarray(arr)
            cond_lat = self.encode_image(_preprocess_images([img])[:, :, 0])
            if ci.inpaint_mask is not None:
                m8 = np.asarray(ci.inpaint_mask.convert("L").resize((width // 8, height // 8)),
                                np.float32) / 255.0
                cond_lat = torch.cat([cond_lat, torch.from_numpy(1.0 - m8).to(
                    self.device, cond_lat.dtype)[None, None]], dim=1)
            cn = self.blockwise_controlnets[ci.controlnet_id]
            out.append((cn, QC.qwen_blockwise_cn_process(cn, cond_lat), ci))
        return out

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        cfg_scale: float = 4.0,
        input_image=None,
        denoising_strength: float = 1.0,
        inpaint_mask=None,
        height: int = 1328,
        width: int = 1328,
        seed: Optional[int] = None,
        num_inference_steps: int = 30,
        exponential_shift_mu: Optional[float] = None,
        eligen_entity_prompts: Optional[List[str]] = None,
        eligen_entity_masks: Optional[List] = None,
        edit_image=None,
        context_image=None,
        blockwise_controlnet_inputs: Optional[List[ControlNetInput]] = None,
        progress_bar_cmd=None,
        return_latents: bool = False,
    ):
        self.stage_times = []
        self.stage_peak_bytes = []
        dev, dtype = self.device, self.dtype
        height = (height + 15) // 16 * 16
        width = (width + 15) // 16 * 16
        sch = self.scheduler
        sch.set_timesteps(num_inference_steps, denoising_strength=denoising_strength,
                          dynamic_shift_len=(height // 16) * (width // 16),
                          exponential_shift_mu=exponential_shift_mu)

        noise = generate_noise((1, 16, height // 8, width // 8), seed=seed).to(dev, dtype)
        input_latents = None
        if input_image is not None:
            with self._stage("vae_encode"):
                input_latents = self.encode_image(
                    _preprocess_images([input_image.resize((width, height))])[:, :, 0])
            latents = sch.add_noise(input_latents.float(), noise.float(),
                                    sch.timesteps[0]).to(dtype)
        else:
            latents = noise

        mask_lat = None
        if inpaint_mask is not None and input_latents is not None:
            m = np.asarray(inpaint_mask.convert("L").resize((width // 8, height // 8)),
                           np.float32) / 255.0
            mask_lat = torch.from_numpy(m[None, None]).to(dev)

        edit_images = None
        if edit_image is not None:
            edit_images = edit_image if isinstance(edit_image, list) else [edit_image]
        if edit_images is not None and self._vl is not None and self._vl.vision is not None:
            posi_emb, _, vl_cache = self.encode_prompt_edit(prompt, edit_images)
            nega = (self.encode_prompt_edit(negative_prompt, edit_images, _cache=vl_cache)[:2]
                    if cfg_scale != 1.0 else None)
        else:
            posi_emb, _ = self.encode_prompt(prompt)
            nega = self.encode_prompt(negative_prompt) if cfg_scale != 1.0 else None

        # edit and context images -> extra latents (more RoPE frames)
        extra = None
        if edit_images is not None or context_image is not None:
            extra = []
            with self._stage("vae_encode_extra"):
                for im in edit_images or ():
                    extra.append(self.encode_image(_preprocess_images(
                        [im.resize((im.width // 16 * 16, im.height // 16 * 16))])[:, :, 0]))
                if context_image is not None:
                    extra.append(self.encode_image(_preprocess_images(
                        [context_image.resize((width, height))])[:, :, 0]))

        bcn = None
        if blockwise_controlnet_inputs:
            with self._stage("vae_encode_controlnet"):
                bcn = self._encode_controlnet_inputs(blockwise_controlnet_inputs, width,
                                                     height)

        bias = None
        txt_len_posi = posi_emb.shape[1]
        if eligen_entity_prompts and eligen_entity_masks:
            posi_emb, bias, _ = self._prepare_eligen(
                eligen_entity_prompts, eligen_entity_masks, posi_emb, height, width,
                (height // 16) * (width // 16))
            txt_len_posi = posi_emb.shape[1]

        steps = range(len(sch.timesteps))
        if progress_bar_cmd is not None:
            steps = progress_bar_cmd(steps)
        n_steps = len(sch.timesteps)
        for i in steps:
            t = torch.tensor([float(sch.timesteps[i]) / 1000.0], dtype=torch.float32,
                             device=dev)
            with self._stage(f"denoise_step_{i}"):
                cn = None
                if bcn is not None:
                    progress = (n_steps - 1 - i) / max(n_steps - 1, 1)
                    cn = [(model, cond, ci.scale if ci.start + 1e-4 >= progress
                           >= ci.end - 1e-4 else 0.0) for model, cond, ci in bcn]
                v = D.qwen_image_dit_forward(self.dit, latents, t, posi_emb,
                                             txt_seq_len=txt_len_posi, extra_latents=extra,
                                             attn_bias=bias, blockwise_cn=cn)
                if nega is not None:
                    v_nega = D.qwen_image_dit_forward(self.dit, latents, t, nega[0],
                                                      extra_latents=extra, blockwise_cn=cn)
                    v = v_nega + cfg_scale * (v - v_nega)
                sigma, sigma_next = sch.sigma_pair(i)
                latents = (latents.float() + v.float() * (sigma_next - sigma)).to(dtype)
                if mask_lat is not None:
                    # inpaint: the unmasked region pinned to the re-noised input
                    if i + 1 < n_steps:
                        ref = sch.add_noise(input_latents.float(), noise.float(),
                                            sch.timesteps[i + 1]).to(dtype)
                    else:
                        ref = input_latents
                    latents = (mask_lat * latents.float()
                               + (1 - mask_lat) * ref.float()).to(dtype)

        if return_latents:
            return latents
        with self._stage("vae_decode"):
            image = self.decode_image(latents)
        return FluxImagePipeline.vae_output_to_image(image)
