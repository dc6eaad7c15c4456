"""WanVideoPipeline in PyTorch: text-to-video, the VACE edit,
image-to-video, the Wan Fun units, speed control and Wan2.2-Animate.

Counterpart of the T2V/VACE/I2V subset of
`video_styler_tpu/pipelines/wan_video.py`: shape check, seeded noise,
umT5 prompt encode, VACE context (a Wan2.1 VAE encode plus the 64-channel
mask), the image conditioning (`input_image`, and FLF2V's `end_image`: the
CLIP ViT-H/14 features and y = the 4-channel first-frame mask with the VAE
latent of the clip padded with zeros; for Wan2.2 TI2V-5B the first frame's
latent written into the noise and pinned after every step), a denoise loop
with two-pass (or merged) CFG over `wan_dit_forward` with VACE hints, and
the VAE decode (streaming, whole-clip or spatially tiled; the Wan2.1 or
the Wan2.2 VAE). The Fun units (`control_video`: control latents in front
of y; `reference_image`: a one-frame latent through the DiT's `ref_conv`,
its CLIP feature replacing the input image's; `camera_control_direction`:
Plücker latents through the DiT's camera adapter, with a first-frame y),
speed control (`motion_bucket_id` through the motion controller into
t_mod) and Animate (`animate_pose_video` / `animate_face_video` through the
pose/face adapter) are the JAX pipeline's units; `s2v` is its
speech-to-video loop (Wan2.2-S2V-14B: the reference image's latent pinned
at frame 0, wav2vec features injected per block). The loop's options are
the JAX pipeline's: TeaCache step skipping, skip-layer guidance (`slg_blocks`: the listed blocks skipped on the
unconditional rows), the temporal sliding window with ramp blending, a
second expert `dit2` taking over below `switch_DiT_boundary`, and the
multistep schedulers (UniPC, DPM++) in place of the flow-match Euler step.
`load_lora` merges a LoRA into the DiT, `dit2` or the VACE branch, or
keeps it on a hotload stack (`set_lora_scale`, `unload_loras`);
`quantize` (after any LoRA merge) turns the DiT, `dit2` and VACE linears
into int8, fp8 or int4 layers and can route attention through the int8
kernel. Models come from checkpoint files (`from_pretrained`: the official
Wan2.1 DiT (T2V, I2V, FLF2V), VACE, umT5, CLIP and VAE files, the Wan2.2
TI2V-5B DiT and VAE, the Wan Fun DiTs (a reference conv, a camera adapter),
the Wan2.2-Animate adapter, the speed controller (kind
`motion_controller`, which detection cannot tell), the S2V model, and a
Wan2.2 expert as kind `dit2`, read by `utils.ckpt`), from
`convert.from_jax_params`, or
from `from_configs` (random weights).

Multi-GPU (`sharding_ctx`, `from_configs(mesh=...)`): the DiT and VACE
run sequence-parallel and FSDP-sharded over a (dp, fsdp, sp) mesh
(`parallel/`); every rank runs the text encoder and the VAE whole.
`enable_block_streaming` instead runs an expert within a device memory
budget, its other blocks streamed from pinned host memory
(`models.wan_streaming`).

Runs on `cuda` unless constructed with `device="cpu"`. Each stage's wall
time (synchronised with the card) is kept in `stage_times`; on the card,
`stage_peak_bytes` holds `torch.cuda.max_memory_allocated` as each stage
ends (a running maximum: the caller resets it).
"""
from __future__ import annotations

import copy
import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..lora import extract_lora_pairs, merge_lora, merge_lora_pairs, target_linear
from ..models import clip_vit as CV
from ..models import wan_animate as A
from ..models import wan_s2v as S
from ..models import wan_vae as V
from ..models.t5 import UMT5_XXL, T5Config, T5Encoder, convert_t5, init_t5_
from ..models.wan_controllers import (MotionController, convert_motion_controller,
                                      motion_controller_forward, pack_camera_latents,
                                      process_camera_coordinates)
from ..models.wan_dit import (CLIP_DIM, CLIP_TOKENS, WanDiT, WanDiTConfig, assemble_tokens,
                              head, image_inputs, init_weights_, mesh_padded_length,
                              time_embed, unpatchify, unshard_tokens,
                              wan_dit_forward_with_residual)
from ..models.wan_vace import VaceConfig, WanVace
from ..parallel.context import (ShardingContext, axis_size, current_sharding, pad_rows,
                                split_seq, use_sharding)
from ..parallel.fsdp import gathered, materialize_sharded_, shard_params_fsdp
from ..prompters.wan_prompter import WanPrompter
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils import ckpt as C
from ..utils.convert import convert_vace, convert_wan_dit
from ..utils.model_config import ModelConfig


def _preprocess_images(images) -> np.ndarray:
    """PIL list or uint8 (T, H, W, 3) array -> (1, 3, T, H, W) float32 in
    [-1, 1]."""
    if isinstance(images, np.ndarray):
        arr = images.astype(np.float32)
    else:
        arr = np.stack([np.asarray(im, dtype=np.float32) for im in images])
    arr = arr * (2.0 / 255.0) - 1.0
    return arr.transpose(3, 0, 1, 2)[None].astype(np.float32)


def _image_array(image, width: int, height: int) -> np.ndarray:
    """A PIL image or uint8 (H, W, 3) array -> uint8 (height, width, 3),
    resized as the JAX pipeline resizes (PIL's `resize`, imported only when
    the size differs)."""
    if isinstance(image, np.ndarray) and image.shape[:2] == (height, width):
        return image
    from PIL import Image
    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    return np.asarray(image.resize((width, height)))


def generate_noise(shape, seed: Optional[int] = None) -> torch.Tensor:
    """Seeded Gaussian noise drawn on the CPU in float32 (bit-identical with
    the JAX pipeline's noise); the caller moves it to the device."""
    gen = None if seed is None else torch.Generator("cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32)


class TeaCache:
    """Per-branch step skipper: skip the trunk while the accumulated
    polynomial-rescaled relative change of t_mod stays under a threshold."""

    COEFFS = {
        "Wan2.1-T2V-1.3B": [-5.21862437e+04, 9.23041404e+03, -5.28275948e+02, 1.36987616e+01, -4.99875664e-02],
        "Wan2.1-T2V-14B": [-3.03318725e+05, 4.90537029e+04, -2.65530556e+03, 5.87365115e+01, -3.15583525e-01],
        "Wan2.1-I2V-14B-480P": [2.57151496e+05, -3.54229917e+04, 1.40286849e+03, -1.35890334e+01, 1.32517977e-01],
        "Wan2.1-I2V-14B-720P": [8.10705460e+03, 2.13393892e+03, -3.72934672e+02, 1.66203073e+01, -4.17769401e-02],
    }

    def __init__(self, num_inference_steps: int, rel_l1_thresh: float, model_id: str):
        if model_id not in self.COEFFS:
            raise ValueError(f"{model_id} is not a supported TeaCache model id "
                             f"(choose from {', '.join(self.COEFFS)})")
        self.num_inference_steps = num_inference_steps
        self.step = 0
        self.accumulated = 0.0
        self.rel_l1_thresh = rel_l1_thresh
        self.coefficients = self.COEFFS[model_id]
        self.previous_t_mod = None
        self.previous_residual = None

    def check(self, t_mod) -> bool:
        """True -> skip the trunk this step and reuse the cached residual."""
        t_mod = t_mod.float().cpu().numpy()
        if self.step == 0 or self.step == self.num_inference_steps - 1:
            should_calc = True
            self.accumulated = 0.0
        else:
            rel = float(np.abs(t_mod - self.previous_t_mod).mean()
                        / np.abs(self.previous_t_mod).mean())
            self.accumulated += float(np.polyval(self.coefficients, rel))
            should_calc = self.accumulated >= self.rel_l1_thresh
            if should_calc:
                self.accumulated = 0.0
        self.previous_t_mod = t_mod
        self.step = (self.step + 1) % self.num_inference_steps
        return not should_calc

    def store(self, residual):
        self.previous_residual = residual


class WanVideoPipeline:
    """Public call mirrors the JAX pipeline's __call__ (T2V/VACE subset)."""

    def __init__(self, device=None, dtype=torch.bfloat16):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scheduler = FlowMatchScheduler(shift=5.0, sigma_min=0.0,
                                            extra_one_step=True)
        self.prompter = WanPrompter()
        self.dit: Optional[WanDiT] = None
        self.vace: Optional[WanVace] = None
        # the second expert (Wan2.2 A14B: the high-noise DiT) and its VACE
        self.dit2: Optional[WanDiT] = None
        self.vace2: Optional[WanVace] = None
        self.vae: Optional[V.WanVAE] = None
        self.image_encoder: Optional[CV.ClipVit] = None
        self.animate: Optional[A.WanAnimateAdapter] = None
        self.motion_controller: Optional[MotionController] = None
        self.s2v_model: Optional[S.WanS2V] = None
        # the architectures `_attach` builds checkpoint files into (the JAX
        # pipeline's: umT5-XXL and the Wan2.1 VAE; a Wan2.2 VAE file gets
        # `WAN22_VAE`, a CLIP file `CLIP_VIT_H_14`)
        self.t5_cfg: T5Config = UMT5_XXL
        self.vae_cfg: V.WanVAEConfig = V.WAN21_VAE
        self._lora_stacks = {}
        # block streamers by expert ("dit", "dit2"): `enable_block_streaming`
        self._streamers = {}
        # the mesh the DiT runs under (`parallel.ShardingContext`): each
        # forward enters it, unless the caller has entered one already
        self.sharding_ctx = None
        self.stage_times: List[Tuple[str, float]] = []
        self.stage_peak_bytes: List[Tuple[str, int]] = []

    @classmethod
    def from_configs(cls, dit_cfg: Optional[WanDiTConfig], vace_cfg: Optional[VaceConfig],
                     t5_cfg: T5Config, vae_cfg, tokenizer: Callable,
                     text_len: int = 512, seed: int = 0, device=None,
                     dtype=torch.bfloat16,
                     clip_cfg: Optional[CV.ClipVitConfig] = None,
                     mesh=None) -> "WanVideoPipeline":
        """Random weights drawn on the device from one seeded generator, with
        the JAX init's std; the DiT (none with `dit_cfg` None), VACE, T5
        and CLIP tower (with `clip_cfg`) in `dtype`, the VAE (a
        `WanVAE38Config` builds the Wan2.2 one) in fp32.

        mesh (`parallel.make_mesh`): the pipeline runs under it; with fsdp >
        1 the DiT and VACE are FSDP-sharded as they are drawn, each rank
        keeping its shards of the same values (`parallel.fsdp.
        materialize_sharded_`), so no rank holds a whole copy."""
        pipe = cls(device=device, dtype=dtype)
        pipe.t5_cfg, pipe.vae_cfg = t5_cfg, vae_cfg
        dev = pipe.device
        gen = torch.Generator(dev).manual_seed(seed)
        vae_cls = V.WanVAE38 if isinstance(vae_cfg, V.WanVAE38Config) else V.WanVAE
        with torch.device("meta"):
            dit = None if dit_cfg is None else WanDiT(dit_cfg, dtype=dtype)
            vace = None if vace_cfg is None else WanVace(vace_cfg, dtype=dtype)
            t5 = T5Encoder(t5_cfg, dtype=dtype)
            vae = vae_cls(vae_cfg, dtype=torch.float32)
            clip = None if clip_cfg is None else CV.ClipVit(clip_cfg, dtype=dtype)
        if mesh is not None:
            pipe.sharding_ctx = ShardingContext(mesh)
        for name, module in (("dit", dit), ("vace", vace)):
            if module is None:
                continue
            if mesh is None or pipe.sharding_ctx.axis_size("fsdp") == 1:
                module = init_weights_(module.to_empty(device=dev), gen)
            else:
                template = copy.deepcopy(module)
                module = materialize_sharded_(shard_params_fsdp(module, mesh), template,
                                              init_weights_, gen, dev)
            setattr(pipe, name, module.eval())
        t5 = init_t5_(t5.to_empty(device=dev), gen).eval()
        pipe.vae = V.init_wan_vae_(vae.to_empty(device=dev), gen).eval()
        if clip is not None:
            pipe.image_encoder = CV.init_clip_vit_(clip.to_empty(device=dev), gen).eval()
        pipe.prompter = WanPrompter(tokenizer, text_len, t5)
        return pipe

    @classmethod
    def from_pretrained(cls, model_configs: List[ModelConfig],
                        tokenizer_path: Optional[str] = None, device=None,
                        dtype=torch.bfloat16) -> "WanVideoPipeline":
        """Build the pipeline from checkpoint files, as the JAX pipeline's
        `from_pretrained` does: each source's files (shards of one model
        together) are detected by their keys and attached; the tokenizer
        comes from `tokenizer_path`, else from files beside the
        checkpoints. Tensors go from the files to `device` in their stored
        dtype and are cast there (`utils.ckpt.read_tensors`)."""
        pipe = cls(device=device, dtype=dtype)
        for mc in model_configs:
            sd = C.load_state_dict_files(mc.paths(), lazy=True)
            pipe._attach(mc.model_kind or C.detect_model_kind(sd), sd)
        if tokenizer_path is not None:
            pipe.prompter.fetch_tokenizer(tokenizer_path)
        else:
            pipe.prompter.fetch_tokenizer_near(
                [p for mc in model_configs for p in mc.paths()])
        return pipe

    def _attach(self, kind: str, sd):
        """Build the `kind` model from a (lazy) reference state dict onto
        the pipeline's device. A combined file splits by the `vace` prefix."""
        if kind in ("dit", "dit2", "dit+vace"):
            dit_sd = {k: v for k, v in sd.items() if not k.startswith("vace")}
            cfg = C.detect_wan_dit_config(dit_sd)
            setattr(self, "dit2" if kind == "dit2" else "dit",
                    C.build_module(WanDiT, cfg, convert_wan_dit(dit_sd, cfg),
                                   self.device, self.dtype))
            if kind == "dit+vace":
                self._attach("vace", {k: v for k, v in sd.items()
                                      if k.startswith("vace")})
        elif kind == "vace":
            vcfg = C.detect_vace_config(sd)
            if vcfg is None:
                # keys under a leading `vace.` are not read (nor by the JAX
                # converter): ROADMAP Queue 3
                raise KeyError("vace_blocks.0.before_proj.weight: no VACE block "
                               "under the names the converter reads")
            self.vace = C.build_module(WanVace, vcfg, convert_vace(sd, vcfg),
                                       self.device, self.dtype)
        elif kind == "vae":
            # the JAX pipeline keeps its Wan2.1 config for any VAE file
            # (ROADMAP Queue 3); the port builds a Wan2.2 file as one
            if V.is_wan22_vae(sd):
                self.vae_cfg = V.WAN22_VAE
            cls = V.WanVAE38 if isinstance(self.vae_cfg, V.WanVAE38Config) else V.WanVAE
            self.vae = C.build_module(cls, self.vae_cfg, V.convert_wan_vae(sd),
                                      self.device, torch.float32)
        elif kind == "clip":
            self.image_encoder = C.build_module(
                CV.ClipVit, CV.CLIP_VIT_H_14, CV.convert_clip_vit(sd, CV.CLIP_VIT_H_14),
                self.device, self.dtype)
        elif kind == "t5":
            self.prompter.text_encoder = C.build_module(
                T5Encoder, self.t5_cfg, convert_t5(sd, self.t5_cfg), self.device,
                self.dtype)
        elif kind == "animate":
            # the JAX pipeline nests the whole file into its adapter: a file
            # that holds the DiT beside the adapter (the official
            # Wan2.2-Animate-14B one) leaves no DiT (ROADMAP Queue 3)
            self.animate = A.build_wan_animate(sd, self.device, self.dtype)
        elif kind == "motion_controller":
            mc = convert_motion_controller(sd)
            dim, freq_dim = mc["fc1.weight"].shape
            self.motion_controller = C.build_module(
                lambda cfg, dtype: MotionController(*cfg, dtype=dtype), (dim, freq_dim),
                mc, self.device, self.dtype)
        elif kind == "s2v":
            # the JAX pipeline builds the default (14B) config whatever the
            # file holds (ROADMAP Queue 3); read when called, as there
            cfg = S.WanS2VConfig()
            self.s2v_model = C.build_module(S.WanS2V, cfg, S.convert_wan_s2v(sd, cfg),
                                            self.device, self.dtype)
        elif kind in C.UNPORTED_KINDS:
            raise C.unported(kind)
        else:
            # a wav2vec file included: the JAX pipeline holds no tower and
            # raises here; `models.audio_features` loads it (ROADMAP Queue 3)
            raise ValueError(f"unknown model kind {kind}")

    def load_lora(self, target: str = "dit", path: Optional[str] = None,
                  state_dict=None, alpha: float = 1.0, hotload: bool = False):
        """Merge a LoRA (a checkpoint file or a state dict) into the `dit`,
        `dit2` or `vace` weights, as the JAX pipeline's `load_lora` does.

        hotload=True keeps it on the target's LoRA stack instead, beside one
        device copy of the pristine weights it touches: `set_lora_scale`
        rescales a LoRA of the stack and `unload_loras` restores the base,
        without reading any file again."""
        if target not in ("dit", "dit2", "vace") or getattr(self, target) is None:
            raise ValueError(f"no {target!r} model to merge a LoRA into")
        if state_dict is None:
            state_dict = C.load_state_dict(path)
        if not hotload:
            merge_lora(getattr(self, target), state_dict, alpha=alpha)
            return
        module = getattr(self, target)
        pairs = {t: (a.to(self.device), b.to(self.device))
                 for t, (a, b) in extract_lora_pairs(state_dict).items()}
        if not pairs:
            raise ValueError("no LoRA A/B pairs found in state dict")
        stack = self._lora_stacks.setdefault(target, {"base": {}, "loras": []})
        for t in pairs:
            # a weight no LoRA of the stack has touched yet is still pristine
            if t not in stack["base"]:
                stack["base"][t] = target_linear(module, t).weight.detach().clone()
        stack["loras"].append([pairs, alpha])
        self._reapply_loras(target)

    @torch.no_grad()
    def _restore_base(self, target: str):
        module = getattr(self, target)
        for t, w in self._lora_stacks[target]["base"].items():
            target_linear(module, t).weight.copy_(w)

    def _reapply_loras(self, target: str):
        """The pristine weights, then every LoRA of the stack at its scale."""
        self._restore_base(target)
        for pairs, alpha in self._lora_stacks[target]["loras"]:
            if alpha != 0.0:
                merge_lora_pairs(getattr(self, target), pairs, alpha=alpha)

    def set_lora_scale(self, target: str = "dit", alpha: float = 1.0,
                       index: int = -1):
        """Rescale a hotloaded LoRA (no checkpoint IO)."""
        self._lora_stacks[target]["loras"][index][1] = alpha
        self._reapply_loras(target)

    def unload_loras(self, target: str = "dit"):
        """Restore the pristine weights of `target` and drop its stack."""
        if target in self._lora_stacks:
            self._restore_base(target)
            del self._lora_stacks[target]

    def quantize(self, mode: str = "int8", targets: tuple = ("dit", "dit2", "vace"),
                 quantize_attention: bool = False):
        """Quantize the DiT, `dit2` and VACE linear weights in place (the
        JAX pipeline's `quantize`; the analogue of the reference's fp8
        path). Must run after any LoRA merge or hotload, for every expert:
        a hotload stack keeps its target's pristine weights, which a later
        re-apply would copy back over the quantised layers. The output
        head, the modulation tables and the time embedding stay in high
        precision; targets the pipeline does not hold are skipped.

        Modes: "int8" (w8a8), "fp8" (e4m3 storage), "int4" (w4a8,
        0.5 byte/param), "int4_g128" (w4a16 group scales).

        quantize_attention also routes every attention call, cross-attention
        included, through the int8 kernel K6 (process-wide:
        `ops.attention.set_quantized_attention`)."""
        from ..ops.quant import quantize_params
        keep = ("head", "modulation", "time_embedding")

        def pred(path, layer):
            return not any(k in path for k in keep)

        for t in targets:
            model = getattr(self, t, None)
            if model is not None:
                quantize_params(model, mode=mode, predicate=pred)
        if quantize_attention:
            from ..ops.attention import set_quantized_attention
            set_quantized_attention(True)

    def shard(self, mesh, ulysses: bool = True) -> "WanVideoPipeline":
        """Run under `mesh` (`parallel.make_mesh`): the DiT(s) and VACE
        branch(es) FSDP-sharded over its fsdp dim (after any LoRA merge),
        the sequence split over sp (Ulysses, or the ring with ulysses
        False). umT5, CLIP and the VAE stay whole on every rank."""
        if self._streamers:
            raise NotImplementedError("a block-streamed pipeline cannot be sharded over a "
                                      "mesh (the JAX package defines no such run)")
        for name in ("dit", "dit2", "vace", "vace2"):
            if getattr(self, name) is not None:
                shard_params_fsdp(getattr(self, name), mesh)
        self.sharding_ctx = ShardingContext(mesh, ulysses=ulysses)
        return self

    def enable_block_streaming(self, mode: str = "int8", hbm_budget_gb: float = 13.5,
                               target: str = "dit", **kw) -> dict:
        """Run a DiT bigger than the card's memory budget, as the JAX
        pipeline's `enable_block_streaming` does: as many of the expert's
        blocks as fit `hbm_budget_gb` stay resident (int8 by default), the
        rest and the VACE branch that the expert runs (`_expert_vace`) wait
        in pinned host memory and are copied per forward on a side stream
        (`models.wan_streaming.WanBlockStreamer`; **kw: its
        `resident_blocks`, `prefetch_depth`, `overlap`, ...). Must run after
        any LoRA merge (a hotload stack of the target is dropped) and after
        `quantize`, whose int8 leaves pass through. The resident modules
        are released, but for a VACE that a resident expert still runs: a
        resident `dit2` without a `vace2` keeps the shared `vace` (as
        `vace2`). Returns the streamer's `plan_summary()`.

        Animate, the Fun camera and reference and the speed controller need
        the resident path (ValueError); a mesh cannot be combined with
        streaming (NotImplementedError)."""
        import gc
        from ..models.wan_streaming import WanBlockStreamer
        if self.sharding_ctx is not None:
            raise NotImplementedError("block streaming under a mesh is not defined (the "
                                      "JAX package streams to one device only)")
        if target not in ("dit", "dit2"):
            raise ValueError(f"unknown streaming target {target!r}")
        model = getattr(self, target)
        if model is None:
            raise ValueError(f"no params loaded for target {target!r}")
        vace = self._expert_vace(target)
        streamer = WanBlockStreamer(model, vace, mode=mode,
                                    hbm_budget_gb=hbm_budget_gb, device=self.device, **kw)
        self._streamers[target] = streamer
        # the resident copies go: the modules and any pristine weights a
        # hotload stack keeps of them
        setattr(self, target, None)
        self._lora_stacks.pop(target, None)
        if target == "dit":
            if self.dit2 is not None and self.vace2 is None:
                self.vace2 = self.vace      # the resident dit2's VACE stays
            self.vace = None
            self._lora_stacks.pop("vace", None)
        else:
            self.vace2 = None               # the shared `vace` stays with `dit`
        del model, vace
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return streamer.plan_summary()

    @contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.stage_peak_bytes.append(
                (name, torch.cuda.max_memory_allocated(self.device)))
        self.stage_times.append((name, time.perf_counter() - t0))

    # ---------------- conditioning units ----------------

    def check_resize(self, height, width, num_frames):
        """Spatial sizes to a multiple of 16, frame count to 4k+1."""
        div = self.vae.cfg.upsampling_factor * 2
        if height % div != 0:
            height = (height + div - 1) // div * div
        if width % div != 0:
            width = (width + div - 1) // div * div
        if num_frames % 4 != 1:
            num_frames = (num_frames + 3) // 4 * 4 + 1
        return height, width, num_frames

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        return self.prompter.encode_prompt(prompt, dtype=self.dtype)

    @torch.no_grad()
    def encode_video(self, video_np: np.ndarray, tiled: bool = True,
                     tile_size=(30, 52), tile_stride=(15, 26)) -> torch.Tensor:
        video = torch.from_numpy(np.ascontiguousarray(video_np, np.float32))
        return V.encode(self.vae, video.to(self.device), tiled=tiled,
                        tile_size=tile_size, tile_stride=tile_stride).to(self.dtype)

    @torch.no_grad()
    def decode_video(self, latents: torch.Tensor, tiled: bool = True,
                     tile_size=(30, 52), tile_stride=(15, 26)) -> torch.Tensor:
        return V.decode(self.vae, latents.float(), tiled=tiled,
                        tile_size=tile_size, tile_stride=tile_stride)

    def build_vace_context(self, vace_video, vace_video_mask,
                           vace_reference_image, height, width, num_frames,
                           **tiler):
        """Inactive/reactive latents + the 64-channel downsampled mask ->
        the 96-channel VACE context."""
        if vace_video is None and vace_video_mask is None and vace_reference_image is None:
            return None
        if vace_video is None:
            video = np.zeros((1, 3, num_frames, height, width), np.float32)
        else:
            video = _preprocess_images(vace_video)
        if vace_video_mask is None:
            mask = np.ones_like(video)
        else:
            mask = (_preprocess_images(vace_video_mask) + 1.0) / 2.0
        inactive = video * (1 - mask)
        reactive = video * mask
        # one batch-2 VAE pass (batch entries are independent)
        both = self.encode_video(np.concatenate([inactive, reactive], axis=0), **tiler)
        latents = torch.cat([both[0:1], both[1:2]], dim=1)

        # mask -> (1, 64, T_lat, H/8, W/8): 8x8 shuffle, nearest-exact in time
        m = mask[0, 0]
        T, H, W = m.shape
        m = m.reshape(T, H // 8, 8, W // 8, 8).transpose(0, 2, 4, 1, 3)
        m = m.reshape(1, T, 64, H // 8, W // 8).transpose(0, 2, 1, 3, 4)
        t_lat = (T + 3) // 4
        idx = np.minimum(np.floor((np.arange(t_lat) + 0.5) * (T / t_lat)).astype(int), T - 1)
        mask_lat = torch.from_numpy(np.ascontiguousarray(m[:, :, idx])).to(
            self.device, self.dtype)

        if vace_reference_image is not None:
            refs = (vace_reference_image if isinstance(vace_reference_image, list)
                    else [vace_reference_image])
            ref_lat = self.encode_video(_preprocess_images(refs), **tiler)
            ref_lat = torch.cat([ref_lat, torch.zeros_like(ref_lat)], dim=1)
            latents = torch.cat([ref_lat, latents], dim=2)
            mask_lat = torch.cat([torch.zeros_like(mask_lat[:, :, :ref_lat.shape[2]]),
                                  mask_lat], dim=2)
        return torch.cat([latents, mask_lat], dim=1)

    @torch.no_grad()
    def encode_clip(self, image_np: np.ndarray) -> torch.Tensor:
        """(1, 3, H, W) float32 in [-1, 1] -> (1, 257, 1280) CLIP features."""
        return CV.encode_image(self.image_encoder, torch.from_numpy(image_np).to(self.device),
                               dtype=self.dtype)

    def build_image_conditioning(self, input_image, end_image, num_frames, height,
                                 width, **tiler):
        """The I2V units: the CLIP features of the first image (and of
        FLF2V's end image, concatenated), and y = [the 4-channel temporal
        mask | the VAE latent of the clip that holds the image(s) and zeros].
        (None, None) without an input image or for a DiT without image
        input; each part only where the DiT takes it."""
        cfg = self._expert_cfg("dit")
        if input_image is None or cfg is None or not cfg.has_image_input:
            return None, None
        img_np = _preprocess_images([_image_array(input_image, width, height)])[:, :, 0]
        end_np = None if end_image is None else _preprocess_images(
            [_image_array(end_image, width, height)])[:, :, 0]
        clip_feature = None
        if self.image_encoder is not None and cfg.require_clip_embedding:
            with self._stage("clip_encode"):
                clip_feature = self.encode_clip(img_np)
                if end_np is not None and cfg.has_image_pos_emb:
                    clip_feature = torch.cat([clip_feature, self.encode_clip(end_np)], dim=1)
        y = None
        if cfg.require_vae_embedding:
            with self._stage("vae_encode_image"):
                y = self._image_y(img_np, end_np, num_frames, height, width, **tiler)
        return clip_feature, y

    def _image_y(self, img_np, end_np, num_frames, height, width, **tiler) -> torch.Tensor:
        """y of the I2V units: [the 4-channel temporal mask (ones on the
        first frame, and on the last with an end image) | the VAE latent of
        the clip that holds the (1, 3, H, W) image(s) and zeros]."""
        up = self.vae.cfg.upsampling_factor
        msk = np.ones((1, num_frames, height // up, width // up), np.float32)
        msk[:, 1:] = 0
        vae_input = np.zeros((1, 3, num_frames, height, width), np.float32)
        vae_input[:, :, 0] = img_np[0]
        if end_np is not None:
            vae_input[:, :, -1] = end_np[0]
            msk[:, -1:] = 1
        msk = np.concatenate([np.repeat(msk[:, 0:1], 4, axis=1), msk[:, 1:]], axis=1)
        msk = msk.reshape(1, msk.shape[1] // 4, 4, height // up, width // up)
        msk = np.ascontiguousarray(msk.transpose(0, 2, 1, 3, 4))
        lat = self.encode_video(vae_input, **tiler)
        return torch.cat([torch.from_numpy(msk).to(self.device, self.dtype), lat], dim=1)

    def build_fun_control(self, control_video, num_frames, height, width,
                          clip_feature, y, **tiler):
        """Fun Control: the control video's latents in front of y's last
        `in_dim - 2z` channels; without image conditioning, zero CLIP
        features and a zero y of those channels."""
        with self._stage("vae_encode_control"):
            control = self.encode_video(_preprocess_images(control_video), **tiler)
        up = self.vae.cfg.upsampling_factor
        y_dim = self._expert_cfg("dit").in_dim - control.shape[1] - self.vae.cfg.z_dim
        if clip_feature is None or y is None:
            clip_feature = torch.zeros((1, CLIP_TOKENS, CLIP_DIM), dtype=self.dtype,
                                       device=self.device)
            y = torch.zeros((1, y_dim, (num_frames - 1) // 4 + 1, height // up, width // up),
                            dtype=self.dtype, device=self.device)
        else:
            y = y[:, -y_dim:]
        return clip_feature, torch.cat([control, y], dim=1)

    def build_fun_reference(self, reference_image, height, width):
        """Fun Reference: the image's one-frame latent (for the DiT's
        `ref_conv`) and, where the DiT takes CLIP rows and a tower is
        loaded, its CLIP feature."""
        ref_np = _preprocess_images([_image_array(reference_image, width, height)])
        with self._stage("vae_encode_reference"):
            reference_latents = self.encode_video(ref_np, tiled=False)
        clip_feature = None
        if self.image_encoder is not None and self._expert_cfg("dit").require_clip_embedding:
            with self._stage("clip_encode_reference"):
                clip_feature = self.encode_clip(ref_np[:, :, 0])
        return reference_latents, clip_feature

    def build_fun_camera_control(self, direction, speed, origin, input_image, num_frames,
                                 height, width, latents_shape, **tiler):
        """Fun Camera: the packed Plücker latents (1, 24, T_lat, H, W) for the
        DiT's camera adapter, and y: the input image's latent on the first
        frame of zeros, or, where the DiT takes other than z channels of y,
        the I2V units' [mask | the padded clip's latent]."""
        if input_image is None:
            raise ValueError("camera control requires input_image")
        with self._stage("camera_control"):
            plucker = process_camera_coordinates(direction, num_frames, height, width,
                                                 speed, origin)
            control_camera = torch.from_numpy(pack_camera_latents(plucker, num_frames)).to(
                self.device, self.dtype)
            img_np = _preprocess_images([_image_array(input_image, width, height)])
            y = torch.zeros(latents_shape, dtype=self.dtype, device=self.device)
            y[:, :, :1] = self.encode_video(img_np, tiled=False)
            if y.shape[1] != self._expert_cfg("dit").in_dim - self.vae.cfg.z_dim:
                y = self._image_y(img_np[:, :, 0], None, num_frames, height, width, **tiler)
        return control_camera, y

    def build_animate_inputs(self, pose_video, face_video, **tiler):
        """Animate: the pose video's latents and the face crops resized to
        the adapter's face size, (1, 3, T, size, size) in [-1, 1]."""
        with self._stage("vae_encode_pose"):
            pose = self.encode_video(_preprocess_images(pose_video), **tiler)
        size = self.animate.cfg.face_size
        faces = _preprocess_images([_image_array(im, size, size) for im in face_video])
        return pose, torch.from_numpy(faces).to(self.device, self.dtype)

    # ---------------- model functions ----------------

    def _expert(self, which: str) -> WanDiT:
        return self.dit if which == "dit" else self.dit2

    def _expert_vace(self, which: str) -> Optional[WanVace]:
        """The resident VACE branch expert `which` runs: `vace` for "dit";
        `vace2` for "dit2", else the shared `vace`."""
        if which == "dit" or self.vace2 is None:
            return self.vace
        return self.vace2

    def _has_vace(self, which: str) -> bool:
        """Whether expert `which`, resident or streamed, runs a VACE branch."""
        streamer = self._streamers.get(which)
        if streamer is not None:
            return streamer.vace_cfg is not None
        return self._expert_vace(which) is not None

    def _expert_cfg(self, which: str) -> Optional[WanDiTConfig]:
        """Expert `which`'s config, resident or block-streamed; None where
        the pipeline holds no such expert."""
        model = self._streamers.get(which) or (self.dit if which == "dit" else self.dit2)
        return None if model is None else model.cfg

    def _skip(self, which, latents, timestep, residual, y=None, control_camera=None,
              reference_latents=None):
        """TeaCache replay: the tokens as the full forward assembles them
        (the latents with y, the camera features, the reference frame's
        tokens in front) + the cached residual + head, the reference's rows
        dropped. Under sp the residual is this rank's rows of the padded
        sequence: the tokens are padded and split alike, and the head's rows
        gathered and unpadded, as the full forward does."""
        dit = self._expert(which)
        cfg = dit.cfg
        t, _ = time_embed(dit, timestep)
        latents, _ = image_inputs(dit, latents, None, y=y)
        tokens, grid, n_ref = assemble_tokens(dit, latents, control_camera,
                                              reference_latents)
        s = tokens.shape[1]
        tokens = split_seq(pad_rows(tokens, mesh_padded_length(s)))
        if t.dim() == 3:
            t = split_seq(pad_rows(t, tokens.shape[1] * axis_size("sp")))
        out = unshard_tokens(head(dit, tokens + residual, t), s)[:, n_ref:]
        return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)

    def _branch_forward(self, which, vace, latents, timestep, context,
                        vace_context, vace_scale, tea_cache: Optional[TeaCache],
                        rope_indices=None, layer_gate=None, clip_feature=None, y=None,
                        animate_inputs=None, motion_bucket_id=None, control_camera=None,
                        reference_latents=None):
        """One DiT forward of expert `which` ("dit" or "dit2"), or a TeaCache
        replay of its last residual. The Animate inputs exclude the Fun
        reference and camera (a ValueError, as in the JAX pipeline); the
        replay, like the JAX pipeline's, takes neither the pose tokens nor
        the speed term. It runs under `self.sharding_ctx` unless the caller
        entered a context (`parallel.use_sharding`); under one with sp > 1
        the forward and the replay pad, split and unpad the sequence as
        `models.wan_dit` says, each rank caching its own residual rows."""
        if animate_inputs is not None and (reference_latents is not None
                                           or control_camera is not None):
            raise ValueError("animate conditioning cannot combine with "
                             "FunReference/FunCameraControl")
        streamer = self._streamers.get(which)
        if streamer is not None:
            return self._streamed_forward(streamer, latents, timestep, context, vace_context,
                                          vace_scale, tea_cache, rope_indices, layer_gate,
                                          clip_feature, y, animate_inputs, motion_bucket_id,
                                          control_camera, reference_latents)
        ctx = self.sharding_ctx if current_sharding() is None else current_sharding()
        dit = self._expert(which)
        with use_sharding(ctx), gathered(dit):
            if tea_cache is not None:
                _, t_mod = time_embed(dit, timestep)
                if tea_cache.check(t_mod) and tea_cache.previous_residual is not None:
                    return self._skip(which, latents, timestep, tea_cache.previous_residual,
                                      y, control_camera, reference_latents)
            t_mod_add = None
            if motion_bucket_id is not None:
                mc = motion_controller_forward(self.motion_controller, motion_bucket_id)
                t_mod_add = mc.reshape(mc.shape[0], 6, dit.cfg.dim)
            animate = None if animate_inputs is None else (self.animate,) + tuple(animate_inputs)
            v, residual = wan_dit_forward_with_residual(
                dit, latents, timestep, context, rope_indices=rope_indices, vace=vace,
                vace_context=vace_context, vace_scale=vace_scale, layer_gate=layer_gate,
                clip_feature=clip_feature, y=y, control_camera=control_camera,
                reference_latents=reference_latents, t_mod_add=t_mod_add, animate=animate)
            if tea_cache is not None:
                tea_cache.store(residual)
            return v

    @staticmethod
    def _streamed_forward(streamer, latents, timestep, context, vace_context, vace_scale,
                          tea_cache, rope_indices, layer_gate, clip_feature, y,
                          animate_inputs, motion_bucket_id, control_camera,
                          reference_latents):
        """`_branch_forward` through a block streamer, with the JAX
        pipeline's refusals and its TeaCache check and replay. Skip-layer
        guidance's gate runs in the streamed walk (the JAX pipeline refuses
        it under streaming)."""
        if (animate_inputs is not None or motion_bucket_id is not None
                or control_camera is not None or reference_latents is not None):
            raise ValueError("block streaming supports the T2V/VACE/I2V/editor paths; "
                             "per-layer adapter conditioning needs the resident path")
        if tea_cache is not None:
            t_mod = streamer.t_mod_only(timestep)
            if tea_cache.check(t_mod) and tea_cache.previous_residual is not None:
                return streamer.skip_forward(latents, timestep, context,
                                             tea_cache.previous_residual, y)
        v, _, residual = streamer.forward(latents, timestep, context, vace_context,
                                          vace_scale, clip_feature, y,
                                          rope_indices=rope_indices,
                                          want_residual=tea_cache is not None,
                                          layer_gate=layer_gate)
        if tea_cache is not None:
            tea_cache.store(residual)
        return v

    def _forward_all_branches(self, which, vace, latents, timestep, ctx_posi,
                              ctx_nega, vace_context, vace_scale, cfg_scale,
                              tc_posi, tc_nega, cfg_merge=False, slg_gate=None,
                              clip_feature=None, y=None, animate_inputs=None,
                              motion_bucket_id=None, control_camera=None,
                              reference_latents=None):
        """One denoise velocity: CFG by two passes or one merged batch (the
        image conditioning, the reference latents and the Animate inputs,
        like the VACE context, repeated for both rows; the camera latents
        and the motion id broadcast).

        slg_gate: optional (num_layers,) keep-gate of skip-layer guidance,
        applied to the unconditional rows only: under cfg_merge the merged
        gate is ones for the posi rows and slg_gate for the nega rows; in
        two passes only the nega pass is gated."""
        image = dict(clip_feature=clip_feature, y=y, animate_inputs=animate_inputs,
                     motion_bucket_id=motion_bucket_id, control_camera=control_camera,
                     reference_latents=reference_latents)
        if cfg_scale == 1.0 or ctx_nega is None:
            return self._branch_forward(which, vace, latents, timestep, ctx_posi,
                                        vace_context, vace_scale, tc_posi, **image)
        b = latents.shape[0]
        if cfg_merge:
            # one batched forward; the per-branch TeaCaches are not used
            image2 = dict(image)
            for k in ("clip_feature", "y", "reference_latents"):
                image2[k] = None if image[k] is None else torch.cat([image[k]] * 2)
            if animate_inputs is not None:
                image2["animate_inputs"] = tuple(torch.cat([a, a]) for a in animate_inputs)
            vc2 = None if vace_context is None else torch.cat([vace_context] * 2)
            gate2 = None
            if slg_gate is not None:
                g = slg_gate[:, None]
                gate2 = torch.cat([torch.ones_like(g).expand(-1, b),
                                   g.expand(-1, b)], dim=1)
            v2 = self._branch_forward(which, vace, torch.cat([latents, latents]),
                                      timestep, torch.cat([ctx_posi, ctx_nega]),
                                      vc2, vace_scale, None, layer_gate=gate2, **image2)
            v_posi, v_nega = v2[:1], v2[1:]
        else:
            v_posi = self._branch_forward(which, vace, latents, timestep, ctx_posi,
                                          vace_context, vace_scale, tc_posi, **image)
            gate1 = None if slg_gate is None else slg_gate[:, None].expand(-1, b)
            v_nega = self._branch_forward(which, vace, latents, timestep, ctx_nega,
                                          vace_context, vace_scale, tc_nega,
                                          layer_gate=gate1, **image)
        return v_nega + cfg_scale * (v_posi - v_nega)

    @staticmethod
    def _temporal_ramp(length, left_bound, right_bound, border) -> np.ndarray:
        """The sliding window's 1-D blend ramp (0.5-shifted) over `length`
        latent frames; an edge of the clip gets no ramp."""
        x = np.ones((length,), np.float32)
        if border > 0:
            if not left_bound:
                x[:border] = (np.arange(border) + 0.5) / border
            if not right_bound:
                x[-border:] = ((np.arange(border) + 0.5) / border)[::-1]
        return x

    def _sliding_window_velocity(self, window_size, window_stride, fwd_fn,
                                 latents, y=None, vace_context=None):
        """Velocity over windows of `window_size` latent frames every
        `window_stride`, blended with ramps in fp32 on the device. A window
        whose predecessor already reaches the end is skipped; y and
        vace_context are sliced with the latents (their temporal axes line
        up with them)."""
        T = latents.shape[2]
        value = torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
        weight = torch.zeros((1, 1, T, 1, 1), dtype=torch.float32, device=latents.device)
        for t0 in range(0, T, window_stride):
            if t0 - window_stride >= 0 and t0 - window_stride + window_size >= T:
                continue
            t1 = min(t0 + window_size, T)
            y_w = None if y is None else y[:, :, t0:t1]
            vc_w = None if vace_context is None else vace_context[:, :, t0:t1]
            v = fwd_fn(latents[:, :, t0:t1], y_w, vc_w).float()
            mask = torch.from_numpy(self._temporal_ramp(
                t1 - t0, t0 == 0, t1 == T, window_size - window_stride)
            ).to(latents.device)[None, None, :, None, None]
            value[:, :, t0:t1] += v * mask
            weight[:, :, t0:t1] += mask
        return value / weight

    def _slg_gate(self, which, slg_blocks, slg_start, slg_end, i, n_steps):
        """(num_layers,) fp32 keep-gate of step i, or None outside
        [slg_start, slg_end) of the step progress. Block indices past the
        stack are ignored."""
        if not slg_blocks or not slg_start <= i / n_steps < slg_end:
            return None
        n_layers = self._expert_cfg(which).num_layers
        g = np.ones((n_layers,), np.float32)
        g[[b for b in slg_blocks if b < n_layers]] = 0.0
        return torch.from_numpy(g).to(self.device)

    # ---------------- speech to video ----------------

    @torch.no_grad()
    def s2v(self, prompt: str, ref_image, audio_input, negative_prompt: str = "",
            num_frames: int = 80, height: int = 448, width: int = 832,
            cfg_scale: float = 4.5, num_inference_steps: int = 40,
            sigma_shift: float = 5.0, motion_latents=None, pose_video=None,
            seed: Optional[int] = None, tiled: bool = False,
            tile_size: Tuple[int, int] = (30, 52), tile_stride: Tuple[int, int] = (15, 26),
            return_latents: bool = False):
        """Speech-to-video, as the JAX pipeline's `s2v`: the reference image
        (PIL or uint8 (H, W, 3)) encoded to one latent frame in front of the
        noise and pinned there after every step; `pose_video` (frames)
        through the VAE into the model's `cond_encoder`; two-pass CFG; the
        Euler update in fp32.

        audio_input: (1, num_audio_layers, audio_dim, num_frames) wav2vec
        states (`models.audio_features.extract_audio_features`). As in the
        JAX pipeline nothing checks that its audio frames equal the latent
        frames (they do when num_frames is a multiple of 4), and
        `motion_latents` reaches a forward that drops them (the
        reference's default): ROADMAP Queue 3."""
        if axis_size("sp") > 1 or (self.sharding_ctx is not None
                                   and self.sharding_ctx.axis_size("sp") > 1):
            raise NotImplementedError("s2v is not yet under a mesh with sp > 1 (ROADMAP "
                                      "item 8): its blocks need the whole token grid")
        if self.s2v_model is None:
            raise RuntimeError("no S2V model attached")
        self.stage_times = []
        self.stage_peak_bytes = []
        tiler = dict(tiled=tiled, tile_size=tile_size, tile_stride=tile_stride)
        self.scheduler.set_timesteps(num_inference_steps, shift=sigma_shift)
        with self._stage("vae_encode_reference"):
            ref_np = _preprocess_images([_image_array(ref_image, width, height)])
            ref_lat = self.encode_video(ref_np, **tiler)
        z = self.vae.cfg.z_dim
        up = self.vae.cfg.upsampling_factor
        t_lat = (num_frames - 1) // 4 + 1
        noise = generate_noise((1, z, t_lat, height // up, width // up), seed=seed)
        latents = torch.cat([ref_lat, noise.to(self.device, self.dtype)], dim=2)
        pose_cond = None
        if pose_video is not None:
            with self._stage("vae_encode_pose"):
                pose_cond = self.encode_video(_preprocess_images(pose_video), **tiler)
        with self._stage("t5"):
            ctx_posi = self.encode_prompt(prompt)
            ctx_nega = self.encode_prompt(negative_prompt) if cfg_scale != 1.0 else None
        audio = torch.as_tensor(audio_input).to(self.device, self.dtype)

        def fwd(timestep, ctx):
            return S.wan_s2v_forward(self.s2v_model, latents, timestep, ctx, audio,
                                     motion_latents=motion_latents, pose_cond=pose_cond)
        for i in range(len(self.scheduler.timesteps)):
            with self._stage(f"denoise_step_{i}"):
                timestep = torch.tensor([float(self.scheduler.timesteps[i])],
                                        dtype=torch.float32, device=self.device)
                v = fwd(timestep, ctx_posi)
                if cfg_scale != 1.0:
                    v_nega = fwd(timestep, ctx_nega)
                    v = v_nega + cfg_scale * (v - v_nega)
                sigma, sigma_next = self.scheduler.sigma_pair(i)
                latents = (latents.float() + v.float() * (sigma_next - sigma)).to(self.dtype)
                latents[:, :, :1] = ref_lat
        latents = latents[:, :, 1:]
        if return_latents:
            return latents
        with self._stage("vae_decode"):
            video = self.decode_video(latents, **tiler)
        return self.vae_output_to_video(video)

    # ---------------- main call ----------------

    @torch.no_grad()
    def __call__(self, prompt: str, negative_prompt: str = "",
                 input_image=None, end_image=None,
                 input_video=None, denoising_strength: float = 1.0,
                 vace_video=None, vace_video_mask=None,
                 vace_reference_image=None, vace_scale: float = 1.0,
                 animate_pose_video=None, animate_face_video=None,
                 control_video=None, reference_image=None,
                 camera_control_direction: Optional[str] = None,
                 camera_control_speed: float = 1 / 54, camera_control_origin=None,
                 motion_bucket_id: Optional[float] = None,
                 seed: Optional[int] = None, height: int = 480,
                 width: int = 832, num_frames: int = 81,
                 cfg_scale: float = 5.0, cfg_merge: bool = False,
                 switch_DiT_boundary: float = 0.875,
                 num_inference_steps: int = 50, sigma_shift: float = 5.0,
                 tiled: bool = True, tile_size: Tuple[int, int] = (30, 52),
                 tile_stride: Tuple[int, int] = (15, 26),
                 sliding_window_size: Optional[int] = None,
                 sliding_window_stride: Optional[int] = None,
                 tea_cache_l1_thresh: Optional[float] = None,
                 tea_cache_model_id: str = "",
                 slg_blocks: Optional[Tuple[int, ...]] = None,
                 slg_start: float = 0.0, slg_end: float = 1.0,
                 return_latents: bool = False):
        """Frames in as a PIL list or uint8 (T, H, W, 3) arrays, images
        (`input_image`, FLF2V's `end_image`, the Fun `reference_image`) as
        PIL or uint8 (H, W, 3); out as a uint8 (T, H, W, 3) array, or the
        latents with return_latents. The units apply in the JAX pipeline's
        order: image conditioning, Fun control, Fun reference (its CLIP
        feature replaces the input image's), Fun camera (its y replaces the
        others'), the motion id, the TI2V first frame, Animate (both its
        videos and an adapter needed, else it is not applied)."""
        self.stage_times = []
        self.stage_peak_bytes = []
        height, width, num_frames = self.check_resize(height, width, num_frames)
        self.scheduler.set_timesteps(num_inference_steps,
                                     denoising_strength=denoising_strength,
                                     shift=sigma_shift)
        tiler = dict(tiled=tiled, tile_size=tile_size, tile_stride=tile_stride)
        length = (num_frames - 1) // 4 + 1
        ref_count = 0
        if vace_reference_image is not None:
            ref_count = (len(vace_reference_image)
                         if isinstance(vace_reference_image, list) else 1)
            length += ref_count
        z = self.vae.cfg.z_dim
        up = self.vae.cfg.upsampling_factor
        noise = generate_noise((1, z, length, height // up, width // up), seed=seed)
        if ref_count:
            noise = torch.cat([noise[:, :, -ref_count:], noise[:, :, :-ref_count]], dim=2)
        noise = noise.to(self.device, self.dtype)  # rounded before any mixing

        if input_video is not None:
            with self._stage("vae_encode_input"):
                input_latents = self.encode_video(_preprocess_images(input_video),
                                                  **tiler)
                if vace_reference_image is not None:
                    refs = (vace_reference_image if isinstance(vace_reference_image, list)
                            else [vace_reference_image])
                    ref_lat = self.encode_video(_preprocess_images(refs), tiled=False)
                    input_latents = torch.cat([ref_lat, input_latents], dim=2)
            latents = self.scheduler.add_noise(
                input_latents.float(), noise.float(),
                self.scheduler.timesteps[0]).to(self.dtype)
        else:
            latents = noise

        with self._stage("t5"):
            ctx_posi = self.encode_prompt(prompt)
            ctx_nega = self.encode_prompt(negative_prompt) if cfg_scale != 1.0 else None
        with self._stage("vae_encode"):
            vace_context = self.build_vace_context(
                vace_video, vace_video_mask, vace_reference_image, height,
                width, num_frames, **tiler)
        if vace_context is not None and not all(
                self._has_vace(w) for w in ("dit", "dit2") if self._expert_cfg(w) is not None):
            raise ValueError("VACE inputs were given but the pipeline has no "
                             "VACE model")
        clip_feature, y = self.build_image_conditioning(
            input_image, end_image, num_frames, height, width, **tiler)
        if control_video is not None:
            clip_feature, y = self.build_fun_control(control_video, num_frames, height,
                                                     width, clip_feature, y, **tiler)
        reference_latents = None
        if reference_image is not None:
            reference_latents, clip_ref = self.build_fun_reference(reference_image,
                                                                   height, width)
            if clip_ref is not None:
                clip_feature = clip_ref
        control_camera = None
        if camera_control_direction is not None:
            control_camera, y = self.build_fun_camera_control(
                camera_control_direction, camera_control_speed, camera_control_origin,
                input_image, num_frames, height, width, latents.shape, **tiler)
        if motion_bucket_id is not None:
            if self.motion_controller is None:
                raise RuntimeError("motion_bucket_id given but no motion "
                                   "controller attached")
            motion_bucket_id = torch.tensor([motion_bucket_id], dtype=torch.float32,
                                            device=self.device)
        # TI2V-5B: the first frame's latent written into the noise and
        # pinned after every step (each token still gets the one (1,)
        # timestep, as in the JAX pipeline: ROADMAP Queue 3)
        first_frame_latents = None
        if input_image is not None and self._expert_cfg("dit").fuse_vae_embedding_in_latents:
            with self._stage("vae_encode_image"):
                img_np = _preprocess_images([_image_array(input_image, width, height)])
                first_frame_latents = self.encode_video(img_np, **tiler)
            latents[:, :, 0:1] = first_frame_latents
        animate_inputs = None
        if (animate_pose_video is not None and animate_face_video is not None
                and self.animate is not None):
            animate_inputs = self.build_animate_inputs(animate_pose_video,
                                                       animate_face_video, **tiler)
        fun = dict(motion_bucket_id=motion_bucket_id, reference_latents=reference_latents)

        tc_posi = tc_nega = None
        if tea_cache_l1_thresh is not None:
            tc_posi = TeaCache(num_inference_steps, tea_cache_l1_thresh, tea_cache_model_id)
            tc_nega = TeaCache(num_inference_steps, tea_cache_l1_thresh, tea_cache_model_id)

        which, vace = "dit", self._expert_vace("dit")
        n_steps = len(self.scheduler.timesteps)
        for i in range(n_steps):
            with self._stage(f"denoise_step_{i}"):
                t_host = float(self.scheduler.timesteps[i])
                if (which == "dit" and self._expert_cfg("dit2") is not None and t_host
                        < switch_DiT_boundary * self.scheduler.num_train_timesteps):
                    which = "dit2"
                    vace = self._expert_vace("dit2")
                timestep = torch.tensor([t_host], dtype=torch.float32,
                                        device=self.device)
                slg_gate = self._slg_gate(which, slg_blocks, slg_start, slg_end,
                                          i, n_steps)
                if sliding_window_size is not None and sliding_window_stride is not None:
                    # the windows take the reference latents and the motion
                    # id, not the camera or Animate inputs (as in the JAX
                    # pipeline)
                    def fwd(lat_w, y_w, vc_w):
                        return self._forward_all_branches(
                            which, vace, lat_w, timestep, ctx_posi, ctx_nega, vc_w,
                            vace_scale, cfg_scale, None, None, cfg_merge=cfg_merge,
                            slg_gate=slg_gate, clip_feature=clip_feature, y=y_w, **fun)
                    v = self._sliding_window_velocity(
                        sliding_window_size, sliding_window_stride, fwd, latents,
                        y=y, vace_context=vace_context)
                else:
                    v = self._forward_all_branches(
                        which, vace, latents, timestep, ctx_posi, ctx_nega,
                        vace_context, vace_scale, cfg_scale, tc_posi, tc_nega,
                        cfg_merge=cfg_merge, slg_gate=slg_gate,
                        clip_feature=clip_feature, y=y, animate_inputs=animate_inputs,
                        control_camera=control_camera, **fun)
                if hasattr(self.scheduler, "sigma_pair"):
                    sigma, sigma_next = self.scheduler.sigma_pair(i)
                    latents = (latents.float() + v.float() * (sigma_next - sigma)
                               ).to(self.dtype)
                else:
                    # multistep solvers (UniPC, DPM++) keep their history on
                    # the device in fp32
                    latents = self.scheduler.step(v.float(), t_host,
                                                  latents.float()).to(self.dtype)
                if first_frame_latents is not None:
                    latents[:, :, 0:1] = first_frame_latents
        if ref_count:
            latents = latents[:, :, ref_count:]
        if return_latents:
            return latents
        with self._stage("vae_decode"):
            video = self.decode_video(latents, **tiler)
        return self.vae_output_to_video(video)

    @staticmethod
    def vae_output_to_video(video: torch.Tensor) -> np.ndarray:
        """(1, 3, T, H, W) in [-1, 1] -> uint8 (T, H, W, 3). Raises on a
        non-finite value rather than writing it out as black pixels."""
        if not bool(torch.isfinite(video).all()):
            raise FloatingPointError("decoded video holds non-finite values")
        arr = video[0].float().cpu().numpy().transpose(1, 2, 3, 0)
        return np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)
