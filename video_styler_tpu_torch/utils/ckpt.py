"""Checkpoint loading: safetensors/pth files to lazy state dicts, structural
detection of what a file holds, and reading the tensors onto the device.

Counterpart of `video_styler_tpu/utils/ckpt.py`. The JAX loader turns every
tensor into fp32 numpy before anything reaches the device; here a file's
tensors stay in their stored dtype and are read once, when a module takes
them (`read_tensors`):

- `.safetensors`: the header gives each tensor's dtype, shape and byte
  range (`safetensors_io.read_header`);
- `.pth`/`.bin`: `torch.load(mmap=True, weights_only=True)` gives the
  names, dtypes and shapes without reading the data, and the zip's record
  table where each storage's bytes lie.

A tensor's bytes then go from the file into their destination with
`os.preadv`, four 64 MiB reads at a time: on the card through pinned
staging buffers whose copies run while the next chunks are read, on the
CPU straight into the tensor. Nothing maps the file, so the host holds no
more of it than the staging buffers (a mapping's pages count in the
process's resident set).

Detection (`detect_model_kind`, `detect_wan_dit_config`,
`detect_vace_config`) reads keys and shapes only. `load_model` builds the
kinds the port has modules for: `dit` (T2V, I2V, FLF2V, TI2V), `vace`,
`dit+vace`, the Wan2.1 and Wan2.2 `vae`, `t5`, the CLIP image encoder
(`clip`), the Wan2.2-Animate adapter, the wav2vec2 tower (`wav2vec`),
the FLUX DiT (`flux_dit`, detected by its BFL layout), FLUX's adapters
(`flux_controlnet`, `flux_ipadapter`, `flux_infiniteyou_projector`,
`flux_value_encoder`, `flux_lora_encoder`) and the SD3 DiT (`sd3_dit`);
every other kind raises `NotImplementedError`, naming the ROADMAP item that ports it where
one does (the S2V model, like the JAX loader's, is
built by the pipeline's `from_pretrained` only).
"""
from __future__ import annotations

import collections
import hashlib
import os
import struct
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.wan_dit import WanDiTConfig
from ..models.wan_vace import VACE_1_3B, VACE_14B, VaceConfig
from ..safetensors_io import read_header

# bytes read from checkpoint files by `read_tensors` since import (the
# loaders' counterpart of the kernels' launch counters)
BYTES_READ = 0

_STAGING_BYTES = 64 << 20
_READ_WORKERS = 4


class LazyTensor:
    """A tensor of a checkpoint file whose bytes have not been read: its
    shape and dtype, and the file and byte offset where its row-major bytes
    begin."""

    __slots__ = ("shape", "dtype", "path", "offset")

    def __init__(self, shape, dtype: torch.dtype, path: str, offset: int):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.path = path
        self.offset = offset

    @property
    def nbytes(self) -> int:
        return self.shape.numel() * self.dtype.itemsize

    def reshape(self, *shape) -> "LazyTensor":
        """The same bytes under another row-major shape."""
        shape = torch.Size(shape[0] if len(shape) == 1 and not isinstance(shape[0], int)
                           else shape)
        if shape.numel() != self.shape.numel():
            raise ValueError(f"cannot reshape {tuple(self.shape)} to {tuple(shape)}")
        return LazyTensor(shape, self.dtype, self.path, self.offset)

    def __repr__(self):
        return f"LazyTensor({tuple(self.shape)}, {self.dtype})"


class _Reader:
    """Reads LazyTensors into destination tensors in chunks, `workers` reads
    at a time (`os.preadv` lets go of the GIL). On the card each chunk lands
    in one of `workers + 1` pinned staging buffers and is copied from there
    asynchronously, in order; a buffer is refilled once its copy is done.
    On the CPU the chunks land in the destination itself."""

    def __init__(self, device: torch.device, workers: int):
        self.pool = ThreadPoolExecutor(workers)
        self.fds: Dict[str, int] = {}
        self.inflight = collections.deque()
        self.staging = []
        if device.type == "cuda":
            self.staging = [torch.empty(_STAGING_BYTES, dtype=torch.uint8, pin_memory=True)
                            for _ in range(workers + 1)]
        self.events = [None] * len(self.staging)
        self.chunks = 0

    def _pread(self, fd: int, offset: int, out: torch.Tensor) -> None:
        view = memoryview(out.numpy())
        done = 0
        while done < len(view):
            n = os.preadv(fd, [view[done:]], offset + done)
            if n <= 0:
                raise EOFError("the file ends inside a tensor")
            done += n

    def add(self, src: LazyTensor, dst: torch.Tensor) -> None:
        """Queue the reads that fill the contiguous `dst` (src's dtype and
        size) with src's bytes."""
        global BYTES_READ
        if src.path not in self.fds:
            self.fds[src.path] = os.open(src.path, os.O_RDONLY)
        fd = self.fds[src.path]
        flat = dst.reshape(-1).view(torch.uint8)
        for begin in range(0, flat.numel(), _STAGING_BYTES):
            out = flat[begin:begin + _STAGING_BYTES]
            if not self.staging:
                self.inflight.append(self.pool.submit(self._pread, fd, src.offset + begin, out))
                continue
            i = self.chunks % len(self.staging)
            self.chunks += 1
            if len(self.inflight) == len(self.staging):
                self._copy_oldest()
            if self.events[i] is not None:
                self.events[i].synchronize()
            buf = self.staging[i][:out.numel()]
            self.inflight.append((self.pool.submit(self._pread, fd, src.offset + begin, buf),
                                  buf, out, i))
        BYTES_READ += src.nbytes

    def _copy_oldest(self) -> None:
        read, buf, out, i = self.inflight.popleft()
        read.result()
        out.copy_(buf, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()

    def close(self) -> None:
        """Wait for every queued read and copy."""
        try:
            while self.inflight:
                if self.staging:
                    self._copy_oldest()
                else:
                    self.inflight.popleft().result()
            for e in self.events:
                if e is not None:
                    e.synchronize()
        finally:
            self.pool.shutdown()
            for fd in self.fds.values():
                os.close(fd)


def read_tensors(sd: Dict, device, dtype: Optional[torch.dtype] = None) -> Dict:
    """Every LazyTensor of `sd` read onto `device` once, floating ones cast
    to `dtype` there (when given); numpy arrays become tensors there, other
    values are passed through."""
    device = torch.device(device)
    out = {}
    reader = _Reader(device, _READ_WORKERS)
    try:
        for name, v in sd.items():
            if isinstance(v, LazyTensor):
                out[name] = torch.empty(v.shape, dtype=v.dtype, device=device)
                reader.add(v, out[name])
            elif isinstance(v, np.ndarray):
                out[name] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
            else:
                out[name] = v.to(device) if isinstance(v, torch.Tensor) else v
    finally:
        reader.close()
    for name, t in out.items():
        if (dtype is not None and isinstance(t, torch.Tensor) and t.is_floating_point()
                and t.dtype != dtype):
            out[name] = t.to(dtype)
    return out


def _zip_data_records(path: str) -> Dict[int, int]:
    """{file offset: size} of the stored (uncompressed) `*/data/*` records
    of a torch zip checkpoint: each storage's bytes."""
    records = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            parts = info.filename.split("/")
            if len(parts) == 3 and parts[1] == "data" and info.compress_type == zipfile.ZIP_STORED:
                f.seek(info.header_offset)
                name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
                records[info.header_offset + 30 + name_len + extra_len] = info.file_size
    return records


def _lazy_pth(path: str, sd: Dict) -> Dict:
    """The mapped tensors of `torch.load(mmap=True)` as LazyTensors at their
    file offsets. The load maps the whole file at once, so a storage's
    address less its record's offset is one base for all: the base that
    puts every storage on a record of its size. A file without one, or with
    a tensor that is not row-major, raises: reading it through the mapping
    would hold up to the whole file in the host's resident set."""
    tensors = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor) and v.numel()}
    strided = sorted(k for k, v in tensors.items() if not v.is_contiguous())
    if strided:
        raise ValueError(f"{path}: tensors that are not row-major ({strided[:3]}): "
                         "save them with .contiguous() to load them")
    if not tensors:
        return sd
    records = _zip_data_records(path)
    storages = {v.untyped_storage().data_ptr(): v.untyped_storage().nbytes()
                for v in tensors.values()}
    first = min(storages, default=0)
    for offset in sorted(records):
        base = first - offset
        if all(records.get(ptr - base) == n for ptr, n in storages.items()):
            out = dict(sd)
            out.update({k: LazyTensor(v.shape, v.dtype, path, v.data_ptr() - base)
                        for k, v in tensors.items()})
            return out
    raise ValueError(f"{path}: no stored zip record holds each tensor's storage "
                     "(a compressed or unknown .pth layout): save it again with "
                     "torch.save to load it")


def load_state_dict(path: str, prefix: Optional[str] = None,
                    lazy: bool = False) -> Dict:
    """One .safetensors / .pth / .bin file -> {name: tensor}. lazy: the
    values are LazyTensors (shapes and dtypes only; `read_tensors` reads
    them); else CPU tensors in the stored dtype. A .pth's `state_dict` or
    `model_state` entry is unwrapped; `prefix` keeps the names under it,
    stripped."""
    if path.endswith(".safetensors"):
        header, start = read_header(path)
        sd = {name: LazyTensor(info["shape"], info["dtype"], path,
                               start + info["data_offsets"][0])
              for name, info in header.items()}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        if "model_state" in sd:
            sd = sd["model_state"]
        sd = _lazy_pth(path, sd)
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd if lazy else read_tensors(sd, "cpu")


def load_state_dict_files(paths: List[str], lazy: bool = False) -> Dict:
    sd: Dict = {}
    for p in sorted(paths):
        sd.update(load_state_dict(p, lazy=lazy))
    return sd


def hash_state_dict_keys(sd: Dict, with_shape: bool = True) -> str:
    """md5 of the sorted keys (and their shapes): the reference's checkpoint
    hash (models/utils.py), so official files hash as there."""
    keys_str = ",".join(sorted(sd.keys()))
    if with_shape:
        shapes = ",".join(str(tuple(sd[k].shape)) for k in sorted(sd.keys()))
        keys_str += "|" + shapes
    return hashlib.md5(keys_str.encode()).hexdigest()


def detect_wan_dit_config(sd: Dict) -> Optional[WanDiTConfig]:
    """The Wan DiT architecture from the state dict's keys and shapes, as
    the JAX package detects it (text_dim and freq_dim keep their defaults):
    image input from `k_img`, FLF2V's position table from `img_emb.emb_pos`,
    TI2V-5B from dim 3072 with 48 input channels, a Fun V1.1 reference
    conv from `ref_conv.weight`; and, where the JAX converter adds one, the
    Fun camera adapter from `control_adapter.*` keys (a port-only field)."""
    if "blocks.0.self_attn.q.weight" not in sd:
        return None
    dim = sd["blocks.0.self_attn.q.weight"].shape[0]
    num_layers = 0
    while f"blocks.{num_layers}.self_attn.q.weight" in sd:
        num_layers += 1
    ffn_dim = sd["blocks.0.ffn.0.weight"].shape[0]
    in_dim = sd["patch_embedding.weight"].shape[1]
    out_dim = sd["head.head.weight"].shape[0] // 4  # patch (1,2,2) -> 4
    has_image_input = "blocks.0.cross_attn.k_img.weight" in sd
    heads_by_dim = {1536: 12, 5120: 40, 3072: 24}
    seperated = dim == 3072 and in_dim == 48
    return WanDiTConfig(
        dim=dim, in_dim=in_dim, ffn_dim=ffn_dim, out_dim=out_dim,
        num_heads=heads_by_dim.get(dim, dim // 128), num_layers=num_layers,
        has_image_input=has_image_input,
        has_image_pos_emb="img_emb.emb_pos" in sd, has_ref_conv="ref_conv.weight" in sd,
        seperated_timestep=seperated, require_vae_embedding=not seperated,
        fuse_vae_embedding_in_latents=seperated,
        has_control_adapter=any(k.startswith("control_adapter.") for k in sd))


def detect_vace_config(sd: Dict) -> Optional[VaceConfig]:
    """The VACE branch's config, as the JAX package detects it: `VACE_14B`
    at dim 5120 whatever the block count, `VACE_1_3B` at dim 1536 with 15
    blocks, else blocks at layers 0..n-1."""
    if "vace_blocks.0.before_proj.weight" not in sd:
        return None
    dim = sd["vace_blocks.0.before_proj.weight"].shape[0]
    n = 0
    while f"vace_blocks.{n}.after_proj.weight" in sd:
        n += 1
    if dim == 5120:
        return VACE_14B
    if dim == 1536 and n == 15:
        return VACE_1_3B
    ffn = sd["vace_blocks.0.ffn.0.weight"].shape[0]
    heads = {1536: 12, 5120: 40}.get(dim, dim // 128)
    vace_in = sd["vace_patch_embedding.weight"].shape[1]
    return VaceConfig(vace_layers=tuple(range(n)), vace_in_dim=vace_in,
                      dim=dim, num_heads=heads, ffn_dim=ffn)


# kinds `detect_model_kind` knows that the port cannot build yet, and the
# ROADMAP Queue 1 item that ports each
UNPORTED_KINDS = {
    "qwen_image_dit": "11d", "qwen_image_blockwise_controlnet": "11d",
    "hunyuan_video_dit": "11e", "hunyuan_dit": "11e", "omnigen": "11e",
    "stepvideo_text_encoder": "11e",
    "svd_unet": "11f", "svd_unet_exvideo": "11f",
}


def unported(kind: str) -> NotImplementedError:
    item = UNPORTED_KINDS.get(kind)
    where = f"ROADMAP Queue 1 item {item}" if item else "no ROADMAP item"
    return NotImplementedError(f"model kind {kind!r} is not ported yet ({where})")


def build_module(cls, cfg, sd: Dict, device, dtype: torch.dtype) -> torch.nn.Module:
    """`cls(cfg)` built on `meta`, then given `sd`'s tensors, read onto
    `device` in `dtype` (strict: every parameter, no stray key)."""
    with torch.device("meta"):
        module = cls(cfg, dtype=dtype)
    module.load_state_dict(read_tensors(sd, device, dtype), strict=True, assign=True)
    return module.eval()


def load_model(path, device=None, dtype: torch.dtype = torch.bfloat16):
    """Point at a checkpoint file (or a list of shards) and get `(kind,
    models)`, the JAX `load_model`'s analogue: {"dit", "dit_cfg"} and/or
    {"vace", "vace_cfg"}; {"vae", "vae_cfg"} (fp32; the Wan2.1 or the
    Wan2.2 VAE); the T5 encoder (umT5-XXL); the CLIP ViT-H/14 tower; the
    Wan2.2-Animate adapter; the wav2vec2-XLSR-53 tower
    (`models.wav2vec.WAV2VEC2_XLSR_53`, read when called); the FLUX DiT
    (FLUX.1-dev where the file has a guidance embedder, else schnell); a
    FLUX ControlNet or IP-Adapter (for FLUX.1-dev's widths), the
    InfiniteYou projector (its `image_proj` bundle unwrapped), a value
    encoder or the LoRA encoder; or the SD3 DiT (its config inferred; the
    mmdit layout with or without the `model.diffusion_model.` prefix).
    Modules are built on `device` (the card unless "cpu")."""
    from ..device import resolve_device
    from ..models import clip_vit as CV
    from ..models import t5 as T5M
    from ..models import wan_vae as V
    from ..models.wan_dit import WanDiT
    from ..models.wan_vace import WanVace
    from .convert import convert_vace, convert_wan_dit

    device = resolve_device(device)
    paths = [path] if isinstance(path, str) else list(path)
    sd = load_state_dict_files(paths, lazy=True)
    kind = detect_model_kind(sd)
    if kind in ("dit", "dit+vace", "vace"):
        out = {}
        if kind in ("dit", "dit+vace"):
            cfg = detect_wan_dit_config(sd)
            out["dit"] = build_module(WanDiT, cfg, convert_wan_dit(sd, cfg), device, dtype)
            out["dit_cfg"] = cfg
        if kind in ("vace", "dit+vace"):
            vcfg = detect_vace_config(sd)
            out["vace"] = build_module(WanVace, vcfg, convert_vace(sd, vcfg), device, dtype)
            out["vace_cfg"] = vcfg
        return kind, out
    if kind == "vae":
        cls, cfg = (V.WanVAE38, V.WAN22_VAE) if V.is_wan22_vae(sd) else (V.WanVAE,
                                                                          V.WAN21_VAE)
        return kind, {"vae": build_module(cls, cfg, V.convert_wan_vae(sd), device,
                                          torch.float32), "vae_cfg": cfg}
    if kind == "clip":
        return kind, build_module(CV.ClipVit, CV.CLIP_VIT_H_14, CV.convert_clip_vit(sd),
                                  device, dtype)
    if kind == "t5":
        return kind, build_module(T5M.T5Encoder, T5M.UMT5_XXL,
                                  T5M.convert_t5(sd, T5M.UMT5_XXL), device, dtype)
    if kind == "animate":
        from ..models.wan_animate import build_wan_animate
        return kind, build_wan_animate(sd, device, dtype)
    if kind == "wav2vec":
        from ..models import wav2vec as W
        cfg = W.WAV2VEC2_XLSR_53
        return kind, build_module(W.Wav2Vec2, cfg, W.convert_wav2vec(sd, cfg), device,
                                  dtype)
    if kind == "flux_dit":
        from ..models import flux_dit as F
        cfg = F.flux_config_for(sd)
        return kind, build_module(F.FluxDiT, cfg, F.convert_flux_dit(sd, cfg), device, dtype)
    if kind in IMAGE_KINDS:
        from ..models.flux_dit import FLUX_DEV
        return kind, build_image_module(kind, sd, FLUX_DEV, device, dtype)
    if kind in SD_KINDS:
        return kind, build_sd_module(kind, sd, device, dtype)
    if kind in UNPORTED_KINDS:
        raise unported(kind)
    raise NotImplementedError(f"detected '{kind}' — use its family pipeline/converter "
                              "directly")


# the FLUX adapters' and the SD3 DiT's kinds: `build_image_module` builds them
IMAGE_KINDS = ("flux_controlnet", "flux_ipadapter", "flux_infiniteyou_projector",
               "flux_value_encoder", "flux_lora_encoder", "sd3_dit")


def build_image_module(kind: str, sd: Dict, dit_cfg, device, dtype: torch.dtype, cfg=None):
    """One of `IMAGE_KINDS` from its state dict, on `device` in `dtype`: a
    FLUX adapter for the DiT of `dit_cfg` (its own config read from the
    file unless `cfg` is given; the InfiniteYou bundle's `image_proj`
    unwrapped), or the SD3 DiT (`dit_cfg` unused; its config inferred; the
    mmdit names with or without the `model.diffusion_model.` prefix)."""
    from ..models import flux_adapters as FA
    from ..models import flux_controlnet as FC
    from ..models import sd3_dit as D
    if kind == "flux_controlnet":
        cfg = cfg or FC.controlnet_config_for(sd, dit_cfg)
        return build_module(FC.FluxControlNet, cfg, FC.convert_flux_controlnet(sd, cfg),
                            device, dtype)
    if kind == "flux_ipadapter":
        cfg = cfg or FC.ipadapter_config_for(sd, dit_cfg)
        return build_module(FC.FluxIpAdapter, cfg,
                            FC.convert_flux_ipadapter(sd, cfg.num_blocks), device, dtype)
    if kind == "flux_infiniteyou_projector":
        if "image_proj" in sd and not hasattr(sd["image_proj"], "shape"):
            sd = sd["image_proj"]
        return build_module(FA.InfiniteYouProjector, cfg or FA.infiniteyou_config_for(sd),
                            FA.convert_infiniteyou_projector(sd), device, dtype)
    if kind == "flux_value_encoder":
        return build_module(FA.SingleValueEncoder, cfg or FA.value_encoder_config_for(sd),
                            FA.convert_value_encoder(sd), device, dtype)
    if kind == "flux_lora_encoder":
        return build_module(FA.FluxLoRAEncoder, cfg or FA.lora_encoder_config_for(sd),
                            FA.convert_flux_lora_encoder(sd), device, dtype)
    if kind == "sd3_dit":
        if any(k.startswith("joint_blocks.") for k in sd):
            # the detector's bare mmdit names: the JAX converter reads only
            # the prefixed ones and fails on these
            sd = {D.CIVITAI_PREFIX + k: v for k, v in sd.items()}
        if any(k.startswith(D.CIVITAI_PREFIX + "joint_blocks.") for k in sd):
            sd = D.rename_civitai_sd3(sd)
        cfg = cfg or D.infer_sd3_config(sd)
        return build_module(D.SD3DiT, cfg, D.convert_sd3_dit(sd, cfg), device, dtype)
    raise ValueError(f"not an image kind: {kind!r} (one of {IMAGE_KINDS})")


# the SD family's kinds: `build_sd_module` builds them
SD_KINDS = ("sd_unet", "motion_modules", "ipadapter", "kolors_text_encoder")


def build_sd_module(kind: str, sd: Dict, device, dtype: torch.dtype):
    """One of `SD_KINDS` from its state dict, on `device` in `dtype`, its
    widths read from the tensors: the SD 1.5 or (with `label_emb`) SDXL
    UNet of an LDM file, bare or under `model.diffusion_model.` (the JAX
    loader keeps the LDM names, which its UNet cannot read; here they are
    renamed by `utils.sd_civitai`); a motion model; an SD / SDXL
    IP-Adapter; ChatGLM3-6B (`models.kolors_text_encoder.CHATGLM3_6B`, read
    when called)."""
    from ..models import sd as S
    if kind == "sd_unet":
        from ..models import sdxl as X
        from ..utils import sd_civitai as SC
        prefix = "model.diffusion_model."
        if not any(k.startswith(prefix) for k in sd):
            sd = {prefix + k: v for k, v in sd.items()}
        xl = any(k.startswith(prefix + "label_emb.") for k in sd)
        program, cls = (X.SDXL_UNET_PROGRAM, X.SDXLUNet) if xl else (S.SD_UNET_PROGRAM, S.SDUNet)
        usd = S.convert_sd_module(SC.convert_ldm_unet(sd, xl))
        return build_module(cls, S.detect_unet_config(usd, program), usd, device, dtype)
    if kind == "motion_modules":
        from ..models.motion import convert_motion_model, detect_motion_model
        msd = convert_motion_model(sd)
        return build_module(lambda cfg, dtype: detect_motion_model(msd, dtype=dtype), None, msd,
                            device, dtype)
    if kind == "ipadapter":
        from ..models import ipadapter as I
        isd = I.convert_ipadapter(sd)
        return build_module(I.IpAdapter, I.detect_ipadapter_config(isd), isd, device, dtype)
    if kind == "kolors_text_encoder":
        from ..models import kolors_text_encoder as K
        return build_module(K.ChatGLM, K.CHATGLM3_6B, K.convert_chatglm(sd), device, dtype)
    raise ValueError(f"not an SD kind: {kind!r} (one of {SD_KINDS})")


def detect_model_kind(sd: Dict) -> str:
    """Structural architecture detection, keyed on the state dict's keys
    (the JAX package's `detect_model_kind`, every family it knows)."""
    keys = sd.keys()
    # non-Wan families first (their keys never collide with Wan's)
    if any(k.startswith("controlnet_blocks.") and ".x_rms." in k
           for k in keys):
        return "qwen_image_blockwise_controlnet"
    if any(k.startswith("embedder.model_dict.") for k in keys):
        return "flux_lora_encoder"
    if "prefer_value_embedder.0.weight" in sd:
        return "flux_value_encoder"
    if any(k.endswith(".0.to_kv.weight") for k in keys) and \
            ("latents" in sd or "image_proj" in sd):
        return "flux_infiniteyou_projector"
    if "tok_embeddings.word_embeddings.weight" in sd:
        return "stepvideo_text_encoder"
    if any(k.startswith("motion_modules.") and "transformer_blocks" in k
           for k in keys):
        return "motion_modules"
    if any(k.startswith("double_blocks.") for k in keys) or \
            "img_in.weight" in sd:
        return "flux_dit"                      # BFL layout
    if any(k.startswith("controlnet_x_embedder.") for k in keys):
        return "flux_controlnet"
    if any(k.startswith("ipadapter_modules.") or k.startswith("ip_adapter.")
           for k in keys) and any("to_k_ip" in k for k in keys):
        # an SD / SDXL adapter's projection is one linear (`image_proj.proj.
        # weight`); the JAX detector's "image_proj.proj" also matches it and
        # calls it FLUX's
        if "image_proj.proj.weight" in sd:
            return "ipadapter"
        return "flux_ipadapter" if any("norm_added_k" in k or
                                       "image_proj.proj" in k for k in keys) \
            else "ipadapter"
    if any(k.startswith("joint_blocks.") for k in keys):
        return "sd3_dit"
    if any(k.startswith("single_blocks.") and "linear1" in k for k in keys):
        return "hunyuan_video_dit"
    if any(".rota1.q_norm." in k or ".Wqkv." in k for k in keys):
        return "hunyuan_dit"
    if any(k.startswith("llm.layers.") for k in keys):
        return "omnigen"
    if any(k.startswith("encoder.layers.") and "self_attention.query_key_value"
           in k for k in keys):
        return "kolors_text_encoder"
    if any(k.startswith("transformer_blocks.") and "attn1.norm_q" in k
           for k in keys):
        return "qwen_image_dit"
    if any(".positional_conv." in k for k in keys):
        return "svd_unet_exvideo"   # ExVideo-SVD-128f patched UNet
    if any(".mix_factor" in k for k in keys):
        return "svd_unet"
    if any(k.startswith("input_blocks.") or k.startswith(
            "model.diffusion_model.input_blocks.") for k in keys):
        return "sd_unet"
    if any(k.startswith("wav2vec2.") or k.startswith(
            "feature_extractor.conv_layers.") for k in keys):
        return "wav2vec"
    if "casual_audio_encoder.weights" in sd:
        return "s2v"
    if any(k.startswith("face_adapter.") or k.startswith("pose_patch_embedding.")
           for k in keys):
        return "animate"
    if any(k.startswith("vace_blocks.") or k.startswith("vace.vace_blocks.") for k in keys):
        if "blocks.0.self_attn.q.weight" in sd:
            return "dit+vace"
        return "vace"
    if "blocks.0.self_attn.q.weight" in sd:
        return "dit"
    if any(k.endswith("encoder.conv1.weight") or k.startswith("encoder.conv1") for k in keys):
        return "vae"
    if "token_embedding.weight" in sd:
        return "t5"
    if "visual.patch_embedding.weight" in sd or "textual.token_embedding.weight" in sd:
        return "clip"
    raise ValueError(f"cannot detect model kind from keys like "
                     f"{sorted(list(keys))[:5]}")
