"""Checkpoint converters: the reference's state dicts to the port's modules'
state dicts, and back.

Counterpart of `video_styler_tpu/utils/convert.py` (`convert_wan_dit`
:100, `convert_vace` :144). The official Wan files use the reference's
module names (the civitai layout); the port's modules are named after the
JAX pytree:

  text_embedding.0 / .2, time_embedding.0 / .2  ->  .fc1 / .fc2
  time_projection.1                             ->  time_projection
  ffn.0 / ffn.2                                 ->  ffn.fc1 / ffn.fc2
  RMSNorm and LayerNorm .weight                 ->  .scale
  patch_embedding, vace_patch_embedding         ->  a Linear: the Conv3d
      weight (out, in, 1, 2, 2) as (out, in*4), flattened in the order of
      the JAX `_conv_as_lin` (:48)
  vace_blocks.{i}.before_proj (block 0 only)    ->  before_proj
  vace_blocks.{i}.after_proj                    ->  after_proj.{i}
  img_emb.proj.0 / .1 / .3 / .4 (I2V, FLF2V)    ->  img_emb.norm_in / .fc1
                                                    / .fc2 / .norm_out
  img_emb.emb_pos (FLF2V)                       ->  img_emb.emb_pos

An image-conditioned DiT also has `k_img`, `v_img` and `norm_k_img` in
each block's cross-attention. Values pass through untouched (tensors or
`utils.ckpt.LazyTensor`s, which reshape without reading), in the file's
dtype. Keys the port's modules do not hold (a Fun control adapter, for
one) are left out, as the JAX converters leave them.

`export_wan_dit`, `export_vace`, `export_t5`, `export_wan_vae` (both VAEs)
and `models.clip_vit.export_clip_vit` invert them: a module's tensors under
the reference's names, which is how the tests and `chip_smoke.py` write
checkpoints in the release layout.
"""
from __future__ import annotations

import math
import re
from typing import Dict

import torch

from ..models.wan_dit import WanDiTConfig
from ..models.wan_vace import VaceConfig


def _lin(sd: Dict, src: str, dst: str, out: Dict) -> None:
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _conv_as_lin(sd: Dict, src: str, dst: str, out: Dict) -> None:
    w = sd[f"{src}.weight"]
    out[f"{dst}.weight"] = w.reshape(w.shape[0], math.prod(w.shape[1:]))
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _block(sd: Dict, src: str, dst: str, out: Dict, image: bool = False) -> None:
    for attn in ("self_attn", "cross_attn"):
        for name in ("q", "k", "v", "o"):
            _lin(sd, f"{src}.{attn}.{name}", f"{dst}.{attn}.{name}", out)
        for norm in ("norm_q", "norm_k"):
            out[f"{dst}.{attn}.{norm}.scale"] = sd[f"{src}.{attn}.{norm}.weight"]
    if image:
        for name in ("k_img", "v_img"):
            _lin(sd, f"{src}.cross_attn.{name}", f"{dst}.cross_attn.{name}", out)
        out[f"{dst}.cross_attn.norm_k_img.scale"] = sd[f"{src}.cross_attn.norm_k_img.weight"]
    out[f"{dst}.norm3.scale"] = sd[f"{src}.norm3.weight"]
    out[f"{dst}.norm3.bias"] = sd[f"{src}.norm3.bias"]
    _lin(sd, f"{src}.ffn.0", f"{dst}.ffn.fc1", out)
    _lin(sd, f"{src}.ffn.2", f"{dst}.ffn.fc2", out)
    out[f"{dst}.modulation"] = sd[f"{src}.modulation"]


def convert_wan_dit(sd: Dict, cfg: WanDiTConfig) -> Dict:
    """Reference WanModel state dict (civitai layout) -> `WanDiT` state dict."""
    out: Dict = {}
    _conv_as_lin(sd, "patch_embedding", "patch_embedding", out)
    for emb in ("text_embedding", "time_embedding"):
        _lin(sd, f"{emb}.0", f"{emb}.fc1", out)
        _lin(sd, f"{emb}.2", f"{emb}.fc2", out)
    _lin(sd, "time_projection.1", "time_projection", out)
    _lin(sd, "head.head", "head.head", out)
    out["head.modulation"] = sd["head.modulation"]
    for i in range(cfg.num_layers):
        _block(sd, f"blocks.{i}", f"blocks.{i}", out, cfg.has_image_input)
    if cfg.has_image_input:
        for src, dst in (("0", "norm_in"), ("4", "norm_out")):
            out[f"img_emb.{dst}.scale"] = sd[f"img_emb.proj.{src}.weight"]
            out[f"img_emb.{dst}.bias"] = sd[f"img_emb.proj.{src}.bias"]
        _lin(sd, "img_emb.proj.1", "img_emb.fc1", out)
        _lin(sd, "img_emb.proj.3", "img_emb.fc2", out)
        if cfg.has_image_pos_emb:
            out["img_emb.emb_pos"] = sd["img_emb.emb_pos"]
    return out


def convert_vace(sd: Dict, cfg: VaceConfig) -> Dict:
    """Reference VaceWanModel state dict -> `WanVace` state dict.

    Reads `vace_blocks.*` and `vace_patch_embedding` as the JAX converter
    does: a file whose keys carry a leading `vace.` (which
    `detect_model_kind` accepts) does not convert, in either package."""
    out: Dict = {}
    _conv_as_lin(sd, "vace_patch_embedding", "patch_embedding", out)
    _lin(sd, "vace_blocks.0.before_proj", "before_proj", out)
    for i in range(len(cfg.vace_layers)):
        _block(sd, f"vace_blocks.{i}", f"blocks.{i}", out)
        _lin(sd, f"vace_blocks.{i}.after_proj", f"after_proj.{i}", out)
    return out


# ---------------------------------------------------------------- export

def _renamed(sd: Dict[str, torch.Tensor], rules) -> Dict[str, torch.Tensor]:
    out = {}
    for name, t in sd.items():
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        out[name] = t
    return out


_BLOCK_RULES = [
    (r"\.ffn\.fc1\.", ".ffn.0."), (r"\.ffn\.fc2\.", ".ffn.2."),
    (r"\.(norm_q|norm_k|norm3|norm_k_img)\.scale$", r".\1.weight"),
]


def export_wan_dit(dit: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A `WanDiT`'s tensors under the reference's names and shapes."""
    cfg = dit.cfg
    sd = _renamed(dit.state_dict(), _BLOCK_RULES + [
        (r"^(text_embedding|time_embedding)\.fc1\.", r"\1.0."),
        (r"^(text_embedding|time_embedding)\.fc2\.", r"\1.2."),
        (r"^time_projection\.", "time_projection.1."),
        (r"^img_emb\.norm_in\.scale$", "img_emb.proj.0.weight"),
        (r"^img_emb\.norm_in\.bias$", "img_emb.proj.0.bias"),
        (r"^img_emb\.fc1\.", "img_emb.proj.1."), (r"^img_emb\.fc2\.", "img_emb.proj.3."),
        (r"^img_emb\.norm_out\.scale$", "img_emb.proj.4.weight"),
        (r"^img_emb\.norm_out\.bias$", "img_emb.proj.4.bias")])
    w = sd["patch_embedding.weight"]
    sd["patch_embedding.weight"] = w.reshape(w.shape[0], cfg.in_dim, *cfg.patch_size)
    return sd


def export_vace(vace: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A `WanVace`'s tensors under the reference's names and shapes (the
    keys a combined DiT+VACE file holds beside the DiT's)."""
    cfg = vace.cfg
    sd = _renamed(vace.state_dict(), _BLOCK_RULES + [
        (r"^blocks\.", "vace_blocks."),
        (r"^after_proj\.(\d+)\.", r"vace_blocks.\1.after_proj."),
        (r"^before_proj\.", "vace_blocks.0.before_proj."),
        (r"^patch_embedding\.", "vace_patch_embedding.")])
    w = sd["vace_patch_embedding.weight"]
    sd["vace_patch_embedding.weight"] = w.reshape(w.shape[0], cfg.vace_in_dim,
                                                  *cfg.patch_size)
    return sd


def export_t5(t5: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A `T5Encoder`'s tensors under the reference WanTextEncoder's names."""
    return _renamed(t5.state_dict(), [
        (r"^token_embedding$", "token_embedding.weight"),
        (r"\.(norm1|norm2)\.scale$", r".\1.weight"), (r"^norm\.scale$", "norm.weight"),
        (r"\.ffn\.gate\.", ".ffn.gate.0."),
        (r"\.pos_emb$", ".pos_embedding.embedding.weight")])


def export_wan_vae(vae: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A `WanVAE`'s or `WanVAE38`'s tensors under the reference's names (the
    port keeps them; the official file has no `model.` prefix)."""
    return dict(vae.state_dict())


def save_release_files(pipe, folder: str, n_shards: int = 7) -> Dict[str, object]:
    """Write a pipeline's models in the layout of the Wan releases: the DiT
    (and VACE, where the pipeline has one) together under the reference's
    names, in safetensors shards `diffusion_pytorch_model-0000i-of-0000n`
    (consecutive names, split near equal in bytes); umT5 as
    `models_t5_umt5-xxl-enc-bf16.pth`, the VAE as `Wan2.1_VAE.pth` (or
    `Wan2.2_VAE.pth`) and an I2V pipeline's CLIP tower as
    `models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth`. Tensors keep
    their dtype; one at a time passes through the host. Returns {"dit":
    [shard paths], "t5": path, "vae": path[, "clip": path]}."""
    import os
    from ..models.clip_vit import export_clip_vit
    from ..models.wan_vae import WanVAE38
    from ..safetensors_io import save_file
    sd = export_wan_dit(pipe.dit)
    if pipe.vace is not None:
        sd.update(export_vace(pipe.vace))
    names = sorted(sd)
    total = sum(sd[k].numel() * sd[k].element_size() for k in names)
    shards, part, size = [], [], 0
    for k in names:
        part.append(k)
        size += sd[k].numel() * sd[k].element_size()
        if size >= total * (len(shards) + 1) / n_shards and len(shards) < n_shards - 1:
            shards.append(part)
            part = []
    shards.append(part)
    paths = {"dit": []}
    for i, part in enumerate(shards):
        path = os.path.join(folder, f"diffusion_pytorch_model-{i + 1:05d}-of-"
                                    f"{len(shards):05d}.safetensors")
        save_file({k: sd[k] for k in part}, path)
        paths["dit"].append(path)
    paths["t5"] = os.path.join(folder, "models_t5_umt5-xxl-enc-bf16.pth")
    torch.save(export_t5(pipe.prompter.text_encoder), paths["t5"])
    paths["vae"] = os.path.join(folder, "Wan2.2_VAE.pth" if isinstance(pipe.vae, WanVAE38)
                                else "Wan2.1_VAE.pth")
    torch.save(export_wan_vae(pipe.vae), paths["vae"])
    if pipe.image_encoder is not None:
        paths["clip"] = os.path.join(
            folder, "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth")
        torch.save(export_clip_vit(pipe.image_encoder), paths["clip"])
    return paths
