"""A civitai / LDM single-file checkpoint -> the port's module names, for
SD 1.5 and SDXL.

Counterpart of `video_styler_tpu/utils/sd_civitai.py`: the UNet's rename
map is derived by walking the block program beside the LDM module order
(`input_blocks.N.S`, `middle_block.S`, `output_blocks.N.S`: a resnet opens
a block, its attention is the block's next part, a sampler the last), then
per-module leaf renames; the VAE's and CLIP-L's are fixed tables. The
SD 1.5 maps give the JAX converter's names and tensors (the 1x1-conv
`proj_in` / `proj_out` squeezed to linears). SDXL (`convert_sdxl_civitai`)
has no counterpart in JAX, whose SDXL runner passes the UNet's LDM names on
unrenamed: here the same walk over `SDXL_UNET_PROGRAM` (attention blocks
of up to 10 transformers, `label_emb` -> `add_time_embedding`), the VAE
and CLIP-L under `conditioner.embedders.0`, and OpenCLIP bigG under
`conditioner.embedders.1.model` (its fused `in_proj` split into q, k, v;
`text_projection` transposed to a linear's weight).

A file splits by prefix: `model.diffusion_model.*` (UNet),
`first_stage_model.*` (VAE), `cond_stage_model.*` / `conditioner.*` (text).
Values pass through untouched where no reshape is needed (tensors, numpy
arrays or `utils.ckpt.LazyTensor`s); a split reads its tensor.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

_RES_LEAVES = {
    "in_layers.0": "norm1", "in_layers.2": "conv1", "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2", "out_layers.3": "conv2", "skip_connection": "conv_shortcut",
}


def _attn_leaves(depth: int) -> Dict[str, str]:
    leaves = {"norm": "norm", "proj_in": "proj_in", "proj_out": "proj_out"}
    for k in range(depth):
        t = f"transformer_blocks.{k}"
        for n in ("norm1", "norm2", "norm3"):
            leaves[f"{t}.{n}"] = f"{t}.{n}"
        for a in ("attn1", "attn2"):
            for q in ("to_q", "to_k", "to_v"):
                leaves[f"{t}.{a}.{q}"] = f"{t}.{a}.{q}"
            leaves[f"{t}.{a}.to_out.0"] = f"{t}.{a}.to_out"
        leaves[f"{t}.ff.net.0.proj"] = f"{t}.act_fn.proj"
        leaves[f"{t}.ff.net.2"] = f"{t}.ff"
    return leaves


def ldm_unet_order(program) -> List[Tuple[int, str, str]]:
    """(program index, kind, LDM module path) for every resnet, attention
    block and sampler of the program, in order."""
    first_pop = next(i for i, (k, _) in enumerate(program) if k == "pop")
    mid_start = max(i for i, (k, _) in enumerate(program[:first_pop]) if k == "push") + 1
    order, down, up, sub, mid = [], 0, -1, 0, 0
    for i, (kind, _) in enumerate(program):
        if kind in ("push", "pop"):
            continue
        if mid_start <= i < first_pop:
            order.append((i, kind, f"middle_block.{mid}"))
            mid += 1
            continue
        if i > first_pop:
            if program[i - 1][0] == "pop":
                up, sub = up + 1, 0
            else:
                sub += 1
            path = f"output_blocks.{up}.{sub}"
        else:
            if kind in ("res", "down"):
                down, sub = down + 1, 0
            else:
                sub += 1
            path = f"input_blocks.{down}.{sub}"
        order.append((i, kind, path + {"down": ".op", "up": ".conv"}.get(kind, "")))
    return order


def unet_rename_map(program, depth: int = 1, add_embedding: bool = False) -> Dict[str, str]:
    """LDM module path -> the port's (`blocks.N.…`), for attention blocks
    of up to `depth` transformers (and SDXL's `label_emb`)."""
    mapping = {}
    attn_leaves = _attn_leaves(depth)
    for idx, kind, path in ldm_unet_order(program):
        if kind == "res":
            for src, dst in _RES_LEAVES.items():
                mapping[f"{path}.{src}"] = f"blocks.{idx}.{dst}"
        elif kind == "attn":
            for src, dst in attn_leaves.items():
                mapping[f"{path}.{src}"] = f"blocks.{idx}.{dst}"
        else:
            mapping[path] = f"blocks.{idx}.conv"
    mapping.update({"input_blocks.0.0": "conv_in", "time_embed.0": "time_embedding.0",
                    "time_embed.2": "time_embedding.2", "out.0": "conv_norm_out",
                    "out.2": "conv_out"})
    if add_embedding:
        mapping.update({"label_emb.0.0": "add_time_embedding.0",
                        "label_emb.0.2": "add_time_embedding.2"})
    return mapping


def sd_unet_rename_map() -> Dict[str, str]:
    from ..models.sd import SD_UNET_PROGRAM
    return unet_rename_map(SD_UNET_PROGRAM)


def _squeeze(v):
    return v.reshape([s for s in v.shape if s != 1])


def _convert_unet(sd: Dict, mapping: Dict[str, str]) -> Dict:
    prefix = "model.diffusion_model."
    out = {}
    for name, param in sd.items():
        if not name.startswith(prefix):
            continue
        module, leaf = name[len(prefix):].rsplit(".", 1)
        if module not in mapping:
            continue
        new = f"{mapping[module]}.{leaf}"
        if ".proj_in." in new or ".proj_out." in new:
            param = _squeeze(param)
        out[new] = param
    return out


def convert_sd_unet_from_civitai(sd: Dict) -> Dict:
    return _convert_unet(sd, sd_unet_rename_map())


def convert_ldm_unet(sd: Dict, xl: bool) -> Dict:
    """An LDM UNet's tensors (under `model.diffusion_model.`) -> the
    reference's names: SD 1.5's, or SDXL's (attention blocks of up to 10
    transformers, `label_emb`)."""
    if not xl:
        return convert_sd_unet_from_civitai(sd)
    from ..models.sdxl import SDXL_UNET_PROGRAM
    return _convert_unet(sd, unet_rename_map(SDXL_UNET_PROGRAM, depth=10, add_embedding=True))


# ---------------------------------------------------------------- VAE

def _vae_attn_map(ldm: str, internal: str) -> Dict[str, str]:
    return {f"{ldm}.norm": f"{internal}.norm", f"{ldm}.q": f"{internal}.transformer_blocks.0.to_q",
            f"{ldm}.k": f"{internal}.transformer_blocks.0.to_k",
            f"{ldm}.v": f"{internal}.transformer_blocks.0.to_v",
            f"{ldm}.proj_out": f"{internal}.transformer_blocks.0.to_out"}


def _vae_res_map(ldm: str, internal: str) -> Dict[str, str]:
    return {f"{ldm}.norm1": f"{internal}.norm1", f"{ldm}.conv1": f"{internal}.conv1",
            f"{ldm}.norm2": f"{internal}.norm2", f"{ldm}.conv2": f"{internal}.conv2",
            f"{ldm}.nin_shortcut": f"{internal}.conv_shortcut"}


def sd_vae_encoder_rename_map() -> Dict[str, str]:
    m, blk = {}, 0
    for stage in range(4):
        for j in range(2):
            m.update(_vae_res_map(f"encoder.down.{stage}.block.{j}", f"blocks.{blk}"))
            blk += 1
        if stage < 3:
            m[f"encoder.down.{stage}.downsample.conv"] = f"blocks.{blk}.conv"
            blk += 1
    m.update(_vae_res_map("encoder.mid.block_1", f"blocks.{blk}"))
    m.update(_vae_attn_map("encoder.mid.attn_1", f"blocks.{blk + 1}"))
    m.update(_vae_res_map("encoder.mid.block_2", f"blocks.{blk + 2}"))
    m.update({"encoder.conv_in": "conv_in", "encoder.norm_out": "conv_norm_out",
              "encoder.conv_out": "conv_out", "quant_conv": "quant_conv"})
    return m


def sd_vae_decoder_rename_map() -> Dict[str, str]:
    m = {}
    m.update(_vae_res_map("decoder.mid.block_1", "blocks.0"))
    m.update(_vae_attn_map("decoder.mid.attn_1", "blocks.1"))
    m.update(_vae_res_map("decoder.mid.block_2", "blocks.2"))
    blk = 3
    for stage in (3, 2, 1, 0):      # the LDM decoder's up.3 runs first (512 wide)
        for j in range(3):
            m.update(_vae_res_map(f"decoder.up.{stage}.block.{j}", f"blocks.{blk}"))
            blk += 1
        if stage > 0:
            m[f"decoder.up.{stage}.upsample.conv"] = f"blocks.{blk}.conv"
            blk += 1
    m.update({"decoder.conv_in": "conv_in", "decoder.norm_out": "conv_norm_out",
              "decoder.conv_out": "conv_out", "post_quant_conv": "post_quant_conv"})
    return m


def _convert_vae(sd: Dict, prefix: str, mapping: Dict[str, str]) -> Dict:
    out = {}
    for name, param in sd.items():
        if not name.startswith(prefix):
            continue
        tail = name[len(prefix):]
        if "." not in tail:
            continue
        module, leaf = tail.rsplit(".", 1)
        if module not in mapping:
            continue
        new = f"{mapping[module]}.{leaf}"
        if ".transformer_blocks." in new:
            param = _squeeze(param)
        out[new] = param
    return out


def convert_sd_vae_encoder_from_civitai(sd: Dict) -> Dict:
    return _convert_vae(sd, "first_stage_model.", sd_vae_encoder_rename_map())


def convert_sd_vae_decoder_from_civitai(sd: Dict) -> Dict:
    return _convert_vae(sd, "first_stage_model.", sd_vae_decoder_rename_map())


# ---------------------------------------------------------------- text encoders

_CLIP_LEAVES = {
    "self_attn.q_proj": "attn.to_q", "self_attn.k_proj": "attn.to_k",
    "self_attn.v_proj": "attn.to_v", "self_attn.out_proj": "attn.to_out",
    "layer_norm1": "layer_norm1", "layer_norm2": "layer_norm2",
    "mlp.fc1": "fc1", "mlp.fc2": "fc2",
}


def _convert_hf_clip(sd: Dict, prefix: str, final_norm: bool = True) -> Dict:
    out = {}
    for name, param in sd.items():
        if not name.startswith(prefix):
            continue
        tail = name[len(prefix):]
        if tail == "embeddings.token_embedding.weight":
            out["token_embedding.weight"] = param
        elif tail == "embeddings.position_embedding.weight":
            out["position_embeds"] = param.reshape((1,) + tuple(param.shape))
        elif tail.startswith("final_layer_norm."):
            if final_norm:
                out[tail] = param
        elif tail.startswith("encoder.layers."):
            parts = tail.split(".")
            layer, module, leaf = parts[2], ".".join(parts[3:-1]), parts[-1]
            if module in _CLIP_LEAVES:
                out[f"encoders.{layer}.{_CLIP_LEAVES[module]}.{leaf}"] = param
    return out


def convert_sd_text_encoder_from_civitai(sd: Dict) -> Dict:
    return _convert_hf_clip(sd, "cond_stage_model.transformer.text_model.")


def convert_sd_civitai(sd: Dict) -> Dict[str, Dict]:
    """A civitai SD 1.5 file -> {'unet', 'text_encoder', 'vae_encoder',
    'vae_decoder'} state dicts under the reference's (DiffSynth) names."""
    return {
        "unet": convert_sd_unet_from_civitai(sd),
        "text_encoder": convert_sd_text_encoder_from_civitai(sd),
        "vae_encoder": convert_sd_vae_encoder_from_civitai(sd),
        "vae_decoder": convert_sd_vae_decoder_from_civitai(sd),
    }


def _read(v):
    import torch
    from .ckpt import LazyTensor, read_tensors
    if isinstance(v, LazyTensor):
        return read_tensors({"t": v}, torch.device("cpu"))["t"]
    return torch.as_tensor(v)


def _convert_open_clip(sd: Dict, prefix: str) -> Dict:
    out = {}
    leaves = {"ln_1": "layer_norm1", "ln_2": "layer_norm2", "attn.out_proj": "attn.to_out",
              "mlp.c_fc": "fc1", "mlp.c_proj": "fc2"}
    for name, param in sd.items():
        if not name.startswith(prefix):
            continue
        tail = name[len(prefix):]
        if tail == "token_embedding.weight":
            out[tail] = param
        elif tail == "positional_embedding":
            out["position_embeds"] = param.reshape((1,) + tuple(param.shape))
        elif tail.startswith("ln_final."):
            out["final_layer_norm." + tail.split(".")[-1]] = param
        elif tail == "text_projection":
            out["text_projection.weight"] = _read(param).t().contiguous()
        elif tail.startswith("transformer.resblocks."):
            parts = tail.split(".")
            layer, module, leaf = parts[2], ".".join(parts[3:-1]), parts[-1]
            if module == "attn" and leaf in ("in_proj_weight", "in_proj_bias"):
                kind = "weight" if leaf == "in_proj_weight" else "bias"
                for q, t in zip(("to_q", "to_k", "to_v"), _read(param).chunk(3, dim=0)):
                    out[f"encoders.{layer}.attn.{q}.{kind}"] = t.contiguous()
            elif module in leaves:
                out[f"encoders.{layer}.{leaves[module]}.{leaf}"] = param
    return out


def convert_sdxl_civitai(sd: Dict) -> Dict[str, Dict]:
    """A civitai SDXL file -> {'unet', 'text_encoder' (CLIP-L, 11 layers,
    no final norm), 'text_encoder_2' (bigG), 'vae_encoder', 'vae_decoder'}
    state dicts under the reference's names."""
    te1 = _convert_hf_clip(sd, "conditioner.embedders.0.transformer.text_model.",
                           final_norm=False)
    te1 = {k: v for k, v in te1.items() if not k.startswith("encoders.11.")}
    return {
        "unet": convert_ldm_unet(sd, xl=True),
        "text_encoder": te1,
        "text_encoder_2": _convert_open_clip(sd, "conditioner.embedders.1.model."),
        "vae_encoder": convert_sd_vae_encoder_from_civitai(sd),
        "vae_decoder": convert_sd_vae_decoder_from_civitai(sd),
    }
