"""The SD3 / SD3.5 MM-DiT in PyTorch.

Counterpart of `video_styler_tpu/models/sd3_dit.py`: joint (image and text
streams, one attention over [image | text]) transformer blocks over a
2x2-patchified latent with a learned position table cropped to the grid;
SD3.5 normalises q and k per head (RMS, a learned weight of 64); MMDiT-X
(SD3.5-medium) leads with "dual" blocks whose image stream runs a second,
image-only self-attention (`attn2`, 9-way modulation); the last block's
text stream is modulation only (2-way, (scale, shift)).

Heads are 64 wide (`num_heads = dim // 64`). The JAX dispatcher sends any
head dim that is not a multiple of 128 to the exact XLA `sdpa`
(`video_styler_tpu/ops/attention.py:67-72`), and K1 takes head dim 128
only, so every SD3 attention calls the port's exact `ops.attention.sdpa`
here, as `clip_vit.py` and `wav2vec.py` do. Parameters live in modules
named after the JAX tree (`dual_blocks`, `blocks`, `final_block`); the
reference's `blocks.{i}` are split into them by `convert_sd3_dit`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import sdpa
from ..ops.basic import gelu_tanh, layer_norm
from . import flux_dit as F
from .wan_dit import Linear

HEAD_DIM = 64


@dataclass(frozen=True)
class SD3DiTConfig:
    dim: int = 1536
    num_layers: int = 24               # the final block included
    num_dual_blocks: int = 0
    use_rms_norm: bool = False
    pos_embed_max_size: int = 192
    in_channels: int = 16
    context_dim: int = 4096
    pooled_dim: int = 2048
    time_freq_dim: int = 256
    eps: float = 1e-6

    @property
    def num_heads(self) -> int:
        return self.dim // HEAD_DIM


SD3_MEDIUM = SD3DiTConfig()
SD35_LARGE = SD3DiTConfig(dim=2432, num_layers=38, use_rms_norm=True)
SD3_DIT_TINY = SD3DiTConfig(dim=128, num_layers=3, num_dual_blocks=1, use_rms_norm=True,
                            pos_embed_max_size=16, context_dim=64, pooled_dim=32)


class JointAttention(nn.Module):
    def __init__(self, cfg: SD3DiTConfig, only_out_a: bool = False, single: bool = False,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.a_to_qkv = Linear(d, 3 * d, **kw)
        self.a_to_out = Linear(d, d, **kw)
        if not single:
            self.b_to_qkv = Linear(d, 3 * d, **kw)
            if not only_out_a:
                self.b_to_out = Linear(d, d, **kw)
        if cfg.use_rms_norm:
            for n in ("norm_q_a", "norm_k_a") + (() if single else ("norm_q_b", "norm_k_b")):
                setattr(self, n, F.RMSWeight(HEAD_DIM, **kw))


class JointBlock(nn.Module):
    def __init__(self, cfg: SD3DiTConfig, dual: bool = False, final: bool = False,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1_a = F.AdaMod(cfg.dim, 9 if dual else 6, **kw)
        self.norm1_b = F.AdaMod(cfg.dim, 2 if final else 6, **kw)
        self.attn = JointAttention(cfg, only_out_a=final, **kw)
        self.ff_a = F._ff(cfg.dim, **kw)
        if not final:
            self.ff_b = F._ff(cfg.dim, **kw)
        if dual:
            self.attn2 = JointAttention(cfg, single=True, **kw)


class PosEmbedder(nn.Module):
    def __init__(self, cfg: SD3DiTConfig, device=None, dtype=None):
        super().__init__()
        self.proj = Linear(cfg.in_channels * 4, cfg.dim, device=device, dtype=dtype)
        m = cfg.pos_embed_max_size
        self.pos_embed = nn.Parameter(torch.zeros(1, m, m, cfg.dim, device=device, dtype=dtype))


class SD3DiT(nn.Module):
    """Parameters of the SD3 DiT; `sd3_dit_forward` runs it."""

    def __init__(self, cfg: SD3DiTConfig = SD3_MEDIUM, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.cfg = cfg
        self.pos_embedder = PosEmbedder(cfg, **kw)
        self.time_embedder = F.MLPEmbed(cfg.time_freq_dim, d, **kw)
        self.pooled_text_embedder = F.MLPEmbed(cfg.pooled_dim, d, **kw)
        self.context_embedder = Linear(cfg.context_dim, d, **kw)
        self.dual_blocks = nn.ModuleList(JointBlock(cfg, dual=True, **kw)
                                         for _ in range(cfg.num_dual_blocks))
        self.blocks = nn.ModuleList(JointBlock(cfg, **kw)
                                    for _ in range(cfg.num_layers - 1 - cfg.num_dual_blocks))
        self.final_block = JointBlock(cfg, final=True, **kw)
        self.norm_out = F.AdaMod(d, 2, **kw)
        self.proj_out = Linear(d, 64, **kw)


@torch.no_grad()
def init_sd3_dit_(model: SD3DiT, generator: torch.Generator) -> SD3DiT:
    """Linear weights N(0, 1/in), biases 0, RMSNorm weights 1, the position
    table N(0, 0.02^2) (the JAX init's is zeros)."""
    F.init_flux_dit_(model, generator)
    model.pos_embedder.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _maybe_rms(p: JointAttention, name: str, x, eps: float):
    return F._rms(getattr(p, name), x, eps) if hasattr(p, name) else x


def _qkv(p: JointAttention, side: str, x, cfg: SD3DiTConfig):
    q, k, v = F._heads(getattr(p, f"{side}_to_qkv")(x), 3 * cfg.num_heads).chunk(3, 2)
    return (_maybe_rms(p, f"norm_q_{side}", q, cfg.eps),
            _maybe_rms(p, f"norm_k_{side}", k, cfg.eps), v)


def joint_attention(p: JointAttention, a, b, cfg: SD3DiTConfig, only_out_a: bool = False):
    """One exact attention over [image | text]; -> the image stream's
    output (and the text's)."""
    q_a, k_a, v_a = _qkv(p, "a", a, cfg)
    q_b, k_b, v_b = _qkv(p, "b", b, cfg)
    out = sdpa(torch.cat([q_a, q_b], dim=1), torch.cat([k_a, k_b], dim=1),
               torch.cat([v_a, v_b], dim=1))
    out = out.reshape(out.shape[0], out.shape[1], cfg.dim)
    out_a = p.a_to_out(out[:, :a.shape[1]])
    if only_out_a:
        return out_a
    return out_a, p.b_to_out(out[:, a.shape[1]:])


def single_attention(p: JointAttention, a, cfg: SD3DiTConfig):
    q, k, v = _qkv(p, "a", a, cfg)
    return p.a_to_out(sdpa(q, k, v).reshape(a.shape[0], a.shape[1], cfg.dim))


def _ff(p: nn.ModuleDict, x):
    return p["2"](gelu_tanh(p["0"](x)))


def joint_block(p: JointBlock, a, b, temb, cfg: SD3DiTConfig, dual: bool = False):
    eps = cfg.eps
    if dual:
        sh_a, sc_a, g_a, shm_a, scm_a, gm_a, sh_a2, sc_a2, g_a2 = F._ada_mod(p.norm1_a, temb, 9)
        base = layer_norm(a, eps=eps)
        na, na2 = base * (1 + sc_a) + sh_a, base * (1 + sc_a2) + sh_a2
    else:
        sh_a, sc_a, g_a, shm_a, scm_a, gm_a = F._ada_mod(p.norm1_a, temb, 6)
        na = F._modulate(a, sh_a, sc_a, eps)
    sh_b, sc_b, g_b, shm_b, scm_b, gm_b = F._ada_mod(p.norm1_b, temb, 6)
    out_a, out_b = joint_attention(p.attn, na, F._modulate(b, sh_b, sc_b, eps), cfg)
    a = a + g_a * out_a
    if dual:
        a = a + g_a2 * single_attention(p.attn2, na2, cfg)
    a = a + gm_a * _ff(p.ff_a, F._modulate(a, shm_a, scm_a, eps))
    b = b + g_b * out_b
    b = b + gm_b * _ff(p.ff_b, F._modulate(b, shm_b, scm_b, eps))
    return a, b


def final_block(p: JointBlock, a, b, temb, cfg: SD3DiTConfig):
    eps = cfg.eps
    sh_a, sc_a, g_a, shm_a, scm_a, gm_a = F._ada_mod(p.norm1_a, temb, 6)
    sc_b, sh_b = F._ada_mod(p.norm1_b, temb, 2)          # (scale, shift)
    out_a = joint_attention(p.attn, F._modulate(a, sh_a, sc_a, eps),
                            F._modulate(b, sh_b, sc_b, eps), cfg, only_out_a=True)
    a = a + g_a * out_a
    return a + gm_a * _ff(p.ff_a, F._modulate(a, shm_a, scm_a, eps))


def cropped_pos_embed(table, height: int, width: int, patch: int = 2):
    """The centre h x w crop of a (1, M, M, D) table -> (1, h * w, D)."""
    h, w = height // patch, width // patch
    m = table.shape[1]
    top, left = (m - h) // 2, (m - w) // 2
    return table[:, top:top + h, left:left + w].reshape(1, h * w, -1)


def sd3_dit_forward(model: SD3DiT, hidden_states, timestep, prompt_emb, pooled_prompt_emb,
                    remat: bool = False):
    """hidden_states (B, 16, H, W) latents; prompt_emb (B, L, context_dim);
    pooled_prompt_emb (B, pooled_dim) -> the velocity (B, 16, H, W).
    remat: each dual and joint block under `torch.utils.checkpoint`
    (non-reentrant), as the JAX forward checkpoints its scans; the same
    values."""
    block = joint_block
    if remat:
        def block(*args, **kw):
            return checkpoint(joint_block, *args, use_reentrant=False, **kw)
    cfg = model.cfg
    dtype = hidden_states.dtype
    temb = F._mlp_embed(model.time_embedder,
                        F.timestep_embedding_flux(timestep, cfg.time_freq_dim).to(dtype))
    temb = temb + F._mlp_embed(model.pooled_text_embedder, pooled_prompt_emb)
    ctx = model.context_embedder(prompt_emb)
    height, width = hidden_states.shape[-2:]
    x = model.pos_embedder.proj(F.patchify(hidden_states))
    x = x + cropped_pos_embed(model.pos_embedder.pos_embed, height, width).to(x.dtype)
    for p in model.dual_blocks:
        x, ctx = block(p, x, ctx, temb, cfg, dual=True)
    for p in model.blocks:
        x, ctx = block(p, x, ctx, temb, cfg)
    x = final_block(model.final_block, x, ctx, temb, cfg)
    sc, sh = F._ada_mod(model.norm_out, temb, 2)
    x = model.proj_out(F._modulate(x, sh, sc, cfg.eps))
    b = x.shape[0]
    # "B (H W) (P Q C) -> B C (H P) (W Q)"
    return x.reshape(b, height // 2, width // 2, 2, 2, -1).permute(0, 5, 1, 3, 2, 4).reshape(
        b, -1, height, width)


# --------------------------------------------------------------------------
# Checkpoint conversion
# --------------------------------------------------------------------------

def _read(v):
    """A lazy checkpoint tensor read onto the CPU; anything else as it is."""
    from ..utils.ckpt import LazyTensor, read_tensors
    return read_tensors({"v": v}, "cpu")["v"] if isinstance(v, LazyTensor) else v


def infer_sd3_config(sd: Dict) -> SD3DiTConfig:
    """The architecture from a DiffSynth-layout state dict's keys and shapes
    (the JAX `infer_sd3_config`); the text and pooled widths from the
    embedders' tensors too, where the JAX config keeps its defaults (4096
    and 2048, every release's) and its converter takes the tensors as they
    are."""
    num_layers = 0
    while f"blocks.{num_layers}.ff_a.0.bias" in sd:
        num_layers += 1
    num_dual = 0
    while f"blocks.{num_dual}.attn2.a_to_out.bias" in sd:
        num_dual += 1
    return SD3DiTConfig(dim=int(sd["blocks.0.ff_a.0.weight"].shape[1]), num_layers=num_layers,
                        num_dual_blocks=num_dual,
                        use_rms_norm="blocks.0.attn.norm_q_a.weight" in sd,
                        pos_embed_max_size=int(sd["pos_embedder.pos_embed"].shape[1]),
                        context_dim=int(sd["context_embedder.weight"].shape[1]),
                        pooled_dim=int(sd["pooled_text_embedder.0.weight"].shape[1]))


_CIVITAI_TOP = {
    "context_embedder": "context_embedder", "final_layer.linear": "proj_out",
    "x_embedder.proj": "pos_embedder.proj", "t_embedder.mlp.0": "time_embedder.timestep_embedder.0",
    "t_embedder.mlp.2": "time_embedder.timestep_embedder.2",
    "y_embedder.mlp.0": "pooled_text_embedder.0", "y_embedder.mlp.2": "pooled_text_embedder.2",
    "final_layer.adaLN_modulation.1": "norm_out.linear",
}
_CIVITAI_LEAF = {
    "context_block.adaLN_modulation.1": "norm1_b.linear",
    "context_block.attn.proj": "attn.b_to_out", "context_block.attn.qkv": "attn.b_to_qkv",
    "context_block.attn.ln_q": "attn.norm_q_b", "context_block.attn.ln_k": "attn.norm_k_b",
    "context_block.mlp.fc1": "ff_b.0", "context_block.mlp.fc2": "ff_b.2",
    "x_block.adaLN_modulation.1": "norm1_a.linear",
    "x_block.attn.proj": "attn.a_to_out", "x_block.attn.qkv": "attn.a_to_qkv",
    "x_block.attn.ln_q": "attn.norm_q_a", "x_block.attn.ln_k": "attn.norm_k_a",
    "x_block.mlp.fc1": "ff_a.0", "x_block.mlp.fc2": "ff_a.2",
    "x_block.attn2.qkv": "attn2.a_to_qkv", "x_block.attn2.proj": "attn2.a_to_out",
    "x_block.attn2.ln_q": "attn2.norm_q_a", "x_block.attn2.ln_k": "attn2.norm_k_a",
}
CIVITAI_PREFIX = "model.diffusion_model."


def rename_civitai_sd3(sd: Dict) -> Dict:
    """Raw mmdit (civitai) layout -> the DiffSynth module layout (the JAX
    `rename_civitai_sd3`): fused qkv stays fused, the flat position table
    becomes (1, M, M, D), the last block's `norm1_b` and `norm_out` swap
    (shift, scale) to (scale, shift)."""
    p = CIVITAI_PREFIX
    out = {}
    for name, v in sd.items():
        if name == f"{p}pos_embed":
            v = _read(v)
            m = int(v.shape[1] ** 0.5 + 0.4)
            out["pos_embedder.pos_embed"] = v.reshape(1, m, m, v.shape[-1])
            continue
        if not name.startswith(p):
            continue
        prefix, suffix = name[len(p):].rsplit(".", 1)
        if prefix in _CIVITAI_TOP and suffix in ("weight", "bias"):
            out[f"{_CIVITAI_TOP[prefix]}.{suffix}"] = v
        elif prefix.startswith("joint_blocks."):
            i, mid = prefix[len("joint_blocks."):].split(".", 1)
            if mid in _CIVITAI_LEAF:
                out[f"blocks.{i}.{_CIVITAI_LEAF[mid]}.{suffix}"] = v
    n = 0
    while f"blocks.{n}.ff_a.0.bias" in out:
        n += 1
    for key in (f"blocks.{n - 1}.norm1_b.linear.weight", f"blocks.{n - 1}.norm1_b.linear.bias",
                "norm_out.linear.weight", "norm_out.linear.bias"):
        v = _read(out[key])
        half = v.shape[0] // 2
        out[key] = torch.cat([v[half:], v[:half]], dim=0)
    return out


def convert_sd3_dit(sd: Dict, cfg: SD3DiTConfig = None) -> Dict:
    """A DiffSynth-layout SD3DiT state dict (a raw civitai one is renamed
    first) -> the `SD3DiT` state dict: the 2x2 stride-2 patch conv becomes a
    linear over (C, P, Q)-flattened patches, the embedders' `{0,2}` become
    `fc1` / `fc2`, the reference's `blocks.{i}` go to `dual_blocks`,
    `blocks` and `final_block`."""
    if any(k.startswith(CIVITAI_PREFIX + "joint_blocks.") for k in sd):
        sd = rename_civitai_sd3(sd)
    cfg = cfg or infer_sd3_config(sd)
    w = _read(sd["pos_embedder.proj.weight"])
    out = {"pos_embedder.proj.weight": w.reshape(w.shape[0], -1),
           "pos_embedder.proj.bias": sd["pos_embedder.proj.bias"],
           "pos_embedder.pos_embed": sd["pos_embedder.pos_embed"]}
    for dst, src in (("time_embedder", "time_embedder.timestep_embedder"),
                     ("pooled_text_embedder", "pooled_text_embedder")):
        for fc, i in (("fc1", 0), ("fc2", 2)):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{fc}.{leaf}"] = sd[f"{src}.{i}.{leaf}"]
    for name in ("context_embedder", "norm_out.linear", "proj_out"):
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = sd[f"{name}.{leaf}"]
    n_dual, last = cfg.num_dual_blocks, cfg.num_layers - 1

    def block_name(i: int) -> str:
        if i < n_dual:
            return f"dual_blocks.{i}"
        return "final_block" if i == last else f"blocks.{i - n_dual}"

    for k, v in sd.items():
        if k.startswith("blocks."):
            i, rest = k[len("blocks."):].split(".", 1)
            if int(i) <= last:
                out[f"{block_name(int(i))}.{rest}"] = v
    return out
