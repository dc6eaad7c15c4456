"""Wan video diffusion transformer (DiT) in PyTorch.

Counterpart of `video_styler_tpu/models/wan_dit.py`. Parameters live in
`nn.Module`s named after the JAX pytree (`blocks` is an `nn.ModuleList` in
place of the stacked per-layer trees); the forward pieces are the same
functions: patchify, time/text embeddings, self-attention (K4 fused
RMSNorm+RoPE, then K1), cross-attention (K5 RMSNorm on Q, then K1), the
GELU-tanh FFN (after `ops.quant.quantize_params` the linears are
`QuantLinear`s, and int8 / per-column int4 q, k, v run as one fused GEMM), the 6-way adaLN-modulated block, VACE hint injection after
mapped layers, and the modulated head. The Fun and Animate conditioning
enters through `wan_dit_forward_with_residual`: a Fun reference frame
(`ref_conv`, its tokens prepended as an extra leading RoPE frame and
dropped after the head), the Fun camera adapter's features added to the
tokens (`control_adapter`), a term added to t_mod (the speed controller's),
and the Animate adapter (pose tokens on frames 1.., a face block after
every 5th layer through `run_blocks`' segments).

Under a sharding context (`parallel.use_sharding`) with sp > 1 the
tokens are padded to sp shares of whole SHARD_ROWS rows
(`pad_tokens_for_mesh`: zeros, cos padded with 1 and sin with 0), each
rank keeps its S/sp rows with their
cos/sin rows (`parallel.split_seq`), self-attention exchanges rows for
heads (Ulysses, or the ring with `ctx.ulysses` False) over the whole padded
sequence with the padded keys cut at `seq_valid`, cross-attention, the FFN
and the head run on the local rows, and the head's rows are gathered and
unpadded before `unpatchify`. Modules that `parallel.shard_params_fsdp`
wrapped are gathered around their use (`parallel.gathered`). Without a
context none of this runs: every token is real and no key is masked.

`remat=True` (training) rematerialises each trunk block and each VACE
block in the backward, as `jax.checkpoint` does for the trunk in the JAX
package: the forward keeps only the block's input, the backward runs the
block again.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.basic import (gelu_tanh, layer_norm, linear, modulate, patchify,
                         rms_norm, silu, sinusoidal_embedding_1d)
from ..ops.fused_norm_rope import fused_rmsnorm, fused_rmsnorm_rope
from ..ops.rope import assemble_freqs_grid
from ..parallel.context import axis_size, current_sharding, gather_seq, pad_rows, split_seq
from ..parallel.fsdp import gathered
from ..parallel.ring import ring_attention
from ..parallel.ulysses import ulysses_attention
from . import wan_animate as A
from .wan_controllers import SimpleAdapter, init_simple_adapter_, simple_adapter_forward


@dataclass(frozen=True)
class WanDiTConfig:
    dim: int
    in_dim: int
    ffn_dim: int
    out_dim: int
    num_heads: int
    num_layers: int
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    has_image_input: bool = False
    has_image_pos_emb: bool = False
    # a Fun V1.1 reference conv (`ref_conv`: z * 2 * 2 -> dim, z = out_dim)
    has_ref_conv: bool = False
    seperated_timestep: bool = False
    require_vae_embedding: bool = True
    fuse_vae_embedding_in_latents: bool = False
    # a Fun camera DiT's SimpleAdapter (`control_adapter`, 24 -> dim). The
    # JAX config has no such field: its converter adds the adapter wherever
    # the file has `control_adapter.*` keys; the port's detection sets it
    has_control_adapter: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def require_clip_embedding(self) -> bool:
        """Whether the DiT takes CLIP rows: exactly where it has the image
        branch. (The JAX config keeps a field that defaults to True and that
        its detector sets to `has_image_input and not seperated_timestep`:
        the same value wherever the image branch exists; a T2V DiT never
        receives CLIP features in either package.)"""
        return self.has_image_input


WAN_T2V_1_3B = WanDiTConfig(dim=1536, in_dim=16, ffn_dim=8960, out_dim=16,
                            num_heads=12, num_layers=30)
WAN_T2V_14B = WanDiTConfig(dim=5120, in_dim=16, ffn_dim=13824, out_dim=16,
                           num_heads=40, num_layers=40)
WAN_I2V_14B = WanDiTConfig(dim=5120, in_dim=36, ffn_dim=13824, out_dim=16,
                           num_heads=40, num_layers=40, has_image_input=True)
WAN_TI2V_5B = WanDiTConfig(dim=3072, in_dim=48, ffn_dim=14336, out_dim=48,
                           num_heads=24, num_layers=30, seperated_timestep=True,
                           require_vae_embedding=False, fuse_vae_embedding_in_latents=True)
# CLIP ViT-H/14 features: 257 rows (the class token and 16 x 16 patches)
# of 1280; FLF2V's two images give 514
CLIP_TOKENS = 257
CLIP_DIM = 1280


# --------------------------------------------------------------------------
# Parameter containers
# --------------------------------------------------------------------------

class Linear(nn.Linear):
    """nn.Linear whose forward is `ops.basic.linear` (weight cast to x.dtype,
    fp32 accumulation, bias added before the rounding)."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class LayerNormAffine(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))


class Attention(nn.Module):
    def __init__(self, dim: int, cross_image: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q = Linear(dim, dim, **kw)
        self.k = Linear(dim, dim, **kw)
        self.v = Linear(dim, dim, **kw)
        self.o = Linear(dim, dim, **kw)
        self.norm_q = RMSNorm(dim, **kw)
        self.norm_k = RMSNorm(dim, **kw)
        if cross_image:
            self.k_img = Linear(dim, dim, **kw)
            self.v_img = Linear(dim, dim, **kw)
            self.norm_k_img = RMSNorm(dim, **kw)


class FFN(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, ffn_dim, device=device, dtype=dtype)
        self.fc2 = Linear(ffn_dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class DiTBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.self_attn = Attention(cfg.dim, **kw)
        self.cross_attn = Attention(cfg.dim, cross_image=cfg.has_image_input, **kw)
        self.norm3 = LayerNormAffine(cfg.dim, **kw)
        self.ffn = FFN(cfg.dim, cfg.ffn_dim, **kw)
        self.modulation = nn.Parameter(torch.empty(1, 6, cfg.dim, **kw))


class TextEmbedding(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(cfg.text_dim, cfg.dim, device=device, dtype=dtype)
        self.fc2 = Linear(cfg.dim, cfg.dim, device=device, dtype=dtype)


class TimeEmbedding(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(cfg.freq_dim, cfg.dim, device=device, dtype=dtype)
        self.fc2 = Linear(cfg.dim, cfg.dim, device=device, dtype=dtype)


class ImageEmbedding(nn.Module):
    """The CLIP feature MLP (`img_emb`): LayerNorm, Linear, exact GELU,
    Linear to the DiT width, LayerNorm; FLF2V adds a (1, 514, 1280)
    position table to its two images' features first."""

    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm_in = LayerNormAffine(CLIP_DIM, **kw)
        self.fc1 = Linear(CLIP_DIM, CLIP_DIM, **kw)
        self.fc2 = Linear(CLIP_DIM, cfg.dim, **kw)
        self.norm_out = LayerNormAffine(cfg.dim, **kw)
        if cfg.has_image_pos_emb:
            self.emb_pos = nn.Parameter(torch.zeros(1, 2 * CLIP_TOKENS, CLIP_DIM, **kw))


class Head(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        pt, ph, pw = cfg.patch_size
        self.head = Linear(cfg.dim, cfg.out_dim * pt * ph * pw,
                           device=device, dtype=dtype)
        self.modulation = nn.Parameter(torch.empty(1, 2, cfg.dim,
                                                   device=device, dtype=dtype))


class WanDiT(nn.Module):
    """Parameters of the Wan DiT; `wan_dit_forward` runs it."""

    def __init__(self, cfg: WanDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        pt, ph, pw = cfg.patch_size
        self.cfg = cfg
        self.patch_embedding = Linear(cfg.in_dim * pt * ph * pw, cfg.dim, **kw)
        self.text_embedding = TextEmbedding(cfg, **kw)
        self.time_embedding = TimeEmbedding(cfg, **kw)
        self.time_projection = Linear(cfg.dim, cfg.dim * 6, **kw)
        self.head = Head(cfg, **kw)
        self.blocks = nn.ModuleList(DiTBlock(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        if cfg.has_image_input:
            self.img_emb = ImageEmbedding(cfg, **kw)
        if cfg.has_ref_conv:
            self.ref_conv = Linear(cfg.out_dim * ph * pw, cfg.dim, **kw)
        if cfg.has_control_adapter:
            self.control_adapter = SimpleAdapter(24, cfg.dim, **kw)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with the JAX package's std: linear weights N(0, 1/in),
    biases 0, norm scales 1, modulation tables N(0, 1/dim), FLF2V's image
    position table 0; a camera adapter as `init_simple_adapter_`."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (RMSNorm, LayerNormAffine)):
            m.scale.fill_(1.0)
            if isinstance(m, LayerNormAffine):
                m.bias.zero_()
        elif isinstance(m, (DiTBlock, Head)):
            m.modulation.normal_(0.0, 1.0 / math.sqrt(m.modulation.shape[-1]),
                                 generator=generator)
        elif isinstance(m, ImageEmbedding) and hasattr(m, "emb_pos"):
            m.emb_pos.zero_()
        elif isinstance(m, SimpleAdapter):
            init_simple_adapter_(m, generator)
    return module


# --------------------------------------------------------------------------
# Forward pieces
# --------------------------------------------------------------------------

def _split_mod(modulation, t_mod, n: int) -> List[torch.Tensor]:
    """(1, n, D) table + t_mod -> n terms: (B, 1, D) each from a per-batch
    (B, n, D) t_mod, (B, S, D) each from a per-token (B, S, n, D) one."""
    if t_mod.dim() == 3:
        mod = modulation.to(t_mod.dtype) + t_mod
        return [mod[:, i][:, None, :] for i in range(n)]
    mod = modulation[:, None].to(t_mod.dtype) + t_mod
    return [mod[:, :, i] for i in range(n)]


def self_attention(p: Attention, x, cos, sin, num_heads: int,
                   eps: float = 1e-6, seq_valid: Optional[int] = None):
    """seq_valid: the count of real tokens when the sequence carries mesh
    padding (masked as keys in every layer; a padded query row is dropped
    after the head)."""
    b, s, d = x.shape
    mode = getattr(p.q, "mode", None)
    if mode in ("int8", "int4"):
        # one activation quantize and one (S, in) @ (in, 3*out) int8 GEMM;
        # per-column int4 unpacks its nibbles to int8 first
        from ..ops.quant import dequant_int4_leaf, fused_qkv_int8
        pq, pk, pv = p.q, p.k, p.v
        if mode == "int4":
            pq, pk, pv = (dequant_int4_leaf(pq), dequant_int4_leaf(pk),
                          dequant_int4_leaf(pv))
        q0, k0, v = fused_qkv_int8(x, pq, pk, pv)
    else:
        q0, k0, v = p.q(x), p.k(x), p.v(x)
    q, k = fused_rmsnorm_rope(q0, k0, p.norm_q.scale, p.norm_k.scale,
                              cos, sin, eps)
    v = v.view(b, s, num_heads, d // num_heads)
    ctx = current_sharding()
    if ctx is not None and ctx.axis_size("sp") > 1:
        seq_parallel = ulysses_attention if ctx.ulysses else ring_attention
        out = seq_parallel(q, k, v, ctx, kv_valid=seq_valid)
    else:
        out = attention(q, k, v, kv_valid=seq_valid)
    return p.o(out.reshape(b, s, d))


def cross_attention(p: Attention, x, y, num_heads: int, eps: float = 1e-6,
                    has_image_input: bool = False):
    """Cross-attention to the context y. With image input, y's first 257
    rows are CLIP slots attended through k_img/v_img with the same q; the
    rest (the text, and FLF2V's end-image rows) take the text branch."""
    b, s, d = x.shape
    hd = d // num_heads
    img, ctx = (y[:, :CLIP_TOKENS], y[:, CLIP_TOKENS:]) if has_image_input else (None, y)
    q = fused_rmsnorm(p.q(x), p.norm_q.scale, eps).view(b, s, num_heads, hd)
    k = rms_norm(p.k(ctx), p.norm_k.scale, eps)
    v = p.v(ctx)
    out = attention(q, k.view(b, ctx.shape[1], num_heads, hd),
                    v.view(b, ctx.shape[1], num_heads, hd)).reshape(b, s, d)
    if has_image_input:
        k_img = rms_norm(p.k_img(img), p.norm_k_img.scale, eps)
        v_img = p.v_img(img)
        out = out + attention(q, k_img.view(b, img.shape[1], num_heads, hd),
                              v_img.view(b, img.shape[1], num_heads, hd)).reshape(b, s, d)
    return p.o(out)


def dit_block(p: DiTBlock, x, context, t_mod, cos, sin, cfg: WanDiTConfig,
              seq_valid: Optional[int] = None):
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
        _split_mod(p.modulation, t_mod, 6)
    h = modulate(layer_norm(x, eps=cfg.eps), shift_msa, scale_msa)
    x = x + gate_msa * self_attention(p.self_attn, h, cos, sin,
                                      cfg.num_heads, cfg.eps, seq_valid)
    x = x + cross_attention(p.cross_attn,
                            layer_norm(x, p.norm3.scale, p.norm3.bias, cfg.eps),
                            context, cfg.num_heads, cfg.eps, cfg.has_image_input)
    h = modulate(layer_norm(x, eps=cfg.eps), shift_mlp, scale_mlp)
    return x + gate_mlp * p.ffn(h)


def block_fn(remat: bool):
    """`dit_block` with the block's parameters gathered if FSDP sharded
    them, or with remat a version whose activations are recomputed in the
    backward (torch.utils.checkpoint, non-reentrant); same values."""
    if not remat:
        def run(blk, *args):
            with gathered(blk):
                return dit_block(blk, *args)
        return run

    def run_remat(*args):
        return checkpoint(dit_block, *args, use_reentrant=False)
    return run_remat


def run_blocks(blocks: Sequence[DiTBlock], x, context, t_mod, cos, sin,
               cfg: WanDiTConfig, vace_hints=None,
               vace_layers: Optional[Sequence[int]] = None,
               vace_scale: float = 1.0, remat: bool = False, layer_gate=None,
               segment_layers: Optional[Sequence[int]] = None,
               segment_callback: Optional[Callable] = None,
               seq_valid: Optional[int] = None):
    """The block stack; VACE hint j is added after layer vace_layers[j],
    cast to the trunk dtype (the scale too, so an fp32 scale never promotes
    a bf16 trunk).

    layer_gate: optional (num_layers, B) tensor; layer i's update of batch
    row b becomes x + g[i, b] * (block(x) - x) in the trunk dtype, so a 0
    makes the block an identity for that row (skip-layer guidance).

    segment_layers / segment_callback: x = segment_callback(j, x) after
    layer segment_layers[j] (the Animate face blocks), after that layer's
    gate. As in the JAX package, the callback takes the VACE hints' place:
    with segments no hint is added.

    seq_valid: the real token count of a mesh-padded sequence
    (`self_attention`)."""
    inject = {}
    if segment_layers is not None:
        inject = {layer: j for j, layer in enumerate(segment_layers)}
    elif vace_hints is not None and vace_layers is not None:
        inject = {layer: j for j, layer in enumerate(vace_layers)}

        def segment_callback(j, x):
            return x + vace_hints[j].to(x.dtype) * \
                torch.tensor(vace_scale, dtype=x.dtype, device=x.device)
    body = block_fn(remat)
    for i, blk in enumerate(blocks):
        y = body(blk, x, context, t_mod, cos, sin, cfg, seq_valid)
        if layer_gate is not None:
            y = x + layer_gate[i].to(x.dtype)[:, None, None] * (y - x)
        x = y
        if i in inject:
            x = segment_callback(inject[i], x)
    return x


# rows of each rank's share are a multiple of this: K1 sums a query row's
# squares for its norm bound over the row's 16-byte chunks in the order of
# their 128-byte swizzle, which repeats every 8 rows, so a row keeps every
# bit of its one-process result only where it keeps its position modulo 8
SHARD_ROWS = 8


def mesh_padded_length(s: int) -> int:
    """S rounded up to a multiple of sp x SHARD_ROWS under a context with
    sp > 1 (the JAX package rounds to a multiple of sp); S otherwise."""
    sp = axis_size("sp")
    return s if sp == 1 else s + (-s) % (sp * SHARD_ROWS)


def pad_tokens_for_mesh(tokens, cos, sin):
    """Pad (B, S, D) tokens and their (S, d/2) RoPE tables so S divides the
    active mesh's sp axis (into shares of whole SHARD_ROWS): zero tokens,
    cos padded with 1 and sin with 0 (an identity rotation, so K4 stays
    finite on the padded rows). Returns (tokens, cos, sin, seq_valid),
    seq_valid the original S, or None where nothing was padded."""
    s = tokens.shape[1]
    length = mesh_padded_length(s)
    if length == s:
        return tokens, cos, sin, None
    return (pad_rows(tokens, length), pad_rows(cos, length, dim=0, value=1.0),
            pad_rows(sin, length, dim=0), s)


def shard_tokens(tokens, cos, sin, t=None, t_mod=None):
    """The mesh's share of a sequence: `pad_tokens_for_mesh`, then this
    rank's rows of the tokens, of cos/sin and of a per-token t (B, S, dim)
    and t_mod (B, S, 6, dim) (padded with zeros). Returns (tokens, cos,
    sin, t, t_mod, seq_valid); without sp all as given, seq_valid None."""
    tokens, cos, sin, seq_valid = pad_tokens_for_mesh(tokens, cos, sin)
    length = tokens.shape[1]
    if t is not None and t.dim() == 3:
        t = split_seq(pad_rows(t, length))
        t_mod = split_seq(pad_rows(t_mod, length))
    return (split_seq(tokens), split_seq(cos, dim=0), split_seq(sin, dim=0), t, t_mod,
            seq_valid)


def unshard_tokens(x, seq_valid: Optional[int]):
    """Every rank's rows of the head's output, gathered and unpadded."""
    x = gather_seq(x)
    return x if seq_valid is None else x[:, :seq_valid]


def unpatchify(x, grid: Tuple[int, int, int], patch_size: Tuple[int, int, int],
               out_dim: int):
    """(B, f*h*w, pt*ph*pw*c) -> (B, c, F, H, W), features in (pt, ph, pw, c)
    order."""
    f, h, w = grid
    pt, ph, pw = patch_size
    b = x.shape[0]
    t = x.reshape(b, f, h, w, pt, ph, pw, out_dim)
    t = t.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return t.reshape(b, out_dim, f * pt, h * ph, w * pw)


def time_embed(model: WanDiT, timestep):
    """timestep (B,) -> (t (B, dim), t_mod (B, 6, dim)); a per-token (B, S)
    timestep -> (B, S, dim) and (B, S, 6, dim)."""
    cfg = model.cfg
    emb = sinusoidal_embedding_1d(cfg.freq_dim, timestep.float())
    te = model.time_embedding
    emb = emb.to(te.fc1.weight.dtype)
    t = te.fc2(silu(te.fc1(emb)))
    t_mod = model.time_projection(silu(t))
    return t, t_mod.reshape(t_mod.shape[:-1] + (6, cfg.dim))


def text_embed(model: WanDiT, context):
    p = model.text_embedding
    return p.fc2(gelu_tanh(p.fc1(context)))


def img_embed(model: WanDiT, clip_feature):
    """(B, 257 or 514, 1280) CLIP features -> (B, same, dim) context rows;
    LayerNorms of eps 1e-5 and exact GELU in fp32."""
    p = model.img_emb
    x = clip_feature
    if hasattr(p, "emb_pos"):
        x = x + p.emb_pos.to(x.dtype)
    x = p.fc1(layer_norm(x, p.norm_in.scale, p.norm_in.bias, eps=1e-5))
    x = p.fc2(torch.nn.functional.gelu(x.float()).to(x.dtype))
    return layer_norm(x, p.norm_out.scale, p.norm_out.bias, eps=1e-5)


def head(model: WanDiT, x, t):
    """Modulated output head; t (B, dim), or (B, S, dim) per token."""
    p = model.head
    if t.dim() == 3:
        mod = p.modulation[:, None].to(t.dtype) + t[:, :, None]
        shift, scale = mod[:, :, 0], mod[:, :, 1]
    else:
        mod = p.modulation.to(t.dtype) + t[:, None, :]
        shift, scale = mod[:, 0][:, None, :], mod[:, 1][:, None, :]
    x = layer_norm(x, eps=model.cfg.eps) * (1 + scale) + shift
    return p.head(x)


def image_inputs(model: WanDiT, x, context, clip_feature=None, y=None):
    """The image conditioning as the JAX pipeline applies it: y joins the
    latents' channels where the DiT takes a VAE embedding, the CLIP rows
    go in front of the (embedded) text context where it takes a CLIP one."""
    cfg = model.cfg
    if y is not None and cfg.require_vae_embedding:
        x = torch.cat([x, y.to(x.dtype)], dim=1)
    if clip_feature is not None and cfg.require_clip_embedding:
        context = torch.cat([img_embed(model, clip_feature), context], dim=1)
    return x, context


def assemble_tokens(model: WanDiT, x, control_camera=None, reference_latents=None):
    """Patchify, then the Fun conditioning, in the JAX pipeline's order:
    the camera adapter's features (B, dim, f, h, w) added token by token,
    then the reference frame's tokens (`ref_conv` on its (1, 2, 2) patches)
    put in front. Returns (tokens, (f, h, w) of the latents, n_ref)."""
    cfg = model.cfg
    tokens, grid = patchify(model.patch_embedding, x, cfg.patch_size)
    if control_camera is not None:
        cam = simple_adapter_forward(model.control_adapter, control_camera.to(tokens.dtype))
        tokens = tokens + cam.flatten(2).transpose(1, 2)
    n_ref = 0
    if reference_latents is not None:
        ref, _ = patchify(model.ref_conv, reference_latents.to(tokens.dtype),
                          (1,) + tuple(cfg.patch_size[1:]))
        tokens = torch.cat([ref, tokens], dim=1)
        n_ref = ref.shape[1]
    return tokens, grid, n_ref


def wan_dit_forward_with_residual(model: WanDiT, x, timestep, context,
                                  rope_indices=None, vace=None,
                                  vace_context=None, vace_scale: float = 1.0,
                                  remat: bool = False, layer_gate=None,
                                  clip_feature=None, y=None, control_camera=None,
                                  reference_latents=None, t_mod_add=None,
                                  animate=None):
    """`wan_dit_forward`, also returning the block stack's residual
    (tokens out - tokens in, (B, S, dim); under sp this rank's rows of the
    padded sequence) that TeaCache replays.

    control_camera: (B, 24, F, H, W) packed Plücker latents for the camera
    adapter; reference_latents: (B, z, 1, H, W), one more leading RoPE
    frame whose tokens are dropped after the head; t_mod_add: (B, 6, dim)
    added to t_mod (the speed controller's term); animate: (adapter, pose
    latents (B, 16, F - 1, H, W), face crops (B, 3, T, size, size)): the
    pose tokens added after the VACE hints are taken, a face block after
    every 5th layer."""
    with gathered(model):
        cfg = model.cfg
        t, t_mod = time_embed(model, timestep)
        if t_mod_add is not None:
            t_mod = t_mod + t_mod_add.to(t_mod.dtype)
        x, context = image_inputs(model, x, text_embed(model, context), clip_feature, y)
        tokens_in, (f, h, w), n_ref = assemble_tokens(model, x, control_camera,
                                                      reference_latents)
        cos, sin = assemble_freqs_grid(cfg.head_dim, f + (1 if n_ref else 0), h, w,
                                       rope_indices, device=tokens_in.device)
        posed = None
        if animate is not None:
            adapter, pose_latents, face_values = animate
            posed, motion_vec = A.animate_after_patch_embedding(
                adapter, tokens_in, (f, h, w), pose_latents, face_values)
        tokens_in, cos, sin, t, t_mod, seq_valid = shard_tokens(tokens_in, cos, sin, t, t_mod)
        hints = None
        if vace is not None and vace_context is not None:
            from .wan_vace import vace_forward
            hints = vace_forward(vace, tokens_in, vace_context, context, t_mod,
                                 cos, sin, remat=remat, seq_valid=seq_valid)
        segments = {}
        if animate is not None:
            # the pose tokens are added on the whole grid, after the VACE
            # hints took the tokens before them; under sp each face block
            # runs on the gathered, unpadded rows (the JAX pipeline's
            # _unpad / _repad), then each rank takes its rows again
            s_real, padded = posed.shape[1], mesh_padded_length(posed.shape[1])
            tokens_in = split_seq(pad_rows(posed, padded))

            def after_block(j, x):
                x = gather_seq(x)[:, :s_real]
                x = A.animate_after_transformer_block(adapter, 5 * j, x, motion_vec,
                                                      cfg.num_heads)
                return split_seq(pad_rows(x, padded))
            segments = dict(segment_layers=tuple(range(0, cfg.num_layers, 5)),
                            segment_callback=after_block)
        tokens = run_blocks(model.blocks, tokens_in, context, t_mod, cos, sin, cfg,
                            vace_hints=hints,
                            vace_layers=None if hints is None else vace.cfg.vace_layers,
                            vace_scale=vace_scale, remat=remat, layer_gate=layer_gate,
                            seq_valid=seq_valid, **segments)
        out = unshard_tokens(head(model, tokens, t), seq_valid)[:, n_ref:]
        out = unpatchify(out, (f, h, w), cfg.patch_size, cfg.out_dim)
        return out, tokens - tokens_in


def wan_dit_forward(model: WanDiT, x, timestep, context, rope_indices=None,
                    vace=None, vace_context=None, vace_scale: float = 1.0,
                    remat: bool = False, layer_gate=None, clip_feature=None, y=None,
                    **conditioning):
    """Full DiT forward, optionally with the VACE branch.

    x: (B, C, F, H, W) latents; timestep: (B,), or (B, S) per token;
    context: (B, L, text_dim); vace: a `WanVace`, vace_context: (B,
    vace_in_dim, F, H, W); clip_feature: (B, 257 or 514, 1280) and y:
    (B, 4 + z, F, H, W) for an image-conditioned DiT (`image_inputs`);
    conditioning: the Fun and Animate inputs of
    `wan_dit_forward_with_residual`.
    layer_gate: optional (num_layers, B) per-row block gates (`run_blocks`).
    remat: recompute each trunk block and each VACE block in the backward.
    The JAX package's `remat` covers the trunk only
    (`models/wan_vace.py:85-92`); the VACE blocks are recomputed too because
    their activations at 29,640 tokens do not fit one 80 GB card beside the
    14B weights. It changes no value."""
    return wan_dit_forward_with_residual(model, x, timestep, context,
                                         rope_indices, vace, vace_context,
                                         vace_scale, remat, layer_gate,
                                         clip_feature, y, **conditioning)[0]
