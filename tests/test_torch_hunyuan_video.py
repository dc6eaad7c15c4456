"""HunyuanVideo against the JAX package: `hunyuan_rope` (bit-equal), the
token refiner, a double and a single block, the DiT forward (fp32 in the
DiffSynth and the civitai layout, bf16), the causal VAE's encode and
decode (plain and tiled), TeaCache's skip pattern, `HunyuanVideoPipeline`
(t2v, v2v, i2v, CFG, TeaCache; the prompt and video encodes stubbed as the
JAX tests stub them), the LLaMA + CLIP-L prompt path, the loaders
(`load_model` on both layouts, beside the JAX detector's fault) and
`video_gen --family hunyuan_video` (beside the JAX runner's fault).

Weights: DiffSynth-named state dicts drawn from a numpy seed (biases and
norm weights off their init), read by both packages' converters; the
civitai layout is made from them by the inverse renames (the single
blocks' `linear1` / `linear2` fused). Widths: `HUNYUAN_VIDEO_TINY` (96
wide, 4 heads of 24, 2 + 2 blocks, 8 text rows split at 3) and
`HUNYUAN_VAE_TINY` (z 4; z 16 in the pipeline); clips of 5 frames of
32x32. On the CPU the port's attention is K1's plain version (the capped
softmax) and the JAX DiT takes the exact `sdpa` (heads of 24): fp32 within
2e-5 relative L2 (the VAE 1e-4: fp32 convolutions over 10 layers sum in
another order), bf16 within 2e-2.
"""
import argparse
import dataclasses
import functools
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.hunyuan_video_dit as JD
import video_styler_tpu.models.sd3_text_encoder as JCT
import video_styler_tpu.models.hunyuan_video_vae as JV
import video_styler_tpu.pipelines.hunyuan_video as JP
from video_styler_tpu.utils import ckpt as JCK

import video_styler_tpu_torch.models.hunyuan_video_dit as TD
import video_styler_tpu_torch.models.hunyuan_video_vae as TV
import video_styler_tpu_torch.pipelines.hunyuan_video as TP
from video_styler_tpu_torch import safetensors_io, video_gen
from video_styler_tpu_torch.models.sd3_text_encoder import (CLIP_L_TINY, ClipTextEncoder,
                                                            init_clip_text_)
from video_styler_tpu_torch.prompters.flux_prompter import StubClipTokenizer
from video_styler_tpu_torch.utils import ckpt as TCK
from video_styler_tpu_torch.utils.ckpt import build_module

from test_torch_flux import _reference_names
from test_torch_fun import _rel
from test_torch_pipeline import cpu_share  # noqa: F401
from test_torch_qwen_vl import LLAMA, hf_text_sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_F32 = 2e-5
TOL_VAE = 1e-4
TOL_BF16 = 2e-2
CFG_J, CFG_T = JD.HUNYUAN_VIDEO_TINY, TD.HUNYUAN_VIDEO_TINY
VAE_J, VAE_T = JV.HUNYUAN_VAE_TINY, TV.HUNYUAN_VAE_TINY
VAE16 = dict(z_dim=16, block_out_channels=(8, 16, 16, 16), layers_per_block=1, num_groups=4)


# ------------------------------------------------------------ weights

_EMBEDS = (("time_in.", "time_in.timestep_embedder."),
           ("guidance_in.", "guidance_in.timestep_embedder."),
           ("txt_in.t_embedder.", "txt_in.t_embedder.timestep_embedder."))


def diffsynth_names(sd, cfg=CFG_T):
    """A `HunyuanVideoDiT` state dict (numpy) under the reference's
    DiffSynth names: the inverse of `convert_hunyuan_video_dit`."""
    out = {}
    for name, v in sd.items():
        for short, long in _EMBEDS:
            rest = name[len(short):]
            if name.startswith(short) and rest[:3] in ("fc1", "fc2"):
                name = long + {"fc1": "0", "fc2": "2"}[rest[:3]] + rest[3:]
        out[name] = v
    w = out["img_in.proj.weight"]
    out["img_in.proj.weight"] = w.reshape(w.shape[0], cfg.in_channels, *cfg.patch_size)
    return out


def dit_state_dict(cfg=CFG_T, seed: int = 0):
    """The reference's DiffSynth names, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in TD.HunyuanVideoDiT(cfg, device="meta").state_dict().items():
        shape = tuple(p.shape)
        if p.dim() == 2:
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif "norm" in name:
            v = 1 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return diffsynth_names(sd, cfg)


def civitai_state_dict(sd, cfg=CFG_T):
    """The raw (civitai) layout of a DiffSynth state dict: the inverse of
    `rename_civitai_hunyuan`, the single blocks' linears fused."""
    inv_direct = {v: k for k, v in TD._DIRECT.items()}
    inv_double = {v: k for k, v in TD._DOUBLE.items()}
    inv_ref = {v: k for k, v in TD._REFINER.items()}
    out = {}
    for name, v in sd.items():
        parts = name.split(".")
        head, leaf = ".".join(parts[:-1]), parts[-1]
        if head in inv_direct:
            out[f"{inv_direct[head]}.{leaf}"] = v
        elif parts[0] == "double_blocks":
            out[f"double_blocks.{parts[1]}.{inv_double['.'.join(parts[2:-1])]}.{leaf}"] = v
        elif parts[:2] == ["txt_in", "blocks"]:
            out[f"txt_in.individual_token_refiner.blocks.{parts[2]}."
                f"{inv_ref['.'.join(parts[3:-1])]}.{leaf}"] = v
    for i in range(cfg.num_single_blocks):
        b = f"single_blocks.{i}"
        for leaf in ("weight", "bias"):
            out[f"{b}.linear1.{leaf}"] = np.concatenate(
                [sd[f"{b}.to_qkv.{leaf}"], sd[f"{b}.ff.0.{leaf}"]], axis=0)
        out[f"{b}.linear2.weight"] = np.concatenate(
            [sd[f"{b}.to_out.weight"], sd[f"{b}.ff.2.weight"]], axis=-1)
        out[f"{b}.linear2.bias"] = sd[f"{b}.to_out.bias"]
        out[f"{b}.q_norm.weight"] = sd[f"{b}.norm_q.weight"]
        out[f"{b}.k_norm.weight"] = sd[f"{b}.norm_k.weight"]
        for leaf in ("weight", "bias"):
            out[f"{b}.modulation.linear.{leaf}"] = sd[f"{b}.mod.linear.{leaf}"]
    return out


def torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def port_dit(sd, cfg=CFG_T, dtype=torch.float32):
    return build_module(TD.HunyuanVideoDiT, cfg, TD.convert_hunyuan_video_dit(sd, cfg), "cpu",
                        dtype)


def reference_vae_names(module, sd):
    """A VAE module's state dict under the reference's names: each
    CausalConv3d's `.conv` level put back (the quant convs are plain)."""
    convs = {n for n, m in module.named_modules() if isinstance(m, torch.nn.Conv3d)}
    out = {}
    for name, v in sd.items():
        mod, leaf = name.rsplit(".", 1)
        out[f"{mod}.conv.{leaf}" if mod in convs and "quant_conv" not in mod else name] = v
    return out


def vae_state_dicts(cfg=VAE_T, seed: int = 9):
    """(encoder, decoder) state dicts under the reference's names, drawn
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for cls in (TV.HunyuanVAEEncoder, TV.HunyuanVAEDecoder):
        sd = {}
        module = cls(cfg, device="meta")
        for name, p in module.state_dict().items():
            shape = tuple(p.shape)
            mod, leaf = name.rsplit(".", 1)
            if leaf == "weight" and p.dim() > 1:
                v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            elif "norm" in mod and leaf == "weight":
                v = 1 + 0.1 * rng.standard_normal(shape)
            else:
                v = 0.05 * rng.standard_normal(shape)
            sd[name] = v.astype(np.float32)
        out.append(reference_vae_names(module, sd))
    return tuple(out)


def port_vae(enc_sd, dec_sd, cfg=VAE_T):
    return (build_module(TV.HunyuanVAEEncoder, cfg, TV.convert_hunyuan_vae(enc_sd), "cpu",
                         torch.float32),
            build_module(TV.HunyuanVAEDecoder, cfg, TV.convert_hunyuan_vae(dec_sd), "cpu",
                         torch.float32))


# ------------------------------------------------------------ DiT

def test_hunyuan_rope_bit_equal():
    for cfg_t, cfg_j, grid in ((CFG_T, CFG_J, (3, 4, 5)), (TD.HUNYUAN_VIDEO, JD.HUNYUAN_VIDEO,
                                                           (3, 45, 80))):
        for a, b in zip(TD.hunyuan_rope(cfg_t, *grid), JD.hunyuan_rope(cfg_j, *grid)):
            np.testing.assert_array_equal(a, b)


def _inputs(seed: int = 2, frames: int = 3, h: int = 6, w: int = 8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 16, frames, h, w)).astype(np.float32)
    emb = rng.standard_normal((1, CFG_T.txt_len, CFG_T.text_dim)).astype(np.float32)
    mask = np.ones((1, CFG_T.txt_len), np.int32)
    mask[:, 5:] = 0
    pooled = rng.standard_normal((1, CFG_T.pooled_dim)).astype(np.float32)
    return x, np.array([731.0], np.float32), emb, mask, pooled, np.array([6.0], np.float32)


def test_token_refiner():
    sd = dit_state_dict()
    jp = JD.convert_hunyuan_video_dit(sd, CFG_J, dtype=jnp.float32)
    model = port_dit(torch_sd(sd))
    _, t, emb, mask, _, _ = _inputs()
    mask[:, 0] = 0      # a masked first row: column 0 stays open
    want = jax.jit(JD.token_refiner, static_argnums=1)(
        jp["txt_in"], CFG_J, jnp.asarray(emb), jnp.asarray(t), jnp.asarray(mask))
    with torch.no_grad():
        got = TD.token_refiner(model.txt_in, CFG_T, torch.from_numpy(emb), torch.from_numpy(t),
                               torch.from_numpy(mask))
    assert _rel(got, want) < TOL_F32


def test_double_and_single_block():
    sd = dit_state_dict()
    jp = JD.convert_hunyuan_video_dit(sd, CFG_J, dtype=jnp.float32)
    model = port_dit(torch_sd(sd))
    rng = np.random.default_rng(4)
    n_img, d = 12, CFG_T.hidden_size
    img = rng.standard_normal((1, n_img, d)).astype(np.float32)
    txt = rng.standard_normal((1, CFG_T.txt_len, d)).astype(np.float32)
    vec = rng.standard_normal((1, d)).astype(np.float32)
    cos, sin = TD.hunyuan_rope(CFG_T, 1, 3, 4)
    jb = jax.tree_util.tree_map(lambda a: a[0], jp["double_blocks"])
    ja, jt = jax.jit(JD.double_block, static_argnums=6)(
        jb, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(vec), jnp.asarray(cos),
        jnp.asarray(sin), CFG_J)
    js = jax.jit(JD.single_block, static_argnums=5)(
        jax.tree_util.tree_map(lambda a: a[0], jp["single_blocks"]),
        jnp.concatenate([ja, jt], axis=1), jnp.asarray(vec), jnp.asarray(cos), jnp.asarray(sin),
        CFG_J)
    c, s = torch.from_numpy(cos), torch.from_numpy(sin)
    with torch.no_grad():
        ta, tt = TD.double_block(model.double_blocks[0], torch.from_numpy(img),
                                 torch.from_numpy(txt), torch.from_numpy(vec), c, s, CFG_T)
        ts = TD.single_block(model.single_blocks[0], torch.cat([ta, tt], dim=1),
                             torch.from_numpy(vec), c, s, CFG_T)
    assert _rel(ta, ja) < TOL_F32 and _rel(tt, jt) < TOL_F32
    assert _rel(ts, js) < TOL_F32


@pytest.mark.parametrize("layout,dtype", [("diffsynth", "float32"), ("civitai", "float32"),
                                          ("diffsynth", "bfloat16")])
def test_dit_forward(layout, dtype):
    sd = dit_state_dict()
    if layout == "civitai":
        sd = civitai_state_dict(sd)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = JD.convert_hunyuan_video_dit(torch_sd(sd), CFG_J, dtype=jdt)
    model = port_dit(torch_sd(sd), dtype=tdt)
    x, t, emb, mask, pooled, g = _inputs()
    want = jax.jit(JD.hunyuan_video_dit_forward, static_argnums=1)(
        jp, CFG_J, jnp.asarray(x, jdt), jnp.asarray(t), jnp.asarray(emb, jdt),
        jnp.asarray(mask), jnp.asarray(pooled, jdt), jnp.asarray(g))
    with torch.no_grad():
        got = TD.hunyuan_video_dit_forward(model, torch.from_numpy(x).to(tdt),
                                           torch.from_numpy(t), torch.from_numpy(emb).to(tdt),
                                           torch.from_numpy(mask), torch.from_numpy(pooled).to(tdt),
                                           torch.from_numpy(g))
    assert got.shape == x.shape
    err = _rel(got.float(), np.asarray(want, np.float32))
    assert err < (TOL_F32 if dtype == "float32" else TOL_BF16), err


# ------------------------------------------------------------ VAE

def _jax_vae(enc_sd, dec_sd):
    return JV.convert_hunyuan_vae(enc_sd), JV.convert_hunyuan_vae(dec_sd)


def test_vae_encode_decode():
    enc_sd, dec_sd = vae_state_dicts()
    jenc, jdec = _jax_vae(enc_sd, dec_sd)
    enc, dec = port_vae(torch_sd(enc_sd), torch_sd(dec_sd))
    x = np.random.default_rng(0).standard_normal((1, 3, 5, 32, 32)).astype(np.float32)
    want_z = jax.jit(lambda p, v: JV.vae_encode(p, v, VAE_J))(jenc, jnp.asarray(x))
    want_y = jax.jit(lambda p, v: JV.vae_decode(p, v, VAE_J))(jdec, want_z)
    with torch.no_grad():
        got_z = TV.vae_encode(enc, torch.from_numpy(x))
        got_y = TV.vae_decode(dec, torch.from_numpy(np.array(want_z)))
    assert got_z.shape == (1, 4, 2, 4, 4) and got_y.shape == x.shape
    assert _rel(got_z, want_z) < TOL_VAE
    assert _rel(got_y, want_y) < TOL_VAE


def test_vae_tiled_decode_and_encode(monkeypatch):
    enc_sd, dec_sd = vae_state_dicts()
    jenc, jdec = _jax_vae(enc_sd, dec_sd)
    enc, dec = port_vae(torch_sd(enc_sd), torch_sd(dec_sd))
    rng = np.random.default_rng(1)
    z = rng.standard_normal((1, VAE_T.z_dim, 3, 4, 8)).astype(np.float32)
    x = rng.standard_normal((1, 3, 9, 32, 48)).astype(np.float32)
    # the JAX tilers call the module's encode / decode per tile: jitted here
    # (as the JAX tests patch them) so that the run stays short
    monkeypatch.setattr(JV, "vae_decode", jax.jit(JV.vae_decode, static_argnums=2))
    monkeypatch.setattr(JV, "vae_encode", jax.jit(JV.vae_encode, static_argnums=2))
    want_y = JV.tiled_decode(jdec, jnp.asarray(z), VAE_J, tile_size=(2, 4, 6),
                             tile_stride=(1, 2, 4))
    want_z = JV.tiled_encode(jenc, jnp.asarray(x), VAE_J, tile_size=(5, 32, 32),
                             tile_stride=(4, 16, 16))
    with torch.no_grad():
        got_y = TV.tiled_decode(dec, torch.from_numpy(z), tile_size=(2, 4, 6),
                                tile_stride=(1, 2, 4))
        got_z = TV.tiled_encode(enc, torch.from_numpy(x), tile_size=(5, 32, 32),
                                tile_stride=(4, 16, 16))
    assert got_y.shape == (1, 3, 9, 32, 64) and got_z.shape == (1, 4, 3, 4, 6)
    assert _rel(got_y, want_y) < TOL_VAE
    assert _rel(got_z, want_z) < TOL_VAE
    assert len(TV._tile_tasks(3, (4, 8), (2, 4, 6), (1, 2, 4))) == 4
    for args in ((3, (4, 8), (2, 4, 6), (1, 2, 4)), (9, (90, 160), (17, 30, 30), (12, 20, 20))):
        assert TV._tile_tasks(*args) == JV._tile_tasks(*args)


# ------------------------------------------------------------ pipeline

def _stub_video_latents(arr):
    """The JAX tests' stand-in for the tiled video encode."""
    return np.repeat(arr[:, :1], 16, 1)[:, :, ::4, ::8, ::8][:, :, :(arr.shape[2] - 1) // 4 + 1]


def _frames(n, h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _pipelines():
    """The JAX and port pipelines on the same tiny weights, fp32, with the
    JAX tests' stub prompt and video encodes (a 16-channel VAE for the
    image encode and the decode)."""
    sd = dit_state_dict()
    vcfg_j, vcfg_t = JV.HunyuanVAEConfig(**VAE16), TV.HunyuanVAEConfig(**VAE16)
    enc_sd, dec_sd = vae_state_dicts(vcfg_t)
    rng = np.random.default_rng(1)
    embs = {p: rng.standard_normal((1, CFG_T.txt_len, CFG_T.text_dim)).astype(np.float32)
            for p in ("a cat", "", "bad")}
    mask = np.ones((1, CFG_T.txt_len), np.int32)
    mask[:, 6:] = 0
    pooled = rng.standard_normal((1, CFG_T.pooled_dim)).astype(np.float32)

    jp = JP.HunyuanVideoPipeline(dtype=jnp.float32)
    jp.dit_cfg, jp.vae_cfg = CFG_J, vcfg_j
    jp.dit_params = JD.convert_hunyuan_video_dit(sd, CFG_J, dtype=jnp.float32)
    jp.vae_encoder_params, jp.vae_decoder_params = _jax_vae(enc_sd, dec_sd)
    jp.encode_prompt = lambda p: (jnp.asarray(embs.get(p, embs["a cat"])), jnp.asarray(mask),
                                  jnp.asarray(pooled))
    jp.encode_video = lambda arr, **k: jnp.asarray(_stub_video_latents(arr), jnp.float32)

    tp = TP.HunyuanVideoPipeline(device="cpu", dtype=torch.float32)
    tp.dit_cfg, tp.vae_cfg = CFG_T, vcfg_t
    tp.dit = port_dit(torch_sd(sd))
    tp.vae_encoder, tp.vae_decoder = port_vae(torch_sd(enc_sd), torch_sd(dec_sd), vcfg_t)
    tp.encode_prompt = lambda p: (torch.from_numpy(embs.get(p, embs["a cat"])),
                                  torch.from_numpy(mask), torch.from_numpy(pooled))
    tp.encode_video = lambda arr, **k: torch.from_numpy(_stub_video_latents(arr).copy())
    return jp, tp


@pytest.fixture
def pipes(monkeypatch):
    # the JAX VAE runs per tile op by op: jitted here to keep the test short
    monkeypatch.setattr(JV, "vae_decode", jax.jit(JV.vae_decode, static_argnums=2))
    monkeypatch.setattr(JV, "vae_encode", jax.jit(JV.vae_encode, static_argnums=2))
    return _pipelines()


BASE = dict(prompt="a cat", height=32, width=32, num_frames=5, seed=0, num_inference_steps=2)
REQUESTS = {
    "t2v": {},
    "v2v_cfg": dict(negative_prompt="bad", cfg_scale=2.0, input_video=_frames(5),
                    denoising_strength=0.8),
    "i2v": dict(input_images=_frames(1, seed=3)),
    "guidance_3": dict(embedded_guidance=3.0),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_pipeline_matches_jax(pipes, name):
    jp, tp = pipes
    kw = {**BASE, **REQUESTS[name]}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert got.shape == (1, 16, 2, 4, 4)
    assert _rel(got, want) < TOL_F32, _rel(got, want)
    if name == "i2v":       # the first latent frame is the image's encode
        np.testing.assert_array_equal(got[:, :, :1], tp(return_latents=True, **{
            **kw, "num_inference_steps": 3}).numpy()[:, :, :1])
    if name == "t2v":
        assert [s for s, _ in tp.stage_times] == ["denoise_step_0", "denoise_step_1"]
        # the whole path: each side's tiled decode to 8-bit frames
        vid_j = np.asarray(jp(**kw), np.int16)
        vid_t = np.asarray(tp(**kw), np.int16)
        assert vid_t.shape == (5, 32, 32, 3)
        assert np.abs(vid_t - vid_j).max() <= 1


def _recorded(monkeypatch, cls, log):
    check = cls.check

    def wrapped(self, modulated):
        skip = check(self, modulated)
        log.append(skip)
        return skip
    monkeypatch.setattr(cls, "check", wrapped)


@pytest.mark.parametrize("thresh", [0.5, 1e9])
def test_teacache_matches_jax(pipes, monkeypatch, thresh):
    jp, tp = pipes
    j_log, t_log = [], []
    _recorded(monkeypatch, JP.HunyuanTeaCache, j_log)
    _recorded(monkeypatch, TP.HunyuanTeaCache, t_log)
    kw = {**BASE, "num_inference_steps": 6, "tea_cache_l1_thresh": thresh}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert t_log == j_log
    assert any(t_log) and not all(t_log)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


# ------------------------------------------------------------ prompt path

def _clip_file(tmp_path):
    gen = torch.Generator().manual_seed(5)
    clip = init_clip_text_(ClipTextEncoder(CLIP_L_TINY), gen).eval()
    with torch.no_grad():
        for p in clip.parameters():     # non-zero biases, norms off 1
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    path = str(tmp_path / "clip_l.safetensors")
    safetensors_io.save_file(torch_sd(_reference_names(clip)), path)
    return path


def test_prompt_path_matches_jax(tmp_path, monkeypatch):
    """`fetch_llm` (LLaMA, two layers from the top, no final norm, the
    template, 95 rows dropped, 256 kept with their mask) and CLIP-L's pooled
    output, against the JAX pipeline's `fetch_llm(backend="native")` and
    `encode_prompt` on the same files; the JAX side reads its tokenizers
    through `transformers`, here the stand-ins."""
    import transformers
    llm_path = str(tmp_path / "llama.safetensors")
    safetensors_io.save_file(torch_sd(hf_text_sd(LLAMA, seed=3, prefix="")), llm_path)
    clip_path = _clip_file(tmp_path)
    llm_tok = TP.StubLlamaTokenizer(LLAMA["vocab_size"])
    clip_tok = StubClipTokenizer(CLIP_L_TINY.vocab)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: llm_tok))
    monkeypatch.setattr(transformers.CLIPTokenizer, "from_pretrained",
                        staticmethod(lambda path: clip_tok))
    monkeypatch.setattr(JCT, "sd3_text_encoder_1_forward", functools.partial(
        JCT.sd3_text_encoder_1_forward, num_layers=CLIP_L_TINY.num_layers,
        num_heads=CLIP_L_TINY.num_heads))
    monkeypatch.setattr(TP, "CLIP_L", CLIP_L_TINY)
    jp = JP.HunyuanVideoPipeline.from_pretrained(clip_path=clip_path, clip_tokenizer_path="tok",
                                                 dtype=jnp.float32)
    jp.fetch_llm(llm_path, "tok")
    tp = TP.HunyuanVideoPipeline.from_pretrained(clip_path=clip_path, clip_tokenizer_path="tok",
                                                 device="cpu", dtype=torch.float32)
    tp.fetch_llm(llm_path, llm_tok)
    for prompt in ("a red fox running through deep snow at dawn", ""):
        j_emb, j_mask, j_pooled = jp.encode_prompt(prompt)
        t_emb, t_mask, t_pooled = tp.encode_prompt(prompt)
        assert t_emb.shape == (1, 256, LLAMA["hidden"])
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
        assert _rel(t_emb, j_emb) < TOL_F32 and _rel(t_pooled, j_pooled) < TOL_F32
    assert [s for s, _ in tp.stage_times] == ["llm_encode", "clip_encode"] * 2
    with pytest.raises(ValueError, match="unknown LLM backend"):
        tp.fetch_llm(llm_path, llm_tok, backend="jax")
    tp.clip = None
    with pytest.raises(RuntimeError, match="no clip"):
        tp.encode_prompt("a fox")


# ------------------------------------------------------------ files and CLI

def _dit_files(tmp_path):
    sd = dit_state_dict()
    paths = {}
    for layout, layout_sd in (("diffsynth", sd), ("civitai", civitai_state_dict(sd))):
        paths[layout] = str(tmp_path / f"hunyuan_{layout}.safetensors")
        safetensors_io.save_file(torch_sd(layout_sd), paths[layout])
    return sd, paths


def test_detection_fault_and_load_model(tmp_path, monkeypatch):
    """The JAX detector calls a HunyuanVideo DiT file `flux_dit` in both
    layouts (its `double_blocks.` meet FLUX's BFL rule before the Hunyuan
    rule; ROADMAP Queue 3); the port detects it by its token refiner and
    `load_model` builds it from either layout, the same weights as the
    JAX converter's."""
    sd, paths = _dit_files(tmp_path)
    monkeypatch.setattr(TD, "HUNYUAN_VIDEO", CFG_T)
    jp = JD.convert_hunyuan_video_dit(sd, CFG_J, dtype=jnp.float32)
    for layout, path in paths.items():
        file_sd = TCK.load_state_dict(path)
        assert JCK.detect_model_kind(file_sd) == "flux_dit"
        assert TCK.detect_model_kind(file_sd) == "hunyuan_video_dit"
        kind, dit = TCK.load_model(path, device="cpu", dtype=torch.float32)
        assert kind == "hunyuan_video_dit" and dit.cfg == CFG_T
        np.testing.assert_array_equal(dit.single_blocks[1].ff["2"].weight.detach().numpy().T,
                                      np.asarray(jp["single_blocks"]["ff"]["2"]["w"][1]))
        np.testing.assert_array_equal(dit.single_blocks[0].to_out.bias.detach().numpy(),
                                      np.asarray(jp["single_blocks"]["to_out"]["b"][0]))
        np.testing.assert_array_equal(
            dit.txt_in.blocks[1].adaLN_modulation["1"].weight.detach().numpy().T,
            np.asarray(jp["txt_in"]["blocks"]["adaLN_modulation"]["1"]["w"][1]))
        np.testing.assert_array_equal(dit.img_in.proj.weight.detach().numpy().T,
                                      np.asarray(jp["img_in"]["proj"]["w"]))
    assert "hunyuan_video_dit" not in TCK.UNPORTED_KINDS


def test_unported_kinds_name_item_11f():
    """Item 11f (HunyuanDiT, OmniGen, StepVideo, SVD) built the last kinds:
    none is left unported, and `load_model` builds each of them."""
    assert TCK.UNPORTED_KINDS == {}
    assert set(TCK.FAMILY_KINDS) == {"hunyuan_dit", "omnigen", "stepvideo_text_encoder",
                                     "svd_unet", "svd_unet_exvideo"}
    assert "item 11f" not in str(TCK.unported("svd_unet"))


def _jax_video_gen():
    path = os.path.join(REPO, "examples", "video_gen.py")
    spec = importlib.util.spec_from_file_location("jax_examples_video_gen", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_runner_fault_and_port_cli(tmp_path, monkeypatch):
    """`examples/video_gen.py` `run_hunyuan_video` loads the DiT alone: no
    VAE, no CLIP-L, no tokenizer, and without --llm_path no LLM, so its
    request calls None at the prompt (a TypeError; ROADMAP Queue 3). The
    port's `video_gen --family hunyuan_video` raises a RuntimeError naming
    what it lacks."""
    _, paths = _dit_files(tmp_path)
    monkeypatch.setattr(JP, "HUNYUAN_VIDEO", CFG_J)
    a = argparse.Namespace(dit_path=paths["diffsynth"], llm_path=None, tokenizer_path=None,
                           prompt="a fox", num_frames=5, height=32, width=32, steps=1, seed=0)
    with pytest.raises(TypeError, match="not callable"):
        _jax_video_gen().run_hunyuan_video(a)
    with pytest.raises(RuntimeError, match="--vae_path, --clip_path, --clip_tokenizer_path, "
                                           "--llm_path"):
        video_gen.main(["--family", "hunyuan_video", "--dit_path", paths["diffsynth"],
                        "--device", "cpu"])


def test_video_gen_smoke_matches_jax(tmp_path, capsys, monkeypatch):
    """`video_gen --family hunyuan_video --smoke` writes a clip; its
    pipeline (tiny random DiT, VAE, CLIP-L and LLaMA, stand-in tokenizers)
    gives the JAX pipeline's latents and frames on the same weights and
    prompt embeddings."""
    out = tmp_path / "hunyuan.mp4"
    assert video_gen.main(["--family", "hunyuan_video", "--smoke", "--device", "cpu",
                           "--output", str(out)]) == 0
    assert out.stat().st_size > 0 and f"saved {out}" in capsys.readouterr().out
    monkeypatch.setattr(JV, "vae_decode", jax.jit(JV.vae_decode, static_argnums=2))
    tp = video_gen.build_hunyuan_video_smoke_pipeline(device="cpu", seed=0)
    a = video_gen.parse_args(["--family", "hunyuan_video", "--smoke", "--device", "cpu"])
    assert (a.num_frames, a.height, a.width, a.steps, a.cfg_scale) == (9, 64, 64, 2, 1.0)
    emb, mask, pooled = tp.encode_prompt(a.prompt)
    jcfg = JD.HunyuanVideoDiTConfig(**dataclasses.asdict(tp.dit_cfg))
    jp = JP.HunyuanVideoPipeline(dtype=jnp.float32)
    jp.dit_cfg = jcfg
    jp.vae_cfg = JV.HunyuanVAEConfig(**dataclasses.asdict(tp.vae_cfg))
    jp.dit_params = JD.convert_hunyuan_video_dit(
        diffsynth_names({k: v.numpy() for k, v in tp.dit.state_dict().items()}, tp.dit_cfg),
        jcfg, dtype=jnp.float32)
    jp.vae_decoder_params = JV.convert_hunyuan_vae(reference_vae_names(
        tp.vae_decoder, {k: v.numpy() for k, v in tp.vae_decoder.state_dict().items()}))
    jp.encode_prompt = lambda p: (jnp.asarray(emb.numpy()), jnp.asarray(mask.numpy()),
                                  jnp.asarray(pooled.numpy()))
    kw = dict(prompt=a.prompt, num_frames=a.num_frames, height=a.height, width=a.width,
              num_inference_steps=a.steps, seed=a.seed)
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert got.shape == (1, 16, 3, 8, 8) and _rel(got, want) < TOL_F32
    assert np.abs(np.asarray(tp(**kw), np.int16) - np.asarray(jp(**kw), np.int16)).max() <= 1
