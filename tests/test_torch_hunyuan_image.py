"""HunyuanDiT against the JAX package: the RoPE tables (bit-equal), the
CLIP-BERT (clip_skip 1 and 2), the DiT forward in fp32 and bf16, the raw
(civitai) renames, `convert.from_jax_params` of the DiT and the BERT tree,
`HunyuanImagePipeline` (t2v at CFG 1 and 7.5, img2img), mT5-XL's config,
the loaders (`load_model` on a DiT file), `image_gen --family
hunyuan_image` (its smoke, and the files it needs beside the JAX runner's),
and the port's `TileWorker` against the JAX one.

Weights: the reference's names drawn from a numpy seed (norms and biases
off their init), read by both packages' converters. Widths:
`HUNYUAN_DIT_TINY` (64 wide, 4 heads of 16, 4 + 2 blocks, 6 BERT + 8 mT5
text rows), `HUNYUAN_BERT_TINY` (24 wide, 2 heads; the JAX pipeline calls
its BERT with 16 heads whatever the tower, so the tests partial it to 2),
a 32-wide mT5, the SDXL VAE at its release widths. Tolerances: fp32 within
2e-5 relative L2 (the same arithmetic), bf16 within 2e-2 (rounding through
6 blocks in both packages); the pipelines' latents within 1e-4 (the VAE
encode's fp32 convolutions sum in another order).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.hunyuan_image_dit as JH
import video_styler_tpu.models.sd as JS
import video_styler_tpu.models.t5 as JT
import video_styler_tpu.pipelines.hunyuan_image as JP
from video_styler_tpu.ops.tiler import TileWorker as JTileWorker

import video_styler_tpu_torch.models.hunyuan_image_dit as TH
import video_styler_tpu_torch.models.sd as TS
import video_styler_tpu_torch.models.t5 as TT
import video_styler_tpu_torch.pipelines.hunyuan_image as TP
from video_styler_tpu_torch import image_gen, safetensors_io
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.ops.tiler import TileWorker
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_flux import _reference_names
from test_torch_fun import _rel
from test_torch_pipeline import _tree, cpu_share  # noqa: F401
from test_torch_sd_vae_text import _hf_t5_state_dict

TOL_F32 = 2e-5
TOL_BF16 = 2e-2
TOL_PIPE = 1e-4
CFG_T, CFG_J = TH.HUNYUAN_DIT_TINY, JH.HUNYUAN_DIT_TINY
BERT = TH.HUNYUAN_BERT_TINY
MT5 = TT.T5Config(vocab=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=4, num_layers=2,
                  shared_pos=True)


def draw_state_dict(module: torch.nn.Module, seed: int):
    """A module's state dict (numpy, its own names) from a numpy seed:
    weights of 2 dims and up N(0, 1/fan_in), norm weights 1 + N(0, 0.1^2),
    other vectors and tables N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        v = rng.standard_normal(shape, dtype=np.float32)
        if leaf == "weight" and len(shape) >= 2 and "embedding" not in name:
            v *= np.float32(1 / np.sqrt(np.prod(shape[1:])))
        elif leaf in ("weight", "scale") and ("norm" in name.lower()):
            v = 1 + np.float32(0.1) * v
        else:
            v *= np.float32(0.05)
        out[name] = v
    return out


def to_torch(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


# ------------------------------------------------------------ weights

def dit_state_dict(cfg=CFG_T, seed: int = 0):
    """The DiffSynth names: the patch embedding a (d, c, 2, 2) conv."""
    sd = draw_state_dict(TH.HunyuanImageDiT(cfg, device="meta"), seed)
    w = sd["patch_embedder.proj.weight"]
    sd["patch_embedder.proj.weight"] = w.reshape(w.shape[0], cfg.in_channels, cfg.patch_size,
                                                 cfg.patch_size)
    return sd


@functools.lru_cache(maxsize=None)
def _dit_sd():
    return dit_state_dict()


def port_dit(sd, dtype=torch.float32):
    return TC.build_module(TH.HunyuanImageDiT, CFG_T,
                           TH.convert_hunyuan_image_dit(to_torch(sd), CFG_T), "cpu", dtype)


@functools.lru_cache(maxsize=None)
def _bert_sd():
    sd = draw_state_dict(TH.HunyuanBert(BERT, device="meta"), 3)
    sd["pooler.dense.weight"] = np.eye(BERT.dim, dtype=np.float32)     # read by neither
    return sd


def port_bert(sd=None, dtype=torch.float32):
    sd = to_torch(_bert_sd() if sd is None else sd)
    return TC.build_module(TH.HunyuanBert, BERT, TH.convert_hunyuan_bert(sd, BERT), "cpu", dtype)


def jax_bert(dtype=jnp.float32):
    return JH.convert_hunyuan_bert(to_torch(_bert_sd()), num_layers=BERT.num_layers, dtype=dtype)


def _dit_inputs(seed: int = 4, h: int = 8, w: int = 12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 4, h, w)).astype(np.float32)
    te = rng.standard_normal((1, CFG_T.text_length, CFG_T.text_dim)).astype(np.float32)
    t5 = rng.standard_normal((1, CFG_T.t5_length, CFG_T.t5_dim)).astype(np.float32)
    m = np.ones((1, CFG_T.text_length), np.int32)
    m[:, 4:] = 0
    m5 = np.ones((1, CFG_T.t5_length), np.int32)
    m5[:, 5:] = 0
    t = np.array([731.0], np.float32)
    size = np.array([[8 * w, 8 * h, 8 * w, 8 * h, 0, 0]], np.float32)
    return x, te, t5, m, m5, t, size


# ------------------------------------------------------------ DiT

@pytest.mark.parametrize("cfg_t,cfg_j,size", [(CFG_T, CFG_J, (8, 12)),
                                              (TH.HUNYUAN_DIT, JH.HUNYUAN_DIT, (128, 96))])
def test_rope_bit_equal(cfg_t, cfg_j, size):
    for a, b in zip(TH.hunyuan_image_rope(cfg_t, *size), JH.hunyuan_image_rope(cfg_j, *size)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dit_forward_matches_jax(dtype):
    sd = _dit_sd()
    td, jd = (torch.float32, jnp.float32) if dtype == "fp32" else (torch.bfloat16, jnp.bfloat16)
    inputs = _dit_inputs()
    jp = JH.convert_hunyuan_image_dit(to_torch(sd), CFG_J, dtype=jd)
    ja = [jnp.asarray(a, jd if a.dtype == np.float32 and i in (0, 1, 2) else None)
          for i, a in enumerate(inputs)]
    want = jax.jit(JH.hunyuan_image_dit_forward, static_argnums=1)(jp, CFG_J, *ja)
    ta = [torch.from_numpy(a).to(td) if i in (0, 1, 2) else torch.from_numpy(a)
          for i, a in enumerate(inputs)]
    with torch.no_grad():
        got = TH.hunyuan_image_dit_forward(port_dit(sd, td), *ta)
    assert got.shape == (1, 4, 8, 12)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < (
        TOL_F32 if dtype == "fp32" else TOL_BF16)


def _civitai(sd):
    """The raw layout of a DiffSynth state dict: fused Wqkv / kv_proj, the
    reference's other names (the inverse of the renames)."""
    out = {}
    for name, v in sd.items():
        n = name
        for a, b in ((".modulation.", ".default_modulation."), (".mlp.0.", ".mlp.fc1."),
                     (".mlp.2.", ".mlp.fc2."), (".rota1.q_norm.", ".attn1.q_norm."),
                     (".rota2.q_norm.", ".attn2.q_norm."), (".rota1.k_norm.", ".attn1.k_norm."),
                     (".rota2.k_norm.", ".attn2.k_norm."), (".to_out.", ".out_proj."),
                     ("text_emb_padding", "text_embedding_padding"),
                     ("t5_embedder.", "mlp_t5."), ("t5_pooler.", "pooler."),
                     ("patch_embedder.", "x_embedder."), ("timestep_embedder.", "t_embedder.")):
            n = n.replace(a, b)
        out[n] = v
    for i in range(CFG_T.num_layers_down + CFG_T.num_layers_up):
        b = f"blocks.{i}"
        for leaf in ("weight", "bias"):
            out[f"{b}.attn1.Wqkv.{leaf}"] = np.concatenate(
                [out.pop(f"{b}.attn1.to_{x}.{leaf}") for x in "qkv"])
            out[f"{b}.attn2.q_proj.{leaf}"] = out.pop(f"{b}.attn2.to_q.{leaf}")
            out[f"{b}.attn2.kv_proj.{leaf}"] = np.concatenate(
                [out.pop(f"{b}.attn2.to_{x}.{leaf}") for x in "kv"])
    return out


def test_civitai_layout_and_from_jax_params():
    """The raw names convert to the same DiT in both packages, and
    `from_jax_params` of the JAX tree gives the port's module."""
    sd = _dit_sd()
    raw = to_torch(_civitai(sd))
    assert set(TH.rename_civitai_hunyuan_image(raw)) == set(JH.rename_civitai_hunyuan_image(raw))
    want = port_dit(sd).state_dict()
    got = TC.build_module(TH.HunyuanImageDiT, CFG_T, TH.convert_hunyuan_image_dit(raw, CFG_T),
                          "cpu", torch.float32).state_dict()
    tree = from_jax_params("hunyuan_dit", _tree(JH.convert_hunyuan_image_dit(
        raw, CFG_J, dtype=jnp.float32)), CFG_T, device="cpu").state_dict()
    assert sorted(got) == sorted(want) == sorted(tree)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(tree[k], want[k], rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ BERT

@pytest.mark.parametrize("clip_skip", [1, 2])
def test_bert_matches_jax(clip_skip):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, BERT.vocab, (1, 12))
    mask = np.ones((1, 12), np.int64)
    mask[:, 9:] = 0
    want = JH.hunyuan_bert_forward(jax_bert(), jnp.asarray(ids), jnp.asarray(mask),
                                   clip_skip=clip_skip, num_heads=BERT.num_heads)
    with torch.no_grad():
        got = TH.hunyuan_bert_forward(port_bert(), torch.from_numpy(ids),
                                      torch.from_numpy(mask), clip_skip=clip_skip)
    assert _rel(got.numpy(), want) < TOL_F32


def test_bert_from_jax_params_and_mt5_config():
    want = port_bert().state_dict()
    got = from_jax_params("hunyuan_bert", _tree(jax_bert()), BERT, device="cpu").state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    import dataclasses
    assert dataclasses.asdict(TT.MT5_XL) == dataclasses.asdict(JT.MT5_XL)


# ------------------------------------------------------------ pipeline

@functools.lru_cache(maxsize=None)
def _vae():
    gen = torch.Generator().manual_seed(8)
    return (TS.init_sd_module_(TS.SDVAEEncoder(), gen).eval(),
            TS.init_sd_module_(TS.SDVAEDecoder(), gen).eval())


def _pipelines():
    enc, dec = _vae()
    t5_sd = _hf_t5_state_dict(MT5, seed=6)
    tp = TP.HunyuanImagePipeline(device="cpu", dtype=torch.float32)
    tp.dit_cfg = CFG_T
    tp.dit = port_dit(_dit_sd())
    tp.bert = port_bert()
    tp.t5 = TC.build_module(TT.T5Encoder, MT5, TT.convert_hf_t5(t5_sd, MT5), "cpu",
                            torch.float32)
    tp.vae_encoder, tp.vae_decoder = enc, dec
    tp.tokenizer = TP.StubBertTokenizer(BERT.vocab)
    tp.tokenizer_t5 = TP.StubMT5Tokenizer(MT5.vocab)
    jp = JP.HunyuanImagePipeline(dtype=jnp.float32)
    jp.dit_cfg = CFG_J
    jp.dit_params = JH.convert_hunyuan_image_dit(to_torch(_dit_sd()), CFG_J, dtype=jnp.float32)
    jp.bert_params = jax_bert()
    jp.t5_cfg = JT.T5Config(**{k: getattr(MT5, k) for k in MT5.__dataclass_fields__})
    jp.t5_params = JT.convert_hf_t5(t5_sd, jp.t5_cfg, dtype=jnp.float32)
    jp.vae_encoder_params = JS.convert_sd_module(_reference_names(enc))
    jp.vae_decoder_params = JS.convert_sd_module(_reference_names(dec))
    jp.tokenizer, jp.tokenizer_t5 = tp.tokenizer, tp.tokenizer_t5
    return tp, jp


@pytest.fixture
def tiny_jax_bert(monkeypatch):
    """The JAX pipeline calls its BERT with 16 heads; the tiny tower has 2."""
    monkeypatch.setattr(JH, "hunyuan_bert_forward", functools.partial(
        JH.hunyuan_bert_forward, num_heads=BERT.num_heads))
    for name in ("sd_vae_encoder_forward", "sd_vae_decoder_forward"):
        monkeypatch.setattr(JS, name, jax.jit(getattr(JS, name)))


@pytest.mark.parametrize("case", ["cfg 1", "cfg 7.5", "img2img"])
def test_pipeline_matches_jax(tiny_jax_bert, case):
    tp, jp = _pipelines()
    kw = dict(prompt="a lighthouse at dawn", negative_prompt="blurry", height=64, width=96,
              num_inference_steps=2, seed=3, return_latents=True,
              cfg_scale=1.0 if case == "cfg 1" else 7.5)
    if case == "img2img":
        rng = np.random.default_rng(7)
        from PIL import Image
        kw.update(input_image=Image.fromarray(rng.integers(0, 256, (64, 96, 3), np.uint8)),
                  denoising_strength=0.7)
    want = np.asarray(jp(**kw), np.float32)
    got = tp(**kw)
    assert got.shape == (1, 4, 8, 12)
    assert _rel(got.numpy(), want) < TOL_PIPE
    if case == "cfg 1":
        with torch.no_grad():
            image = tp.vae_output_to_image(TS.sd_vae_decoder_forward(tp.vae_decoder, got))
        assert image.size == (96, 64)


def test_pipeline_without_text_towers_raises():
    tp = TP.HunyuanImagePipeline(device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no bert, t5, tokenizer, tokenizer_t5"):
        tp.encode_prompt("x")


# ------------------------------------------------------------ loaders, CLI

def test_load_model_builds_hunyuan_dit(tmp_path, monkeypatch):
    monkeypatch.setattr(TH, "HUNYUAN_DIT", CFG_T)
    path = str(tmp_path / "hunyuan_dit.safetensors")
    safetensors_io.save_file(to_torch(_civitai(_dit_sd())), path)
    kind, model = TC.load_model(path, device="cpu", dtype=torch.float32)
    assert kind == "hunyuan_dit" and isinstance(model, TH.HunyuanImageDiT)
    for k, v in port_dit(_dit_sd()).state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_image_gen_cli(tmp_path, capsys):
    """The smoke runs; without the text towers the CLI names them, where
    the JAX runner loads the DiT and the VAE alone and its request calls
    None at the prompt."""
    out = tmp_path / "h.png"
    assert image_gen.main(["--family", "hunyuan_image", "--smoke", "--device", "cpu",
                           "--height", "16", "--width", "16", "--output", str(out)]) == 0
    assert out.stat().st_size > 0 and f"saved {out}" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="--clip_path, --t5_path"):
        image_gen.main(["--family", "hunyuan_image", "--dit_path", "d", "--vae_path", "v",
                        "--device", "cpu"])
    jp = JP.HunyuanImagePipeline(dtype=jnp.float32)
    with pytest.raises(TypeError, match="NoneType"):
        jp.encode_prompt("x")


# ------------------------------------------------------------ TileWorker

@pytest.mark.parametrize("size,tile,stride,scale", [((20, 28), 8, 6, 1), ((16, 16), 8, 4, 2)])
def test_tile_worker_matches_jax(size, tile, stride, scale):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3) + size).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)

    def fwd_np(t):
        y = np.einsum("oc,bchw->bohw", w, np.asarray(t, np.float32))
        return y.repeat(scale, 2).repeat(scale, 3)

    want = JTileWorker().tiled_forward(lambda t: jnp.asarray(fwd_np(t)), x, tile, stride,
                                       tile_batch_size=3)
    got = TileWorker().tiled_forward(lambda t: torch.from_numpy(fwd_np(t.numpy())), x, tile,
                                     stride, tile_batch_size=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
