"""The FLUX path's shared towers against the JAX package: the SD3 / FLUX
16-channel image VAE (encoder and decoder, fp32, 64x64), CLIP-L (`pooled`
at the largest id, `hidden` at `clip_skip`), T5 v1.1 (one bias table in
layer 0) and `convert_hf_t5` from a synthetic HF state dict, umT5's configs
unchanged by `shared_pos`, and `load_model` on synthetic FLUX DiT files
(the other unported kinds still raise).

The JAX package has no init for the VAE or CLIP-L: the port draws them
(torch seed; biases and norms off their defaults) and both converters read
the state dict under the reference's names. T5 comes from the JAX init.
fp32 within 2e-5 relative L2.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.flux_dit as JF
import video_styler_tpu.models.sd3_text_encoder as JCT
import video_styler_tpu.models.sd3_vae as JV
import video_styler_tpu.models.t5 as JT

import video_styler_tpu_torch.models.flux_dit as TF
import video_styler_tpu_torch.models.sd3_text_encoder as TCT
import video_styler_tpu_torch.models.sd3_vae as TV
import video_styler_tpu_torch.models.t5 as TT
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.safetensors_io import save_file
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_flux import _bfl_state_dict, _dit_tree, _port_cfg, _reference_names
from test_torch_fun import _rel
from test_torch_pipeline import _tree, cpu_share  # noqa: F401

TOL_F32 = 2e-5


def _perturbed(module, seed: int):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module.eval()


# ------------------------------------------------------------ the image VAE

@pytest.mark.parametrize("name", ["FLUX_VAE", "SD3_VAE"])
def test_vae_encoder_decoder_match_jax(name):
    """The release widths (128-512), with the FLUX and the SD3 affine."""
    cfg, jcfg = getattr(TV, name), getattr(JV, name)
    gen = torch.Generator().manual_seed(11)
    enc = TV.init_sd3_vae_(TV.SD3VAEEncoder(cfg), gen).eval()
    dec = TV.init_sd3_vae_(TV.SD3VAEDecoder(cfg), gen).eval()
    x = np.random.default_rng(12).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)

    j_enc = JV.convert_sd3_vae(_reference_names(enc))
    j_dec = JV.convert_sd3_vae(_reference_names(dec))
    want_z = np.asarray(jax.jit(lambda p, s: JV.sd3_vae_encoder_forward(p, s, jcfg))(
        j_enc, jnp.asarray(x)))
    want_y = np.asarray(jax.jit(lambda p, s: JV.sd3_vae_decoder_forward(p, s, jcfg))(
        j_dec, jnp.asarray(want_z)))
    # the port's converter, and `from_jax_params` of the JAX one, give the
    # same modules
    for side, mod, tree in (("sd3_vae_encoder", enc, j_enc), ("sd3_vae_decoder", dec, j_dec)):
        port = type(mod)(cfg)
        port.load_state_dict(TV.convert_sd3_vae(
            {k: torch.from_numpy(v) for k, v in _reference_names(mod).items()}), strict=True)
        ref = from_jax_params(side, _tree(tree), cfg, device="cpu").state_dict()
        for k, v in port.state_dict().items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)
    with torch.no_grad():
        got_z = TV.sd3_vae_encoder_forward(enc, torch.from_numpy(x), cfg).numpy()
        got_y = TV.sd3_vae_decoder_forward(dec, torch.tensor(want_z), cfg).numpy()
    assert got_z.shape == (1, 16, 8, 8) and got_y.shape == (1, 3, 64, 64)
    assert _rel(got_z, want_z) < TOL_F32, _rel(got_z, want_z)
    assert _rel(got_y, want_y) < TOL_F32, _rel(got_y, want_y)


def test_vae_downsample_pads_right_and_bottom():
    """The encoder's stride-2 conv sees (0, 1) padding on each spatial axis:
    an odd-sized input keeps its top-left alignment."""
    from video_styler_tpu.models.sd import downsample as j_down
    from video_styler_tpu_torch.models.sd import Resample, downsample
    rng = np.random.default_rng(13)
    blk = _perturbed(Resample(4), 14)
    x = rng.standard_normal((1, 4, 7, 6)).astype(np.float32)
    with torch.no_grad():
        got = downsample(blk, torch.from_numpy(x), padding=0, extra_padding=True).numpy()
    want = np.asarray(j_down({"conv": {"weight": blk.conv.weight.detach().numpy(),
                                       "bias": blk.conv.bias.detach().numpy()}},
                             jnp.asarray(x), padding=0, extra_padding=True))
    assert got.shape == (1, 4, 3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ CLIP-L

def _clip_ids():
    """Two rows of 77 ids; the largest id (the EOS of CLIP's vocabulary) at
    positions 9 and 76, row 0 padded with it after its EOS."""
    ids = np.random.default_rng(15).integers(1, 998, (2, 77)).astype(np.int64)
    ids[0, 9:] = 999
    ids[1, 76] = 999
    return ids


@pytest.mark.parametrize("clip_skip", [1, 2])
def test_clip_l_matches_jax(clip_skip):
    """CLIP-L's widths (12 layers of 768, 12 heads) over a 1,000-id vocabulary."""
    cfg = dataclasses.replace(TCT.CLIP_L, vocab=1000)
    model = _perturbed(TCT.init_clip_text_(TCT.ClipTextEncoder(cfg),
                                           torch.Generator().manual_seed(16)), 17)
    ids = _clip_ids()
    params = JCT.convert_sd3_text_encoder_1(_reference_names(model))
    want_p, want_h = jax.jit(lambda p, i: JCT.sd3_text_encoder_1_forward(
        p, i, clip_skip=clip_skip))(params, jnp.asarray(ids))
    port = from_jax_params("clip_l_text", _tree(params), cfg, device="cpu")
    with torch.no_grad():
        got_p, got_h = TCT.sd3_text_encoder_1_forward(port, torch.from_numpy(ids),
                                                      clip_skip=clip_skip)
    assert got_p.shape == (2, 768) and got_h.shape == (2, 77, 768)
    assert _rel(got_h.numpy(), want_h) < TOL_F32, _rel(got_h.numpy(), want_h)
    assert _rel(got_p.numpy(), want_p) < TOL_F32, _rel(got_p.numpy(), want_p)
    # pooled is the final-norm row at the first largest id
    with torch.no_grad():
        _, last = TCT.sd3_text_encoder_1_forward(port, torch.from_numpy(ids), clip_skip=0)
    np.testing.assert_array_equal(got_p.numpy(), last.numpy()[[0, 1], [9, 76]])


# ------------------------------------------------------------ T5

@pytest.mark.parametrize("masked", [False, True])
def test_t5_v11_matches_jax(masked):
    jt = _tree(JT.init_t5(jax.random.PRNGKey(18), JT.T5_V11_TINY))
    assert sorted(jt["blocks"]["0"]) != sorted(jt["blocks"]["1"])  # bias in layer 0 only
    model = from_jax_params("t5", jt, TT.T5_V11_TINY, device="cpu")
    assert hasattr(model.blocks[0], "pos_emb") and not hasattr(model.blocks[1], "pos_emb")
    ids = np.random.default_rng(19).integers(0, 128, (2, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < np.array([[16], [11]])).astype(np.int32) if masked else None
    want = np.asarray(JT.t5_encode(jt, JT.T5_V11_TINY, jnp.asarray(ids),
                                   None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = TT.t5_encode(model, torch.from_numpy(ids),
                           None if mask is None else torch.from_numpy(mask)).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def _hf_t5_state_dict(cfg, seed: int = 20):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)

    sd = {"shared.weight": w(cfg.vocab, cfg.dim),
          "encoder.embed_tokens.weight": w(cfg.vocab, cfg.dim),   # tied copy, unread
          "encoder.final_layer_norm.weight": 1 + 0.1 * w(cfg.dim)}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        for name in "qkv":
            sd[f"{pre}.0.SelfAttention.{name}.weight"] = w(cfg.dim_attn, cfg.dim)
        sd[f"{pre}.0.SelfAttention.o.weight"] = w(cfg.dim, cfg.dim_attn)
        sd[f"{pre}.0.layer_norm.weight"] = 1 + 0.1 * w(cfg.dim)
        sd[f"{pre}.1.layer_norm.weight"] = 1 + 0.1 * w(cfg.dim)
        sd[f"{pre}.1.DenseReluDense.wi_0.weight"] = w(cfg.dim_ffn, cfg.dim)
        sd[f"{pre}.1.DenseReluDense.wi_1.weight"] = w(cfg.dim_ffn, cfg.dim)
        sd[f"{pre}.1.DenseReluDense.wo.weight"] = w(cfg.dim, cfg.dim_ffn)
    sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = w(
        cfg.num_buckets, cfg.num_heads)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def test_convert_hf_t5_matches_jax():
    sd = _hf_t5_state_dict(TT.T5_V11_TINY)
    port = TT.T5Encoder(TT.T5_V11_TINY)
    port.load_state_dict(TT.convert_hf_t5(sd, TT.T5_V11_TINY), strict=True)
    ref = from_jax_params("t5", _tree(JT.convert_hf_t5(sd, JT.T5_V11_TINY, dtype=jnp.float32)),
                          TT.T5_V11_TINY, device="cpu")
    want = ref.state_dict()
    assert sorted(port.state_dict()) == sorted(want)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    ids = torch.randint(0, 128, (1, 12), generator=torch.Generator().manual_seed(21))
    with torch.no_grad():
        torch.testing.assert_close(TT.t5_encode(port, ids), TT.t5_encode(ref, ids),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("name", ["UMT5_XXL", "T5_V11_XXL", "T5_V11_TINY"])
def test_t5_configs_match_jax(name):
    """`shared_pos` defaults to False: umT5 keeps a table a layer."""
    assert dataclasses.asdict(getattr(TT, name)) == dataclasses.asdict(getattr(JT, name))
    assert TT.UMT5_XXL.shared_pos is False and TT.T5Config().shared_pos is False


def test_umt5_keeps_a_table_per_layer():
    """The JAX package's T5_TINY (umT5's semantics at tiny width)."""
    cfg = TT.T5Config(**dataclasses.asdict(JT.T5_TINY))
    assert cfg.shared_pos is False
    jt = _tree(JT.init_t5(jax.random.PRNGKey(22), JT.T5_TINY))
    model = from_jax_params("t5", jt, cfg, device="cpu")
    assert all(hasattr(b, "pos_emb") for b in model.blocks)
    ids = np.random.default_rng(23).integers(0, 128, (1, 10)).astype(np.int32)
    want = np.asarray(JT.t5_encode(jt, JT.T5_TINY, jnp.asarray(ids)))
    with torch.no_grad():
        got = TT.t5_encode(model, torch.from_numpy(ids)).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


# ------------------------------------------------------------ load_model

@pytest.mark.parametrize("guidance", [True, False], ids=["dev", "schnell"])
def test_load_model_builds_flux_dit(tmp_path, monkeypatch, guidance):
    """A BFL-layout file is detected as `flux_dit` and built as FLUX.1-dev
    or schnell by the guidance rule (both configs made tiny here, as the
    tests of the Wan loaders make UMT5_XXL tiny)."""
    cfg, tree = _dit_tree(guidance)
    src = from_jax_params("flux_dit", tree, _port_cfg(cfg), device="cpu")
    path = str(tmp_path / "flux1.safetensors")
    save_file(_bfl_state_dict(src), path)
    monkeypatch.setattr(TF, "FLUX_DEV", _port_cfg(dataclasses.replace(cfg, guidance_embed=True)))
    monkeypatch.setattr(TF, "FLUX_SCHNELL",
                        _port_cfg(dataclasses.replace(cfg, guidance_embed=False)))
    kind, model = TC.load_model(path, device="cpu", dtype=torch.float32)
    assert kind == "flux_dit"
    assert isinstance(model, TF.FluxDiT) and model.cfg.guidance_embed == guidance
    for k, v in src.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    assert "flux_dit" not in TC.UNPORTED_KINDS
    jkind = __import__("video_styler_tpu.utils.ckpt", fromlist=["x"]).detect_model_kind(
        TC.load_state_dict(path))
    assert jkind == "flux_dit"


@pytest.mark.parametrize("keys,kind", [
    (["single_blocks.0.linear1.weight"], "hunyuan_video_dit"),
    (["llm.layers.0.mlp.weight"], "omnigen"),
    (["down_blocks.0.resnets.0.mix_factor"], "svd_unet")])
def test_load_model_other_kinds_still_raise(tmp_path, keys, kind):
    """Kinds the port does not build yet (FLUX's adapters and SD3 load:
    `test_torch_flux_adapters.py`, `test_torch_sd3.py`; the SD family's
    kinds: `test_torch_sd.py`)."""
    path = str(tmp_path / "m.safetensors")
    save_file({k: torch.zeros(2, 2) for k in keys}, path)
    assert TC.detect_model_kind(TC.load_state_dict(path)) == kind
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        TC.load_model(path, device="cpu")
