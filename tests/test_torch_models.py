"""PyTorch port vs JAX package: flow-match scheduler, DiT block, VACE
branch, full DiT forward with VACE hints, umT5 encoder and the prompter.

Weights are drawn by the JAX package's own init from a fixed key and carried
into the port with `from_jax_params`; inputs come from numpy seeds. Widths:
head_dim 128 with 2 heads (dim 256), 2 layers. fp32 cases hold to 1e-4
relative (a few hundred fp32 ops deep, summation orders differ); bf16 cases
to a few bf16 ULPs (each layer rounds at its own points and one rounding
can flip either way).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.models.wan_vace as JV
import video_styler_tpu.models.t5 as JT
from video_styler_tpu.ops.rope import assemble_freqs_grid as j_freqs
from video_styler_tpu.prompters.wan_prompter import WanPrompter as JPrompter
from video_styler_tpu.schedulers.flow_match import FlowMatchScheduler as JSched

import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vace as TV
import video_styler_tpu_torch.models.t5 as TT
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.ops.rope import assemble_freqs_grid as t_freqs
from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer, WanPrompter
from video_styler_tpu_torch.schedulers.flow_match import FlowMatchScheduler as TSched

DIT = dict(dim=256, in_dim=4, ffn_dim=512, out_dim=4, num_heads=2,
           num_layers=2, text_dim=64, freq_dim=32)
VACE = dict(vace_layers=(0, 1), vace_in_dim=72, dim=256, num_heads=2, ffn_dim=512)
T5 = dict(vocab=128, dim=64, dim_attn=64, dim_ffn=128, num_heads=4,
          num_layers=2, num_buckets=8)
JDTYPE = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = {"fp32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=4e-2, atol=4e-2)}


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(t, j, which):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL[which])


def _models(which):
    jd = JDTYPE[which]
    jcfg = JD.WanDiTConfig(**DIT)
    jvcfg = JV.VaceConfig(**VACE)
    jp = JD.init_wan_dit(jax.random.PRNGKey(0), jcfg, jd)
    jvp = JV.init_vace(jax.random.PRNGKey(1), jvcfg, jd)
    dit = from_jax_params("dit", _np_tree(jp), TD.WanDiTConfig(**DIT), device="cpu")
    vace = from_jax_params("vace", _np_tree(jvp), TV.VaceConfig(**VACE), device="cpu")
    return (jcfg, jp, jvcfg, jvp), (dit, vace)


def test_scheduler_matches_jax():
    j = JSched(shift=5.0, sigma_min=0.0, extra_one_step=True)
    t = TSched(shift=5.0, sigma_min=0.0, extra_one_step=True)
    for steps, strength in ((50, 1.0), (7, 0.6)):
        j.set_timesteps(steps, denoising_strength=strength, shift=5.0)
        t.set_timesteps(steps, denoising_strength=strength, shift=5.0)
        np.testing.assert_array_equal(t.sigmas, j.sigmas)
        np.testing.assert_array_equal(t.timesteps, j.timesteps)
        for i in range(steps):
            assert t.sigma_pair(i) == j.sigma_pair(i)
    x, v = _rand(0, (2, 3)), _rand(1, (2, 3))
    np.testing.assert_array_equal(t.step(v, t.timesteps[2], x),
                                  j.step(v, j.timesteps[2], x))
    np.testing.assert_array_equal(t.add_noise(x, v, t.timesteps[0]),
                                  j.add_noise(x, v, j.timesteps[0]))


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_dit_block_matches_jax(which):
    (jcfg, jp, _, _), (dit, _) = _models(which)
    f, h, w = 2, 3, 4
    x = _rand(2, (1, f * h * w, 256))
    ctx = _rand(3, (1, 12, 256))
    t_mod = _rand(4, (1, 6, 256), 0.1)
    jd, td = JDTYPE[which], TDTYPE[which]
    cos_j, sin_j = j_freqs(128, f, h, w)
    cos_t, sin_t = t_freqs(128, f, h, w)
    block0 = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    want = JD.dit_block(block0, jnp.asarray(x, jd), jnp.asarray(ctx, jd),
                        jnp.asarray(t_mod, jd), cos_j, sin_j, jcfg)
    with torch.no_grad():
        got = TD.dit_block(dit.blocks[0], torch.from_numpy(x).to(td),
                           torch.from_numpy(ctx).to(td),
                           torch.from_numpy(t_mod).to(td), cos_t, sin_t, dit.cfg)
    assert got.dtype == td
    _close(got, want, which)


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_vace_forward_matches_jax(which):
    (jcfg, _, jvcfg, jvp), (_, vace) = _models(which)
    jd, td = JDTYPE[which], TDTYPE[which]
    f, h, w = 3, 4, 4
    tokens = _rand(5, (1, f * h * w, 256))
    vctx = _rand(6, (1, 72, f, 2 * h, 2 * w))
    ctx = _rand(7, (1, 12, 256))
    t_mod = _rand(8, (1, 6, 256), 0.1)
    cos_j, sin_j = j_freqs(128, f, h, w)
    cos_t, sin_t = t_freqs(128, f, h, w)
    want = JV.vace_forward(jvp, jvcfg, jnp.asarray(tokens, jd),
                           jnp.asarray(vctx, jd), jnp.asarray(ctx, jd),
                           jnp.asarray(t_mod, jd), cos_j, sin_j)
    with torch.no_grad():
        got = TV.vace_forward(vace, torch.from_numpy(tokens).to(td),
                              torch.from_numpy(vctx).to(td),
                              torch.from_numpy(ctx).to(td),
                              torch.from_numpy(t_mod).to(td), cos_t, sin_t)
    assert len(got) == 2
    for i in range(2):
        _close(got[i], want[i], which)


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_wan_dit_forward_with_vace_matches_jax(which):
    (jcfg, jp, jvcfg, jvp), (dit, vace) = _models(which)
    jd, td = JDTYPE[which], TDTYPE[which]
    x = _rand(9, (1, 4, 3, 8, 8))
    ctx = _rand(10, (1, 12, 64))
    vctx = _rand(11, (1, 72, 3, 8, 8))
    t = np.array([731.0], np.float32)
    want = JD.wan_dit_forward(jp, jcfg, jnp.asarray(x, jd), jnp.asarray(t),
                              jnp.asarray(ctx, jd), vace_params=jvp,
                              vace_cfg=jvcfg, vace_context=jnp.asarray(vctx, jd),
                              vace_scale=0.8)
    with torch.no_grad():
        got = TD.wan_dit_forward(dit, torch.from_numpy(x).to(td),
                                 torch.from_numpy(t), torch.from_numpy(ctx).to(td),
                                 vace=vace, vace_context=torch.from_numpy(vctx).to(td),
                                 vace_scale=0.8)
    assert got.shape == (1, 4, 3, 8, 8) and got.dtype == td
    _close(got, want, which)


def test_t5_encode_and_prompter_match_jax():
    jcfg = JT.T5Config(**T5)
    jp = JT.init_t5(jax.random.PRNGKey(2), jcfg)
    t5 = from_jax_params("t5", _np_tree(jp), TT.T5Config(**T5), device="cpu")
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    want = JT.t5_encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = TT.t5_encode(t5, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    jpr = JPrompter(text_len=16, cfg=jcfg)
    jpr.tokenizer = StubTokenizer(16)
    jpr.fetch_models(jp)
    tpr = WanPrompter(StubTokenizer(16), 16, t5)
    prompt = "  a cat &amp;amp;   a dog \n in the rain "
    for dt_j, dt_t, tol in ((jnp.float32, torch.float32, 1e-4),
                            (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = jpr.encode_prompt(prompt, dtype=dt_j)
        got = tpr.encode_prompt(prompt, dtype=dt_t)
        assert got.dtype == dt_t and got.shape == (1, 16, 64)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    # 8 cleaned words -> 9 stub tokens; embeddings past them are zeroed
    assert np.all(got[0, 9:].float().numpy() == 0)
    assert np.any(got[0, 8].float().numpy() != 0)


def test_config_constants_match_jax():
    assert dataclasses.asdict(TD.WAN_T2V_14B) == {
        k: v for k, v in dataclasses.asdict(JD.WAN_T2V_14B).items()
        if k in {f.name for f in dataclasses.fields(TD.WanDiTConfig)}}
    assert dataclasses.asdict(TV.VACE_14B) == {
        k: v for k, v in dataclasses.asdict(JV.VACE_14B).items()
        if k != "has_image_input"}
    assert dataclasses.asdict(TT.UMT5_XXL) == {
        k: v for k, v in dataclasses.asdict(JT.UMT5_XXL).items() if k != "shared_pos"}
