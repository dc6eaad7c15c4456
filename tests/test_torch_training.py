"""The port's LoRA training slice against the JAX package: scheduler training
tables, flow-match loss, LoRA init/apply/export/merge, AdamW against
optax.adamw, one whole train step against JAX's value_and_grad of the
examples/train.py composition, the safetensors writer/reader, and the
training CLI (smoke run, resume, merge into the pipeline, GPU refusal).

Widths: the smoke configuration of `infer_ditto` (DiT/VACE dim 256, 2
heads of 128, 2 layers, VACE at layers 0 and 1, latents of 4 channels).
`WAN_DIT_TINY` and `VACE_TINY` of the JAX package do not fit together
(dim 96 against 128), so the smoke widths stand in for them. fp32
throughout the comparisons with JAX, except where a bf16 case says so.
JAX on the CPU runs exact-softmax attention (`sdpa`); the port runs the
capped softmax and K3's plain backward, equal in exact arithmetic, so the
fp32 tolerances are relative to each tensor's largest magnitude.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.models.wan_vace as JV
from video_styler_tpu.lora import merge_lora as j_merge_lora
from video_styler_tpu.schedulers.flow_match import FlowMatchScheduler as JSched
from video_styler_tpu.trainers import lora_train as JL
from video_styler_tpu.trainers.training import flow_match_loss as j_flow_match_loss

import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vace as TV
from video_styler_tpu_torch import lora as TLORA
from video_styler_tpu_torch import safetensors_io
from video_styler_tpu_torch.convert import from_jax_lora, from_jax_params
from video_styler_tpu_torch.trainers import lora_train as TL
from video_styler_tpu_torch.trainers.checkpoint import latest_checkpoint
from video_styler_tpu_torch.trainers.training import (adamw, flow_match_loss,
                                                      make_train_step,
                                                      training_scheduler)
from video_styler_tpu_torch.utils.ckpt import load_state_dict

from test_torch_pipeline import cpu_share  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIT = dict(dim=256, in_dim=4, ffn_dim=512, out_dim=4, num_heads=2,
           num_layers=2, text_dim=64, freq_dim=32)
VACE = dict(vace_layers=(0, 1), vace_in_dim=72, dim=256, num_heads=2, ffn_dim=512)
RANK = 8


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_scaled(got, want, rel):
    """max |got - want| <= rel * max |want| (fp32 sums in other orders)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _jax_train_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", os.path.join(REPO, "examples", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _models(jd=jnp.float32):
    jcfg, jvcfg = JD.WanDiTConfig(**DIT), JV.VaceConfig(**VACE)
    jp = JD.init_wan_dit(jax.random.PRNGKey(0), jcfg, jd)
    jvp = JV.init_vace(jax.random.PRNGKey(1), jvcfg, jd)
    dit = from_jax_params("dit", _np_tree(jp), TD.WanDiTConfig(**DIT), device="cpu")
    vace = from_jax_params("vace", _np_tree(jvp), TV.VaceConfig(**VACE), device="cpu")
    dit.requires_grad_(False)
    vace.requires_grad_(False)
    return (jcfg, jp, jvcfg, jvp), (dit, vace)


def _jax_lora(jvp, seed=5):
    """The JAX init (B = 0), then a random B so that A's gradients are not
    zero by construction."""
    targets = TL.lora_targets("q,k,v,o,ffn.0,ffn.2", "vace")
    lora = JL.init_lora(jax.random.PRNGKey(2), jvp, rank=RANK, targets=targets)
    for i, ab in enumerate(lora.values()):
        ab["B"] = jnp.asarray(_rand(seed + i, ab["B"].shape, 0.05))
    return lora


def _inputs(seed=20):
    latents = _rand(seed, (1, 4, 3, 4, 4))
    context = _rand(seed + 1, (1, 16, 64))
    vace_context = _rand(seed + 2, (1, 72, 3, 4, 4))
    return latents, context, vace_context


def _jax_tables():
    sched = JSched(shift=5.0, sigma_min=0.0, extra_one_step=True)
    sched.set_timesteps(1000, training=True)
    return sched, tuple(jnp.asarray(t) for t in (
        sched.sigmas, sched.timesteps, sched.linear_timesteps_weights))


def _jax_draws(rng, shape, min_tid=0, max_tid=1000):
    """The tid and noise `flow_match_loss` draws from `rng`."""
    rng_t, rng_n = jax.random.split(rng)
    tid = int(jax.random.randint(rng_t, (), min_tid, max_tid))
    noise = np.array(jax.random.normal(rng_n, shape, jnp.float32))
    return tid, noise


# --------------------------------------------------------------------------
# (d) scheduler training tables
# --------------------------------------------------------------------------

def test_scheduler_training_tables_match_jax():
    j, _ = _jax_tables()
    t = training_scheduler()
    assert t.training and len(t.sigmas) == 1000
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    np.testing.assert_array_equal(t.linear_timesteps_weights, j.linear_timesteps_weights)
    for tid in (0, 321, 999):
        ts = t.timesteps[tid]
        assert t.training_weight(ts) == float(j.training_weight(j.timesteps[tid]))
    x, n = _rand(0, (3,)), _rand(1, (3,))
    np.testing.assert_array_equal(t.training_target(x, n), j.training_target(x, n))
    t.set_timesteps(50)
    assert not t.training


# --------------------------------------------------------------------------
# (e) flow-match loss, given JAX's own tid and noise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_flow_match_loss_matches_jax(which):
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[which]
    (jcfg, jp, jvcfg, jvp), (dit, vace) = _models(jd)
    latents, context, vctx = _inputs()
    _, tables = _jax_tables()
    rng = jax.random.PRNGKey(7)
    want = j_flow_match_loss(jp, jcfg, jnp.asarray(latents, jd), jnp.asarray(context, jd),
                             rng, *tables, min_tid=100, max_tid=900,
                             vace_params=jvp, vace_cfg=jvcfg,
                             vace_context=jnp.asarray(vctx, jd), remat=True)
    tid, noise = _jax_draws(rng, latents.shape, 100, 900)
    sched = training_scheduler()
    with torch.no_grad():
        got = flow_match_loss(
            dit, torch.from_numpy(latents).to(td), torch.from_numpy(context).to(td),
            sched.sigmas, sched.timesteps, sched.linear_timesteps_weights,
            tid=tid, noise=torch.from_numpy(noise), vace=vace,
            vace_context=torch.from_numpy(vctx).to(td))
    assert got.dtype == torch.float32 and got.dim() == 0
    # bf16: each layer rounds at its own points (as in test_torch_models)
    np.testing.assert_allclose(got.item(), float(want),
                               rtol=1e-4 if which == "fp32" else 3e-2)


def test_loss_draws_tid_then_noise_from_the_generator():
    (_, _, _, _), (dit, vace) = _models()
    latents, context, vctx = (torch.from_numpy(a) for a in _inputs())
    sched = training_scheduler()
    tables = (sched.sigmas, sched.timesteps, sched.linear_timesteps_weights)
    with torch.no_grad():
        drawn = flow_match_loss(dit, latents, context, *tables, vace=vace,
                                vace_context=vctx,
                                generator=torch.Generator().manual_seed(3),
                                min_tid=10, max_tid=20)
        g = torch.Generator().manual_seed(3)
        tid = int(torch.randint(10, 20, (), generator=g))
        noise = torch.randn(latents.shape, generator=g)
        given = flow_match_loss(dit, latents, context, *tables, vace=vace,
                                vace_context=vctx, tid=tid, noise=noise)
    assert 10 <= tid < 20 and drawn.item() == given.item()


# --------------------------------------------------------------------------
# (f) LoRA init / apply / export / merge
# --------------------------------------------------------------------------

def test_lora_targets_match_the_jax_cli():
    cli = _jax_train_cli()
    for mods, base in (("q,k,v,o,ffn.0,ffn.2", "vace"), ("q,ffn.2", "dit")):
        assert TL.lora_targets(mods, base) == cli.lora_targets(mods, base)


def test_init_apply_export_and_merge_match_jax():
    (jcfg, jp, jvcfg, jvp), (dit, vace) = _models()
    targets = TL.lora_targets("q,k,v,o,ffn.0,ffn.2", "vace")
    fresh = TL.init_lora(vace, rank=RANK, targets=targets,
                         generator=torch.Generator().manual_seed(0))
    jfresh = JL.init_lora(jax.random.PRNGKey(0), jvp, rank=RANK, targets=targets)
    assert len(fresh) == 2 * 10 and set(fresh) == set(from_jax_lora(_np_tree(jfresh)))
    for name, ab in fresh.items():
        lin = vace.get_submodule(name)
        assert ab["A"].shape == (RANK, lin.in_features)
        assert ab["B"].shape == (lin.out_features, RANK) and not ab["B"].any()
        # A ~ N(0, 1) / r
        assert abs(ab["A"].std().item() * RANK - 1.0) < 0.15

    jlora = _jax_lora(jvp)
    tlora = from_jax_lora(_np_tree(jlora))
    # export: same keys and values as the JAX export
    want_sd = JL.export_lora_state_dict(jlora)
    got_sd = TL.export_lora_state_dict(tlora)
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v)
        assert ".ffn.fc" not in k

    # apply: the VACE hints with the LoRA on, against JAX's apply_lora
    f, h, w = 3, 2, 2
    x = _rand(30, (1, f * h * w, 256))
    ctx = _rand(31, (1, 12, 256))
    t_mod = _rand(32, (1, 6, 256), 0.1)
    vctx = _rand(33, (1, 72, f, 2 * h, 2 * w))
    from video_styler_tpu.ops.rope import assemble_freqs_grid as j_freqs
    from video_styler_tpu_torch.ops.rope import assemble_freqs_grid as t_freqs
    want = JV.vace_forward(JL.apply_lora(jvp, jlora), jvcfg, jnp.asarray(x),
                           jnp.asarray(vctx), jnp.asarray(ctx), jnp.asarray(t_mod),
                           *j_freqs(128, f, h, w))
    TL.apply_lora(vace, tlora)
    assert [p.requires_grad for p in vace.parameters()].count(True) == 2 * len(tlora)
    with torch.no_grad():
        got = TV.vace_forward(vace, torch.from_numpy(x), torch.from_numpy(vctx),
                              torch.from_numpy(ctx), torch.from_numpy(t_mod),
                              *t_freqs(128, f, h, w))
    for g_, w_ in zip(got, want):
        _close_scaled(g_, w_, 1e-4)

    # merge: the exported LoRA (reference 'vace_blocks.' names) into fresh
    # modules, against JAX's merge_lora
    sd = {k.replace("blocks.", "vace_blocks.", 1): v.numpy() for k, v in got_sd.items()}
    jmerged = j_merge_lora(jvp, sd, alpha=0.7)
    _, (_, vace2) = _models()
    TLORA.merge_lora(vace2, {k: torch.from_numpy(v) for k, v in sd.items()}, alpha=0.7)
    for i in range(2):
        for path in ("self_attn.q", "cross_attn.o", "ffn.fc1", "ffn.fc2"):
            node = jmerged["blocks"]
            for part in path.split("."):
                node = node[part]
            np.testing.assert_allclose(
                vace2.get_submodule(f"blocks.{i}.{path}").weight.numpy(),
                np.asarray(node["w"][i]).T, rtol=1e-6, atol=1e-7)
    with pytest.raises(KeyError, match="cannot resolve"):
        TLORA.merge_lora(vace2, {"nope.lora_A.weight": torch.zeros(2, 3),
                                 "nope.lora_B.weight": torch.zeros(3, 2)})


# --------------------------------------------------------------------------
# (g) AdamW against optax.adamw
# --------------------------------------------------------------------------

def test_adamw_matches_optax_over_three_steps():
    params = {"a": _rand(40, (5, 7)), "b": _rand(41, (11,))}
    grads = [{k: _rand(50 + 3 * s + i, v.shape, 10.0 ** -s)
              for i, (k, v) in enumerate(params.items())} for s in range(3)]
    tx = optax.adamw(1e-2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
    opt = adamw(tparams, 1e-2)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, params):
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for p, k in zip(tparams, params):
            # the same update formula, rounded in other orders: a few fp32
            # ULPs of parameters of magnitude up to ~4
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# (h) the slice as a whole: one train step against JAX's value_and_grad
# --------------------------------------------------------------------------

def test_train_step_matches_jax_value_and_grad():
    """examples/train.py:177-198 built from the JAX package's functions:
    apply_lora on the VACE params, flow_match_loss with remat=True,
    optax.adamw; against the port's make_train_step with the same weights,
    LoRA, inputs, tid and noise."""
    (jcfg, jp, jvcfg, jvp), (dit, vace) = _models()
    latents, context, vctx = _inputs()
    _, tables = _jax_tables()
    jlora = _jax_lora(jvp)
    rng = jax.random.PRNGKey(11)
    lr = 1e-3

    def loss_fn(lora):
        return j_flow_match_loss(jp, jcfg, jnp.asarray(latents), jnp.asarray(context),
                                 rng, *tables, min_tid=0, max_tid=1000,
                                 vace_params=JL.apply_lora(jvp, lora),
                                 vace_cfg=jvcfg, vace_context=jnp.asarray(vctx),
                                 remat=True)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jlora)
    tx = optax.adamw(lr)
    updates, _ = tx.update(jgrads, tx.init(jlora), jlora)
    jnew = optax.apply_updates(jlora, updates)

    tlora = from_jax_lora(_np_tree(jlora))
    TL.apply_lora(vace, tlora)
    opt = adamw(TL.lora_parameters(tlora), lr)
    step = make_train_step(dit, opt, training_scheduler(), vace=vace, remat=True)
    tid, noise = _jax_draws(rng, latents.shape)
    loss = step(torch.from_numpy(latents), torch.from_numpy(context),
                torch.from_numpy(vctx), tid=tid, noise=torch.from_numpy(noise))

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want_grads = from_jax_lora(_np_tree(jgrads))
    want_new = from_jax_lora(_np_tree(jnew))
    assert set(want_grads) == set(tlora)
    for name, ab in tlora.items():
        for k in ("A", "B"):
            _close_scaled(ab[k].grad, want_grads[name][k].detach(), 1e-4)
            # AdamW's first step moves each entry by ~lr * sign(grad); an
            # entry whose gradient is at rounding level may differ by lr
            _close_scaled(ab[k], want_new[name][k].detach(), 1e-4)


@pytest.mark.parametrize("act_dtype", [torch.float32, torch.bfloat16])
def test_step_against_bf16_weight_recipe(act_dtype):
    """The recipe's precision: bf16 weights, and examples/train.py:281 casts
    latents, context and vace_context to fp32, so the JAX step runs fp32
    activations (its linear casts each weight to x.dtype). The port's train
    CLI does the same, and on the card runs them through the float32
    kernels (K1f, K3f, K3q-f, K4f, K5f). Both activation dtypes are held
    against the JAX recipe step: fp32 activations differ by
    about one bf16 ULP of the output (rounding points of the bf16 weights);
    bf16 activations add a rounding per op. Measured here (printed with
    -s): loss 3.4e-4 rel for both, LoRA gradients 0.54% (fp32) and 0.83%
    (bf16) rel L2; the bounds hold that divergence, not parity."""
    (jcfg, jp, jvcfg, jvp), (dit, vace) = _models(jnp.bfloat16)
    latents, context, vctx = _inputs()
    _, tables = _jax_tables()
    jlora = _jax_lora(jvp)
    rng = jax.random.PRNGKey(11)

    def loss_fn(lora):
        return j_flow_match_loss(jp, jcfg, jnp.asarray(latents), jnp.asarray(context),
                                 rng, *tables, min_tid=0, max_tid=1000,
                                 vace_params=JL.apply_lora(jvp, lora),
                                 vace_cfg=jvcfg, vace_context=jnp.asarray(vctx),
                                 remat=True)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jlora)
    tlora = from_jax_lora(_np_tree(jlora))
    TL.apply_lora(vace, tlora)
    sched = training_scheduler()
    tid, noise = _jax_draws(rng, latents.shape)
    loss = flow_match_loss(dit, *(torch.from_numpy(a).to(act_dtype)
                                  for a in (latents, context)),
                           sched.sigmas, sched.timesteps,
                           sched.linear_timesteps_weights, tid=tid,
                           noise=torch.from_numpy(noise), vace=vace,
                           vace_context=torch.from_numpy(vctx).to(act_dtype))
    loss.backward()
    want = from_jax_lora(_np_tree(jgrads))
    got = torch.cat([tlora[n][k].grad.reshape(-1) for n in tlora for k in ("A", "B")])
    ref = torch.cat([want[n][k].reshape(-1) for n in tlora for k in ("A", "B")])
    loss_rel = abs(loss.item() - float(jloss)) / float(jloss)
    grads_rel = ((got - ref).norm() / ref.norm()).item()
    print(f"{act_dtype}: loss rel {loss_rel:.3g}, LoRA grads rel L2 {grads_rel:.3g}")
    assert loss_rel <= 1e-3 and grads_rel <= 2e-2, (loss_rel, grads_rel)


def _recipe_step_against_jax(inputs):
    """One step's loss and LoRA gradients of the port on `inputs` (the
    train CLI's tensors) against the JAX recipe step on the same arrays
    cast to fp32 as examples/train.py:281 casts them, bf16 weights on both
    sides: (loss rel, LoRA grads rel L2)."""
    (jcfg, jp, jvcfg, jvp), (dit, vace) = _models(jnp.bfloat16)
    arrays = {k: inputs[k].numpy() for k in ("latents", "context", "vace_context")}
    _, tables = _jax_tables()
    jlora = _jax_lora(jvp)
    rng = jax.random.PRNGKey(12)

    def loss_fn(lora):
        return j_flow_match_loss(jp, jcfg, jnp.asarray(arrays["latents"]).astype(jnp.float32),
                                 jnp.asarray(arrays["context"]).astype(jnp.float32), rng,
                                 *tables, min_tid=0, max_tid=1000,
                                 vace_params=JL.apply_lora(jvp, lora), vace_cfg=jvcfg,
                                 vace_context=jnp.asarray(arrays["vace_context"]).astype(
                                     jnp.float32), remat=True)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jlora)
    tlora = from_jax_lora(_np_tree(jlora))
    TL.apply_lora(vace, tlora)
    sched = training_scheduler()
    tid, noise = _jax_draws(rng, arrays["latents"].shape)
    loss = flow_match_loss(dit, inputs["latents"], inputs["context"], sched.sigmas,
                           sched.timesteps, sched.linear_timesteps_weights, tid=tid,
                           noise=torch.from_numpy(noise), vace=vace,
                           vace_context=inputs["vace_context"])
    loss.backward()
    want = from_jax_lora(_np_tree(jgrads))
    got = torch.cat([tlora[n][k].grad.reshape(-1) for n in tlora for k in ("A", "B")])
    ref = torch.cat([want[n][k].reshape(-1) for n in tlora for k in ("A", "B")])
    return (abs(loss.item() - float(jloss)) / float(jloss),
            ((got - ref).norm() / ref.norm()).item())


@pytest.mark.parametrize("source", ["preprocess noise", "preprocess video", "cached_inputs"])
def test_train_cli_hands_the_step_fp32_as_the_recipe(source, tmp_path):
    """The train CLI's inputs, from `preprocess` (a row without video: seeded
    fp32 noise latents and a zero fp32 VACE context, made so as
    examples/train.py makes them; a row with video: the bf16 pipeline's
    encodes) and from a latent cache through `cached_inputs` (the cache's
    fp32 arrays, examples/train.py:236-239), cast once by `fp32_inputs` as
    the CLI's loop casts them (:281-282), are fp32 tensors; one step on
    them lies within the fp32 bounds of `test_step_against_bf16_weight_recipe`
    from the JAX recipe's step."""
    from video_styler_tpu_torch import train as cli
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline, smoke_frames
    from video_styler_tpu_torch.trainers.latent_cache import (CachedLatentDataset,
                                                              launch_data_process_task)
    pipe = build_smoke_pipeline(device="cpu")
    args = cli.parse_args(["--height", "32", "--width", "32", "--num_frames", "9",
                           "--lora_base_model", "vace"])[1]
    video = None if source == "preprocess noise" else list(smoke_frames(9, 32, 32))
    row = {"prompt": "a watercolor city", "video": video, "vace_video": video}
    raw = cli.preprocess(pipe, row, args)
    if source == "cached_inputs":
        launch_data_process_task([row], lambda r: cli.preprocess(pipe, r, args),
                                 str(tmp_path))
        raw = cli.cached_inputs(pipe, CachedLatentDataset(str(tmp_path))[0])
    made = {"preprocess noise": ("latents", "vace_context"), "preprocess video": (),
            "cached_inputs": ("latents", "context", "vace_context")}[source]
    assert all(raw[k].dtype == torch.float32 for k in made)  # made or stored fp32
    inputs = cli.fp32_inputs(raw)
    assert {k: v.dtype for k, v in inputs.items()} == dict.fromkeys(
        ("latents", "context", "vace_context"), torch.float32)
    assert inputs["latents"].shape == (1, 4, 3, 4, 4)
    assert inputs["vace_context"].shape == (1, 72, 3, 4, 4)
    loss_rel, grads_rel = _recipe_step_against_jax(inputs)
    print(f"{source}: loss rel {loss_rel:.3g}, LoRA grads rel L2 {grads_rel:.3g}")
    assert loss_rel <= 1e-3 and grads_rel <= 2e-2, (loss_rel, grads_rel)


def test_train_cli_smoke_steps_take_fp32(tmp_path, monkeypatch):
    """`train --smoke --device cpu` (and from its latent cache) hands
    `flow_match_loss` fp32 latents, context and VACE context on the bf16
    smoke pipeline's weights."""
    from video_styler_tpu_torch import train as cli
    from video_styler_tpu_torch.trainers import training
    seen = []
    real = training.flow_match_loss

    def recording(dit, latents, context, *a, vace_context=None, **kw):
        seen.append((dit.blocks[0].self_attn.q.weight.dtype, latents.dtype, context.dtype,
                     vace_context.dtype))
        return real(dit, latents, context, *a, vace_context=vace_context, **kw)

    monkeypatch.setattr(training, "flow_match_loss", recording)
    cli.main(["--smoke", "--device", "cpu", "--max_steps", "1",
              "--output_path", str(tmp_path / "run")])
    cache = str(tmp_path / "cache")
    cli.main(["--smoke", "--task", "data_process", "--device", "cpu", "--output_path", cache])
    cli.main(["--smoke", "--device", "cpu", "--max_steps", "1", "--cache_path", cache,
              "--output_path", str(tmp_path / "run2")])
    assert seen == [(torch.bfloat16,) + (torch.float32,) * 3] * 2


def test_remat_changes_no_gradient():
    """Trunk and VACE rematerialisation recompute the same values."""
    grads = []
    for remat in (False, True):
        (_, _, _, jvp), (dit, vace) = _models()
        tlora = from_jax_lora(_np_tree(_jax_lora(jvp)))
        TL.apply_lora(vace, tlora)
        latents, context, vctx = (torch.from_numpy(a) for a in _inputs())
        sched = training_scheduler()
        loss = flow_match_loss(dit, latents, context, sched.sigmas, sched.timesteps,
                               sched.linear_timesteps_weights, tid=500,
                               noise=torch.from_numpy(_rand(60, latents.shape)),
                               vace=vace, vace_context=vctx, remat=remat)
        grads.append(torch.autograd.grad(loss, TL.lora_parameters(tlora)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# (i) safetensors
# --------------------------------------------------------------------------

def test_safetensors_round_trip(tmp_path):
    tensors = {"w.lora_A.weight": torch.from_numpy(_rand(70, (4, 9))),
               "h": torch.from_numpy(_rand(71, (3,))).to(torch.bfloat16),
               "i": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "u": torch.tensor([1, 2, 250], dtype=torch.uint8)}
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file(tensors, path)
    back = load_state_dict(path)
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    st = pytest.importorskip("safetensors.numpy")
    theirs = st.load_file(path)
    np.testing.assert_array_equal(theirs["w.lora_A.weight"], tensors["w.lora_A.weight"].numpy())
    np.testing.assert_array_equal(theirs["i"], tensors["i"].numpy())
    st.save_file({"a": _rand(72, (2, 5))}, path, metadata={"format": "np"})
    np.testing.assert_array_equal(load_state_dict(path)["a"].numpy(), _rand(72, (2, 5)))


# --------------------------------------------------------------------------
# (j), (k) the training CLI
# --------------------------------------------------------------------------

def test_train_cli_smoke_resume_and_merge(tmp_path):
    from video_styler_tpu_torch.infer_ditto import build_smoke_pipeline
    from video_styler_tpu_torch.train import main
    out = str(tmp_path / "run")
    first = main(["--smoke", "--device", "cpu", "--max_steps", "2",
                  "--save_steps", "1", "--output_path", out])
    assert first["steps"] == 2 and all(np.isfinite(first["losses"]))
    files = sorted(os.listdir(out))
    assert files == ["state-1.pt", "state-2.pt", "step-1.safetensors",
                     "step-2.safetensors"]
    assert latest_checkpoint(out).endswith("state-2.pt")
    saved = load_state_dict(os.path.join(out, "step-2.safetensors"))
    assert all(k.startswith("vace_blocks.") for k in saved)

    again = main(["--smoke", "--device", "cpu", "--max_steps", "3", "--num_epochs", "2",
                  "--save_steps", "1", "--output_path", out, "--resume"])
    assert again["resumed_from"].endswith("state-2.pt") and again["steps"] == 3
    assert len(again["losses"]) == 1
    assert os.path.exists(os.path.join(out, "step-3.safetensors"))

    # the saved LoRA merges into the port's pipeline (the infer_ditto merge)
    pipe = build_smoke_pipeline(device="cpu")
    before = pipe.vace.blocks[1].ffn.fc2.weight.clone()
    pipe.load_lora("vace", path=os.path.join(out, "step-2.safetensors"))
    a = saved["vace_blocks.1.ffn.2.lora_A.weight"]
    b = saved["vace_blocks.1.ffn.2.lora_B.weight"]
    assert b.abs().max() > 0
    torch.testing.assert_close(pipe.vace.blocks[1].ffn.fc2.weight,
                               (before.float() + b @ a).to(before.dtype), rtol=0, atol=0)

    # --lora_checkpoint starts from that file
    third = main(["--smoke", "--device", "cpu", "--max_steps", "1",
                  "--output_path", str(tmp_path / "run2"), "--lora_checkpoint",
                  os.path.join(out, "step-2.safetensors")])
    assert third["steps"] == 1
    # the latent cache: encode the smoke samples once, then train from them
    cache = str(tmp_path / "cache")
    written = main(["--smoke", "--task", "data_process", "--device", "cpu",
                    "--output_path", cache])["written"]
    assert [os.path.relpath(w, cache) for w in written] == ["0/0.npz", "0/1.npz"]
    fourth = main(["--smoke", "--device", "cpu", "--max_steps", "2", "--cache_path", cache,
                   "--output_path", str(tmp_path / "run3")])
    assert fourth["losses"] == first["losses"]
    # --dit_path goes through from_pretrained: a missing file is named
    with pytest.raises(FileNotFoundError, match="dit.safetensors"):
        main(["--dit_path", str(tmp_path / "dit.safetensors"), "--device", "cpu",
              "--dataset_metadata_path", str(tmp_path / "metadata.csv")])


def test_train_cli_refuses_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from video_styler_tpu_torch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--output_path", str(tmp_path / "x")])
    out = subprocess.run([sys.executable, "-m", "video_styler_tpu_torch.train",
                          "--smoke", "--max_steps", "1", "--output_path",
                          str(tmp_path / "y")], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
