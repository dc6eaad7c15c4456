"""The image-family LoRA step (`trainers/image_training.py`) against JAX's
`make_image_lora_train_step` for FLUX, SD3 and Qwen-Image, the DiTs'
`remat`, and the family LoRA CLI (`train_lora`) against JAX's
`_family_runner.train`.

Widths: the JAX recipes' tiny DiTs (FLUX_DIT_TINY, SD3_DIT_TINY,
QWEN_IMAGE_TINY) with their smoke inputs' shapes: 16-channel 8x8 latents,
8 context rows. Weights from the JAX init through `from_jax_params`; the
LoRA (rank 4 on every linear, `targets=("*",)`) from the JAX init with B
moved off zero, through `from_jax_lora`; the JAX step's `tid` and noise
reproduced from its key. With `optax.sgd(1.0)` against `torch.optim.SGD(lr=1)`
the update is the gradient: the loss within 1e-5 relative and every A/B
gradient within 1e-5 of the step's largest gradient (fp32; JAX on the CPU
runs the exact-softmax `sdpa`, the port its capped plain attention:
measured ~1e-6. Against each tensor's own largest entry the text stream's
small gradients, 1e-4 of the largest, reach 1.6e-3); a linear the forward
never reaches (FLUX's guidance embedder without guidance) has no gradient
in the port and zeros in JAX. Then three Adam steps against `optax.adam`,
the LoRA's movement within 5e-3 relative L2 of JAX's (measured 1.2e-3:
Adam turns a gradient at rounding level into a step of up to lr).
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

import video_styler_tpu.models.flux_dit as JF
import video_styler_tpu.models.qwen_image_dit as JQ
import video_styler_tpu.models.sd3_dit as JS
from video_styler_tpu.trainers.image_training import make_image_lora_train_step as j_step
from video_styler_tpu.trainers.lora_train import init_lora as j_init_lora

from video_styler_tpu_torch import train_lora
from video_styler_tpu_torch.convert import from_jax_lora, from_jax_params
from video_styler_tpu_torch.models import flux_dit as TF
from video_styler_tpu_torch.models import qwen_image_dit as TQ
from video_styler_tpu_torch.models import sd3_dit as TS
from video_styler_tpu_torch.trainers.image_training import make_image_lora_train_step
from video_styler_tpu_torch.trainers.lora_train import apply_lora, lora_parameters
from video_styler_tpu_torch.utils.ckpt import load_state_dict

from test_torch_pipeline import _tree, cpu_share  # noqa: F401
from test_torch_training import _jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_IDS = np.zeros((8, 3))
FAMILIES = ("flux", "sd3", "qwen_image")


def _family(name):
    """(JAX params, JAX forward_fn, port module, port forward(remat), ctx
    numpy dict)."""
    rng = np.random.default_rng(4)
    if name == "flux":
        cfg = JF.FLUX_DIT_TINY
        jp = JF.init_flux_dit(jax.random.PRNGKey(0), cfg)
        ctx = {"emb": rng.standard_normal((1, 8, cfg.context_dim)),
               "pooled": rng.standard_normal((1, cfg.pooled_dim))}
        module = from_jax_params("flux_dit", _tree(jp), TF.FLUX_DIT_TINY, device="cpu")

        def jfwd(p, x, t, c):
            return JF.flux_dit_forward(p, cfg, x, t, c["emb"], c["pooled"], text_ids=TEXT_IDS)

        def tfwd(remat):
            return lambda x, t, c: TF.flux_dit_forward(module, x, t, c["emb"], c["pooled"],
                                                       text_ids=TEXT_IDS, remat=remat)
    elif name == "sd3":
        cfg = JS.SD3_DIT_TINY
        jp = JS.init_sd3_dit(jax.random.PRNGKey(0), cfg)
        # the JAX init's position table is zeros: draw it
        jp["pos_embedder"]["pos_embed"] = jnp.asarray(
            0.02 * rng.standard_normal(jp["pos_embedder"]["pos_embed"].shape), jnp.float32)
        ctx = {"emb": rng.standard_normal((1, 8, cfg.context_dim)),
               "pooled": rng.standard_normal((1, cfg.pooled_dim))}
        module = from_jax_params("sd3_dit", _tree(jp), TS.SD3_DIT_TINY, device="cpu")

        def jfwd(p, x, t, c):
            return JS.sd3_dit_forward(p, cfg, x, t, c["emb"], c["pooled"])

        def tfwd(remat):
            return lambda x, t, c: TS.sd3_dit_forward(module, x, t, c["emb"], c["pooled"],
                                                      remat=remat)
    else:
        cfg = JQ.QWEN_IMAGE_TINY
        jp = JQ.init_qwen_image_dit(jax.random.PRNGKey(0), cfg)
        ctx = {"emb": rng.standard_normal((1, 8, cfg.text_dim))}
        module = from_jax_params("qwen_image_dit", _tree(jp), TQ.QWEN_IMAGE_TINY, device="cpu")

        # the DiT takes the timestep / 1000, as both pipelines pass it (the
        # JAX recipe's forward passes the training timestep itself)
        def jfwd(p, x, t, c):
            return JQ.qwen_image_dit_forward(p, cfg, x, t / 1000.0, c["emb"])

        def tfwd(remat):
            return lambda x, t, c: TQ.qwen_image_dit_forward(module, x, t / 1000.0, c["emb"],
                                                             remat=remat)
    ctx = {k: v.astype(np.float32) for k, v in ctx.items()}
    return jp, jfwd, module.requires_grad_(False), tfwd, ctx


def _close_global(got, want, rel):
    """Every gradient entry within rel x the largest |gradient| of the
    step; a None gradient counts as zeros."""
    scale = max(float(w[k].detach().abs().max()) for w in want.values() for k in "AB")
    for name, w in want.items():
        for k in "AB":
            g = got[name][k]
            g = torch.zeros_like(w[k]) if g is None else g
            err = float((g - w[k].detach()).abs().max())
            assert err <= rel * scale, (name, k, err, scale)


def _jax_lora(jp, seed=1):
    lora = j_init_lora(jax.random.PRNGKey(seed), jp, rank=4, targets=("*",))
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1), x.shape), lora)


def _latents():
    return (0.3 * np.random.default_rng(5).standard_normal((1, 16, 8, 8))).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_step_matches_jax(family):
    jp, jfwd, module, tfwd, ctx = _family(family)
    jlora = _jax_lora(jp)
    lat = _latents()
    jctx = {k: jnp.asarray(v) for k, v in ctx.items()}
    tctx = {k: torch.from_numpy(v) for k, v in ctx.items()}

    # SGD(1): the update is the gradient
    sgd = optax.sgd(1.0)
    jsgd = jax.jit(j_step(jfwd, jp, sgd))

    def jax_grads(lora, rng):
        loss, new, _ = jsgd(lora, sgd.init(lora), jnp.asarray(lat), jctx, rng)
        return loss, jax.tree_util.tree_map(lambda a, b: a - b, lora, new)

    rng = jax.random.PRNGKey(11)
    jloss, jgrads = jax_grads(jlora, rng)
    tlora = from_jax_lora(_tree(jlora))
    apply_lora(module, tlora)
    params = lora_parameters(tlora)
    tid, noise = _jax_draws(rng, lat.shape)
    loss = make_image_lora_train_step(tfwd(False), torch.optim.SGD(params, lr=1.0))(
        torch.from_numpy(lat), tctx, tid=tid, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = from_jax_lora(_tree(jgrads))
    assert set(want) == set(tlora) and len(tlora) > 30
    _close_global({n: {k: ab[k].grad for k in "AB"} for n, ab in tlora.items()}, want, 1e-5)

    # three Adam steps from the same start: the JAX step with optax.adam is
    # its gradient, then `adam.update` (one compile serves both)
    _, _, module, tfwd, _ = _family(family)
    start = from_jax_lora(_tree(jlora))
    adam = optax.adam(1e-3)
    state = adam.init(jlora)
    tlora = from_jax_lora(_tree(jlora))
    apply_lora(module, tlora)
    tstep = make_image_lora_train_step(tfwd(False),
                                       torch.optim.Adam(lora_parameters(tlora), lr=1e-3))
    for i in range(3):
        rng = jax.random.PRNGKey(20 + i)
        jloss, jgrads = jax_grads(jlora, rng)
        updates, state = adam.update(jgrads, state, jlora)
        jlora = optax.apply_updates(jlora, updates)
        tid, noise = _jax_draws(rng, lat.shape)
        loss = tstep(torch.from_numpy(lat), tctx, tid=tid, noise=torch.from_numpy(noise))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = from_jax_lora(_tree(jlora))
    moved = [(ab[k].detach() - start[n][k].detach(), want[n][k].detach() - start[n][k].detach())
             for n, ab in tlora.items() for k in "AB"]
    got_m, want_m = (torch.cat([m[i].reshape(-1) for m in moved]) for i in (0, 1))
    assert float((got_m - want_m).norm() / want_m.norm()) < 5e-3
    # Adam moves an entry by up to lr a step whatever its gradient's size: a
    # gradient at rounding level may turn a step (measured: 6.4e-5 once)
    assert float((got_m - want_m).abs().max()) < 1e-3


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_is_bit_equal(family):
    """remat=True recomputes every block in the backward: the loss and every
    LoRA gradient keep their bits."""
    out = []
    for remat in (False, True):
        jp, _, module, tfwd, ctx = _family(family)
        tlora = from_jax_lora(_tree(_jax_lora(jp)))
        apply_lora(module, tlora)
        loss = make_image_lora_train_step(tfwd(remat), torch.optim.SGD(
            lora_parameters(tlora), lr=0.0))(
            torch.from_numpy(_latents()), {k: torch.from_numpy(v) for k, v in ctx.items()},
            generator=torch.Generator().manual_seed(3))
        out.append((loss, {n: (ab["A"].grad, ab["B"].grad) for n, ab in tlora.items()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for name in g0:
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(g0[name], g1[name])), name


def _jax_runner():
    spec = importlib.util.spec_from_file_location(
        "jax_family_runner", os.path.join(REPO, "examples", "families", "_family_runner.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", train_lora.FAMILIES)
def test_cli_smoke_writes_the_jax_keys(family, tmp_path):
    """`train_lora --family F --smoke --device cpu` writes the key set (and
    shapes) of the JAX recipe's `train(F, ["--smoke", ...])`."""
    from safetensors.numpy import load_file
    jpath, tpath = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jl = _jax_runner().train(family, ["--smoke", "--steps", "2", "--output_path", jpath])
    tl = train_lora.main(["--family", family, "--smoke", "--steps", "2", "--device", "cpu",
                          "--output_path", tpath])
    assert len(tl) == len(jl) == 2 and np.isfinite(tl).all()
    want = {k: v.shape for k, v in load_file(jpath).items()}
    got = {k: tuple(v.shape) for k, v in load_state_dict(tpath).items()}
    assert got == want


def test_cli_refuses_the_cpu_unless_asked():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "video_styler_tpu_torch.train_lora",
                          "--family", "sd", "--smoke"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    res = subprocess.run([sys.executable, "-m", "video_styler_tpu_torch.train_lora",
                          "--family", "flux"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "--smoke" in res.stdout


def test_qwen_recipe_timestep_fault():
    """JAX's Qwen-Image recipe (`_family_runner._train_smoke_pack`) gives the
    DiT the training timestep itself, which the DiT embeds at x1000 (up to
    10^6); both pipelines pass timestep / 1000. The port's recipe divides:
    its forward at t equals the DiT at t / 1000, where JAX's equals the DiT
    at t."""
    params, jfwd, lat, ctx = _jax_runner()._train_smoke_pack("qwen_image")
    t = jnp.asarray([800.0])
    cfg = JQ.QWEN_IMAGE_TINY
    got = np.asarray(jfwd(params, lat, t, ctx))
    np.testing.assert_array_equal(
        got, np.asarray(JQ.qwen_image_dit_forward(params, cfg, lat, t, ctx["emb"])))
    assert not np.allclose(got, np.asarray(JQ.qwen_image_dit_forward(
        params, cfg, lat, t / 1000.0, ctx["emb"])), rtol=1e-2)
    model, fwd, tlat, tctx = train_lora.smoke_pack("qwen_image")
    tt = torch.tensor([800.0])
    with torch.no_grad():
        want = TQ.qwen_image_dit_forward(model, tlat, tt / 1000.0, tctx["emb"])
        assert torch.equal(fwd(tlat, tt, tctx), want)
