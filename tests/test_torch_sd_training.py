"""The SD / SDXL LoRA step (`trainers/sd_training.py`) against JAX's
`make_sd_lora_train_step`: on the four-matrix stand-in of the JAX tests and
recipes, and on the real tiny SD UNet (`models/sd.py`, SD_UNET_TINY at
16x16 latents, 77 context rows) against JAX's `sd_unet_forward` on the same
weights; epsilon and v-prediction.

The port draws the UNet (`init_sd_module_`) and the JAX converter reads its
state dict (`test_torch_sd.jparams`); the LoRA (`init_sd_lora`: rank 4 on
`*to_q`, `*to_k`, `*to_v`, `*to_out*`) comes from the JAX init with B moved
off zero, through `from_jax_lora` (the JAX and port paths name the same
linears). `tid` and the noise are reproduced from the JAX key. With
`optax.sgd(1.0)` against `torch.optim.SGD(lr=1)` the update is the
gradient: the loss within 1e-5 relative, every gradient entry within 1e-5
(stand-in) or 1e-4 (UNet: the fp32 UNets agree to 2e-5 relative L2) of the
step's largest gradient.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import video_styler_tpu.models.sd as JS
from video_styler_tpu.schedulers.ddim import EnhancedDDIMScheduler as JDDIM
from video_styler_tpu.trainers.sd_training import init_sd_lora as j_init_sd_lora
from video_styler_tpu.trainers.sd_training import make_sd_lora_train_step as j_step

import video_styler_tpu_torch.models.sd as TS
from video_styler_tpu_torch.convert import from_jax_lora
from video_styler_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler as TDDIM
from video_styler_tpu_torch.train_lora import SDStandIn
from video_styler_tpu_torch.trainers.lora_train import apply_lora, lora_parameters
from video_styler_tpu_torch.trainers.sd_training import (SD_TARGETS, init_sd_lora,
                                                         make_sd_lora_train_step)

from test_torch_image_training import _close_global
from test_torch_pipeline import _tree, cpu_share  # noqa: F401
from test_torch_sd import draw, jparams, unet_inputs
from test_torch_training import _jax_draws

PRED = ("epsilon", "v_prediction")


def _standin():
    """(JAX params, JAX forward, port module, port forward, latents, ctx):
    the stand-in of the JAX recipe (out = ((h q + h k + h v) o) + 0.01
    mean(ctx))."""
    d = 8
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    jp = {"blocks": {"0": {n: {"w": jax.random.normal(k, (d, d)) * 0.1}
                           for n, k in zip(("to_q", "to_k", "to_v", "to_out"), ks)}}}

    def jfwd(p, sample, timestep, ctx):
        b = p["blocks"]["0"]
        h = sample.reshape(sample.shape[0], -1, d)
        h = (h @ b["to_q"]["w"] + h @ b["to_k"]["w"] + h @ b["to_v"]["w"]) @ b["to_out"]["w"]
        return (h + 0.01 * jnp.mean(ctx)).reshape(sample.shape)

    module = SDStandIn(d)
    with torch.no_grad():
        for n, lin in module.blocks[0].items():
            lin.weight.copy_(torch.from_numpy(np.array(jp["blocks"]["0"][n]["w"]).T))
    rng = np.random.default_rng(6)
    lat = (0.1 * rng.standard_normal((2, 4, d, d))).astype(np.float32)
    ctx = rng.standard_normal((2, 7, d)).astype(np.float32)
    return jp, jfwd, module.requires_grad_(False), module, lat, ctx


def _unet():
    unet = draw(TS.SDUNet(TS.SD_UNET_TINY), 1).requires_grad_(False)
    x, _, ctx = unet_inputs()
    return (jparams(unet), JS.sd_unet_forward, unet,
            lambda s, t, c: TS.sd_unet_forward(unet, s, t, c), x, ctx)


def _jax_lora(jp):
    lora = j_init_sd_lora(jax.random.PRNGKey(1), jp, rank=4)
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(2), x.shape), lora)


@pytest.mark.parametrize("pred", PRED)
@pytest.mark.parametrize("model", ["standin", "unet"])
def test_step_matches_jax(model, pred):
    jp, jfwd, module, tfwd, lat, ctx = _standin() if model == "standin" else _unet()
    jlora = _jax_lora(jp)
    sgd = optax.sgd(1.0)
    rng = jax.random.PRNGKey(13)
    jloss, jnew, _ = j_step(jfwd, jp, sgd, scheduler=JDDIM(prediction_type=pred))(
        jlora, sgd.init(jlora), jnp.asarray(lat), jnp.asarray(ctx), rng)
    want = from_jax_lora(_tree(jax.tree_util.tree_map(lambda a, b: a - b, jlora, jnew)))
    tlora = from_jax_lora(_tree(jlora))
    assert set(tlora) == {n for n, _ in init_sd_lora(module, rank=4).items()}
    apply_lora(module, tlora)
    tid, noise = _jax_draws(rng, lat.shape)
    step = make_sd_lora_train_step(tfwd, torch.optim.SGD(lora_parameters(tlora), lr=1.0),
                                   TDDIM(prediction_type=pred))
    loss = step(torch.from_numpy(lat), torch.from_numpy(ctx), tid=tid,
                noise=torch.from_numpy(noise))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(want) == set(tlora) and len(tlora) == (4 if model == "standin" else 128)
    _close_global({n: {k: ab[k].grad for k in "AB"} for n, ab in tlora.items()}, want,
                  1e-5 if model == "standin" else 1e-4)


def test_targets_and_draws():
    """The UNet LoRA's targets (the reference's `to_q,to_k,to_v,to_out`), and
    the step's own draws: tid first, then the noise, from the generator."""
    assert SD_TARGETS == ("*to_q", "*to_k", "*to_v", "*to_out*")
    _, _, module, tfwd, lat, ctx = _standin()
    lora = init_sd_lora(module, rank=2, generator=torch.Generator().manual_seed(0))
    apply_lora(module, lora)
    seen = []

    def fwd(s, t, c):
        seen.append(float(t))
        return tfwd(s, t, c)
    step = make_sd_lora_train_step(fwd, torch.optim.SGD(lora_parameters(lora), lr=0.0))
    gen = torch.Generator().manual_seed(5)
    step(torch.from_numpy(lat), torch.from_numpy(ctx), generator=gen)
    want = torch.Generator().manual_seed(5)
    assert seen == [float(torch.randint(0, 1000, (), generator=want))]
