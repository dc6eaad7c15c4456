"""The Wan controllers against the JAX package: the speed controller, the
camera's host code (Plücker rays and their temporal packing, bit-equal)
and the Fun camera adapter (`SimpleAdapter`) at smoke width and at the
14B width (24 -> 5120).

Weights: the speed controller's from the JAX init (its zero fc3 replaced
by a random one, so its output is not zero); the adapter's from the
port's init with random biases, read by the JAX converter (drawing the
14B width's 0.5B weights in JAX takes seconds); inputs from numpy seeds.
fp32 within 2e-5 relative L2 (the same arithmetic summed in other orders);
bf16 within 5% (each side rounds at its own points).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_controllers as JC

import video_styler_tpu_torch.models.wan_controllers as TC
from video_styler_tpu_torch.convert import from_jax_params

from test_torch_pipeline import _tree, cpu_share  # noqa: F401


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_motion_controller_matches_jax(dtype):
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = JC.init_motion_controller(jax.random.PRNGKey(0), dim=96)
    params["fc3"]["w"] = jax.random.normal(jax.random.PRNGKey(1), (96, 576)) * 0.05
    params = jax.tree_util.tree_map(lambda a: a.astype(jd), params)
    model = from_jax_params("motion_controller", _tree(params), None, device="cpu")
    ids = np.array([50.0], np.float32)
    want = np.asarray(JC.motion_controller_forward(params, jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        got = TC.motion_controller_forward(model, torch.from_numpy(ids))
    assert got.shape == want.shape == (1, 576) and got.dtype == td
    assert _rel(got.float().numpy(), want) < (2e-5 if dtype == "fp32" else 5e-2)
    # the reference's zero-initialised last layer, in both inits
    zero = TC.init_motion_controller_(TC.MotionController(96, 256), torch.Generator())
    assert not zero.fc3.weight.any() and not zero.fc3.bias.any()
    assert TC.convert_motion_controller(TC.export_motion_controller(model)).keys() == \
        model.state_dict().keys()


@pytest.mark.parametrize("direction", ["Left", "Right Up", "In", "Down Out"])
def test_camera_coordinates_bit_equal(direction):
    """`process_camera_coordinates` (float64 Plücker rays, as in JAX) and
    `pack_camera_latents` give the JAX package's arrays bit for bit."""
    kw = dict(direction=direction, length=9, height=16, width=24, speed=1 / 30)
    got = TC.process_camera_coordinates(**kw)
    want = JC.process_camera_coordinates(**kw)
    assert got.shape == (9, 16, 24, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    packed = TC.pack_camera_latents(got, 9)
    assert packed.shape == (1, 24, 3, 16, 24)
    np.testing.assert_array_equal(packed, JC.pack_camera_latents(want, 9))


@pytest.mark.parametrize("case", ["smoke-fp32", "smoke-bf16", "14B-fp32"])
def test_simple_adapter_matches_jax(case):
    """The camera adapter on packed Plücker latents: smoke width (24 -> 96,
    2 residual blocks, 3 frames of 32x48) in fp32 and bf16, and the 14B
    width (24 -> 5120, 1 block) on one frame of 32x32 in fp32."""
    width, blocks, frames, h, w = {"smoke-fp32": (96, 2, 3, 32, 48),
                                   "smoke-bf16": (96, 2, 3, 32, 48),
                                   "14B-fp32": (5120, 1, 1, 32, 32)}[case]
    jd, td = (jnp.bfloat16, torch.bfloat16) if "bf16" in case else (jnp.float32,
                                                                     torch.float32)
    with torch.device("meta"):
        model = TC.SimpleAdapter(24, width, blocks)
    gen = torch.Generator().manual_seed(2)
    model = TC.init_simple_adapter_(model.to_empty(device="cpu"), gen)
    with torch.no_grad():   # non-zero biases, so their rounding is held too
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
    model = model.to(td)
    params = JC.convert_simple_adapter(dict(model.state_dict()), dtype=jd)
    assert len(params["residual_blocks"]) == blocks
    # and back through from_jax_params, bit-equal
    back = from_jax_params("control_adapter", _tree(params), None, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    x = np.random.default_rng(0).standard_normal((1, 24, frames, h, w)).astype(np.float32)
    want = np.asarray(JC.simple_adapter_forward(params, jnp.asarray(x, jd)), np.float32)
    with torch.no_grad():
        got = TC.simple_adapter_forward(model, torch.from_numpy(x).to(td))
    assert got.shape == want.shape == (1, width, frames, h // 16, w // 16)
    assert got.dtype == td
    assert _rel(got.float().numpy(), want) < (5e-2 if "bf16" in case else 2e-5)
