"""PyTorch port vs JAX package: the CLIP ViT-H/14 vision tower of the Wan
I2V image encoder.

Weights come from the JAX init (`init_clip_vit`) through
`from_jax_params`; the converters are checked both ways on a state dict
under the reference's `visual.*` names. Sizes: the tiny tower of the JAX
tests (28x28 images, 14-pixel patches, dim 64, 2 heads, 3 blocks), the
smoke runner's 257-token tower (112x112, 7-pixel patches, dim 1280, 4
heads, 2 blocks) and one block at ViT-H/14's full width (1280, 16 heads of
80, MLP 5120: ~20M weights) on 257 tokens. fp32 within 2e-5 relative L2
(the same arithmetic summed in other orders); bf16 within 5% (each side
rounds at its own points).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.clip_vit as JC

import video_styler_tpu_torch.models.clip_vit as TC
from video_styler_tpu_torch.convert import from_jax_params

TINY = dict(image_size=28, patch_size=14, dim=64, num_heads=2, num_layers=3)
SMOKE = dict(image_size=112, patch_size=7, dim=1280, num_heads=4, num_layers=2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _towers(cfg: dict, dtype, seed: int = 0):
    jcfg = JC.ClipVitConfig(**cfg)
    jp = JC.init_clip_vit(jax.random.PRNGKey(seed), jcfg, dtype)
    model = from_jax_params("clip", jax.tree_util.tree_map(np.asarray, jp),
                            TC.ClipVitConfig(**cfg), device="cpu")
    return jcfg, jp, model


def _images(b: int, h: int, w: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    yy = np.linspace(-1, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(-1, 1, w, dtype=np.float32)[None, :]
    base = np.stack([np.sin(3 * xx + 2 * c * yy) for c in range(3)])
    return np.clip(base[None] * 0.8 + 0.1 * rng.standard_normal((b, 3, h, w)),
                   -1, 1).astype(np.float32)


@pytest.mark.parametrize("size", [(32, 48), (480, 832), (224, 224)])
def test_preprocess_matches_jax(size):
    """Bicubic resize to 224 and the CLIP mean/std: bit-equal (both run
    torch's interpolate on the CPU in fp32)."""
    img = _images(2, *size)
    want = JC.preprocess_clip_image(img, 224)
    got = TC.preprocess_clip_image(img, 224).numpy()
    assert got.shape == (2, 3, 224, 224)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["fp32", "bf16"])
def test_tiny_tower_matches_jax(which):
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[which]
    jcfg, jp, model = _towers(TINY, jd)
    img = _images(2, 40, 56)
    for tap in (True, False):
        pre = JC.preprocess_clip_image(img, jcfg.image_size)
        want = np.asarray(jnp.asarray(JC.clip_vit_forward(jp, jcfg, jnp.asarray(pre, jd),
                                                          use_31_block=tap), jnp.float32))
        with torch.no_grad():
            got = TC.clip_vit_forward(model, torch.from_numpy(pre).to(td),
                                      use_31_block=tap).float().numpy()
        assert got.shape == want.shape == (2, 5, 64)
        assert _rel(got, want) < (2e-5 if which == "fp32" else 5e-2)


def test_encode_image_257_tokens_matches_jax():
    """The smoke runner's 257-token tower through `encode_image` in bf16,
    as the I2V pipeline calls it."""
    jcfg, jp, model = _towers(SMOKE, jnp.bfloat16, seed=6)
    img = _images(1, 32, 32)
    want = np.asarray(jnp.asarray(JC.encode_image(jp, img, jcfg, dtype=jnp.bfloat16),
                                  jnp.float32))
    got = TC.encode_image(model, img, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 257, 1280)
    assert _rel(got.float().numpy(), want) < 5e-2


def test_full_width_block_matches_jax():
    """One ViT-H/14 block at its published width (1280 wide, 16 heads of
    80, MLP 5120) on 257 tokens in fp32."""
    cfg = dataclasses.asdict(TC.CLIP_VIT_H_14)
    cfg["num_layers"] = 1
    jcfg, jp, model = _towers(cfg, jnp.float32, seed=3)
    x = np.random.default_rng(2).standard_normal((1, 257, 1280)).astype(np.float32)
    want = np.asarray(JC._attn_block(jp["blocks"]["0"], jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = TC._block(model.blocks[0], torch.from_numpy(x), model.cfg).numpy()
    assert _rel(got, want) < 2e-5
    assert sum(p.numel() for p in model.blocks[0].parameters()) > 19e6


def test_convert_round_trip_matches_jax():
    """A `visual.*` state dict (with a `textual.*` key the converters drop)
    through both converters gives the same tower; `export_clip_vit`
    inverts `convert_clip_vit`."""
    _, jp, model = _towers(TINY, jnp.float32)
    sd = {k: v.clone() for k, v in TC.export_clip_vit(model).items()}
    sd["textual.token_embedding.weight"] = torch.zeros(4, 4)
    jcfg = JC.ClipVitConfig(**TINY)
    jtree = JC.convert_clip_vit({k: v.numpy() for k, v in sd.items()}, jcfg, jnp.float32)
    from_jax = from_jax_params("clip", jax.tree_util.tree_map(np.asarray, jtree),
                               model.cfg, device="cpu")
    converted = TC.ClipVit(model.cfg)
    converted.load_state_dict(TC.convert_clip_vit(sd, model.cfg), strict=True)
    for got in (from_jax, converted):
        for k, v in model.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
