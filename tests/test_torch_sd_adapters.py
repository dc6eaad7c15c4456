"""The SD family's adapters against the JAX package: the SD ControlNet
(`sd_controlnet_forward`, with and without the global pool) and SDXL's
union ControlNet (`sdxl_controlnet_union_forward`, canny and tile tasks),
the canny annotator (the port's own Canny against JAX's `cv2.Canny` on
seeded images: equal edge maps), `MultiControlNetManager` (two units
summed), the IP-Adapter's kv pairs (`ipadapter_kwargs`: SD's 16 sites,
SDXL's 70, InstantStyle), the CLIP-H image encoder
(`svd_image_encoder_forward`), `SDImagePipeline` with a canny ControlNet
and the IP-Adapter from an image, `SDXLImagePipeline` with the union
ControlNet and the IP-Adapter from embeds, over 2 steps; `load_model` on
the `ipadapter` kind and the JAX detector's fault on it.

Weights drawn by the port, read by the JAX converters under the
reference's names. Widths: the tiny UNets of `test_torch_sd` /
`test_torch_sdxl`, ControlNets on them (the release's conditioning
stem, 3-16-32-96-256), the image encoder 32
wide with the JAX pipeline's 32 layers of 16 heads at 224x224 (the JAX
pipeline calls it with its defaults). fp32 within 2e-5 relative L2.
"""
import functools

import numpy as np
import cv2
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.controlnets as JCN
import video_styler_tpu.models.controlnet as JCtl
import video_styler_tpu.models.ipadapter as JI
import video_styler_tpu.models.svd as JSV
from video_styler_tpu.utils import ckpt as JCK

import video_styler_tpu_torch.controlnets as TCN
import video_styler_tpu_torch.models.controlnet as TCtl
import video_styler_tpu_torch.models.ipadapter as TI
import video_styler_tpu_torch.models.sd as TS
import video_styler_tpu_torch.models.sdxl as TX
from video_styler_tpu_torch.models import svd as TSV
from video_styler_tpu_torch.safetensors_io import save_file
from video_styler_tpu_torch.utils import ckpt as TC

from test_torch_fun import _rel
from test_torch_pipeline import cpu_share  # noqa: F401
from test_torch_sd import SIZE, TOL_F32, draw, jit_jax_vae, jparams, picture  # noqa: F401
from test_torch_sd import pipes as sd_pipes
from test_torch_sd import unet_inputs
from test_torch_sdxl import pipes as xl_pipes
from test_torch_sdxl import xl_inputs

IMAGE_ENCODER = TSV.SVDImageEncoderConfig(dim=32, ffn_dim=64, num_layers=32, num_heads=16,
                                          image_size=224, proj_dim=24)


@functools.lru_cache(maxsize=None)
def controlnet(xl: bool):
    cfg = TCtl.ControlNetConfig(TX.SDXL_UNET_TINY if xl else TS.SD_UNET_TINY, union=xl)
    return draw(TCtl.ControlNet(cfg), 41 + xl)


def conditioning(seed: int = 43):
    return np.random.default_rng(seed).uniform(0, 1, (1, 3, SIZE, SIZE)).astype(np.float32)


@pytest.mark.parametrize("global_pool", [False, True])
def test_sd_controlnet_matches_jax(global_pool):
    model = controlnet(False)
    x, t, ctx = unet_inputs()
    cond = conditioning()
    want = JCtl.sd_controlnet_forward(jparams(model), jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(ctx), jnp.asarray(cond), global_pool)
    with torch.no_grad():
        got = TCtl.sd_controlnet_forward(model, torch.from_numpy(x), torch.from_numpy(t),
                                         torch.from_numpy(ctx), torch.from_numpy(cond),
                                         global_pool)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), np.asarray(w)) < TOL_F32, _rel(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("task", ["canny", "tile"])
def test_sdxl_union_controlnet_matches_jax(task):
    model = controlnet(True)
    x, t, ctx, add_time, pooled = xl_inputs(model.cfg.unet)
    cond = conditioning()
    want = JCtl.sdxl_controlnet_union_forward(
        jparams(model), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(cond),
        task, jnp.asarray(add_time), jnp.asarray(pooled))
    with torch.no_grad():
        got = TCtl.sdxl_controlnet_union_forward(
            model, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
            torch.from_numpy(cond), task, torch.from_numpy(add_time), torch.from_numpy(pooled))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) < TOL_F32, _rel(g.numpy(), np.asarray(w))


def test_controlnet_release_widths_and_detection():
    """The SD ControlNet (361 M) and the SDXL union one (1.257 B), their
    configs read back from their state dicts."""
    for cfg, n in ((TCtl.ControlNetConfig(), 361.3),
                   (TCtl.ControlNetConfig(TX.SDXL_UNET, union=True), 1256.6)):
        with torch.device("meta"):
            model = TCtl.ControlNet(cfg)
        assert round(sum(p.numel() for p in model.parameters()) / 1e6, 1) == n
        assert TCtl.detect_controlnet_config(model.state_dict()) == cfg
    assert TCtl.detect_controlnet_config(controlnet(True).state_dict()) == controlnet(True).cfg


# ------------------------------------------------------------ canny

def seeded_images():
    rng = np.random.default_rng(44)
    yield rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    for k in range(3):
        yy, xx = np.mgrid[0:96, 0:120]
        img = np.stack([127 + 120 * np.sin(xx / (4 + 3 * k) + yy / (6 + c) + k)
                        for c in range(3)], -1)
        yield (img + rng.normal(0, 6 + 4 * k, img.shape)).clip(0, 255).astype(np.uint8)
    yield np.asarray(picture(45, 128))


def test_canny_matches_cv2():
    """The port's Canny against cv2's (JAX's annotator) on seeded images,
    noise and smooth ones, 3 channels and 1: no pixel differs."""
    for img in seeded_images():
        for arr in (img, img[:, :, 0].copy()):
            want = cv2.Canny(arr, 100, 200)
            got = TCN.canny(arr, 100, 200)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert (got != want).mean() == 0.0, (got != want).mean()
            assert 0 < want.mean() < 255


def test_annotators_and_manager_match_jax():
    """canny and tile annotations of one picture (PIL resizes in both), two
    units' conditioning, and their scaled sum of residuals."""
    img = picture(46, 96)
    for pid in ("canny", "tile"):
        want = np.asarray(JCN.Annotator(pid)(img))
        got = TCN.Annotator(pid)(img)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ImportError, match="controlnet_aux"):
        TCN.Annotator("depth")
    model = controlnet(False)
    jm = JCN.MultiControlNetManager([
        JCN.ControlNetUnit(JCN.Annotator("canny"), jparams(model), scale=0.7),
        JCN.ControlNetUnit(JCN.Annotator("tile"), jparams(model), scale=0.4)])
    tm = TCN.MultiControlNetManager([TCN.ControlNetUnit(TCN.Annotator("canny"), model, 0.7),
                                     TCN.ControlNetUnit(TCN.Annotator("tile"), model, 0.4)])
    jc, tc = jm.process_image(img, SIZE, SIZE), tm.process_image(img, SIZE, SIZE)
    np.testing.assert_array_equal(tc, jc)
    x, t, ctx = unet_inputs()
    want = jm(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jc)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), tc)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) < TOL_F32


# ------------------------------------------------------------ IP-Adapter

@functools.lru_cache(maxsize=None)
def ipadapter(xl: bool):
    cfg = TI.ipadapter_config(xl, TX.SDXL_UNET_TINY if xl else TS.SD_UNET_TINY,
                              clip_dim=20 if xl else IMAGE_ENCODER.proj_dim)
    return draw(TI.IpAdapter(cfg), 47 + xl)


@pytest.mark.parametrize("case", ["sd", "sdxl", "instant_style"])
def test_ipadapter_kwargs_match_jax(case):
    xl = case != "sd"
    model = ipadapter(xl)
    embeds = np.random.default_rng(49).standard_normal((2, model.cfg.clip_dim)).astype(np.float32)
    want = JI.ipadapter_kwargs(jparams(model), jnp.asarray(embeds), scale=0.8, xl=xl,
                               instant_style=case == "instant_style")
    with torch.no_grad():
        got = TI.ipadapter_kwargs(model, torch.from_numpy(embeds), scale=0.8, xl=xl,
                                  instant_style=case == "instant_style")
    assert {b: sorted(v) for b, v in got.items()} == {b: sorted(v) for b, v in want.items()}
    n = sum(len(v) for v in got.values())
    assert n == {"sd": 16, "sdxl": 70, "instant_style": 10}[case]
    for b, layers in want.items():
        for layer, (k, v, s) in layers.items():
            gk, gv, gs = got[b][layer]
            assert gs == s and gk.shape[:2] == gv.shape[:2] == (1, 8)
            assert _rel(gk.numpy(), np.asarray(k)) < TOL_F32
            assert _rel(gv.numpy(), np.asarray(v)) < TOL_F32


@functools.lru_cache(maxsize=None)
def image_encoder():
    return draw(TSV.SVDImageEncoder(IMAGE_ENCODER), 50)


def test_image_encoder_matches_jax():
    model = image_encoder()
    pix = np.random.default_rng(51).standard_normal((2, 3, 224, 224)).astype(np.float32)
    want = np.asarray(JSV.svd_image_encoder_forward(jparams(model), jnp.asarray(pix)))
    with torch.no_grad():
        got = TSV.svd_image_encoder_forward(model, torch.from_numpy(pix)).numpy()
    assert got.shape == (2, IMAGE_ENCODER.proj_dim)
    assert _rel(got, want) < TOL_F32, _rel(got, want)
    with torch.device("meta"):
        full = TSV.SVDImageEncoder()
    assert round(sum(p.numel() for p in full.parameters()) / 1e6, 1) == 632.1


def test_ipadapter_load_model_and_jax_detection_fault(tmp_path):
    """An SD IP-Adapter file under the reference's names (and the released
    `ip_adapter.{2j+1}` layout) loads as kind `ipadapter`. The JAX detector
    calls the same file `flux_ipadapter`: its "image_proj.proj" test also
    matches SD's one-linear projection (ROADMAP Queue 3)."""
    model = ipadapter(False)
    sd = {k[:-len("scale")] + "weight" if k.endswith(".scale") else k: v
          for k, v in model.state_dict().items()}
    released = {(f"ip_adapter.{2 * int(k.split('.')[1]) + 1}." + k.split(".", 2)[2])
                if k.startswith("ipadapter_modules.") else k: v for k, v in sd.items()}
    for name, d in (("diffsynth", sd), ("released", released)):
        path = str(tmp_path / f"{name}.safetensors")
        save_file(d, path)
        kind, built = TC.load_model(path, device="cpu", dtype=torch.float32)
        assert kind == "ipadapter" and built.cfg == model.cfg
        for k, v in model.state_dict().items():
            torch.testing.assert_close(built.state_dict()[k], v, rtol=0, atol=0, msg=k)
    assert JCK.detect_model_kind(sd) == "flux_ipadapter"


# ------------------------------------------------------------ pipelines

def test_sd_pipeline_controlnet_ipadapter_matches_jax():
    """A canny ControlNet unit and the IP-Adapter from a picture (CLIP-H
    embedding), both packages on the same weights."""
    jp, tp = sd_pipes()
    import copy
    jp, tp = copy.copy(jp), copy.copy(tp)
    enc, cn, ip = image_encoder(), controlnet(False), ipadapter(False)
    jp.image_encoder_params, tp.image_encoder = jparams(enc), enc
    request = dict(prompt="a lighthouse", negative_prompt="blurry", cfg_scale=6.0,
                   height=SIZE, width=SIZE, num_inference_steps=2, seed=5, return_latents=True,
                   controlnet_image=picture(52), ipadapter_images=[picture(53, 96)],
                   ipadapter_scale=0.6)
    want = np.asarray(jp(**request, controlnet_units=[
        JCN.ControlNetUnit(JCN.Annotator("canny"), jparams(cn), scale=0.8)],
        ipadapter_params=jparams(ip)))
    got = tp(**request, controlnet_units=[TCN.ControlNetUnit(TCN.Annotator("canny"), cn, 0.8)],
             ipadapter_params=ip).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_sdxl_pipeline_union_controlnet_ipadapter_matches_jax():
    jp, tp = xl_pipes()
    cn, ip = controlnet(True), ipadapter(True)
    embeds = np.random.default_rng(54).standard_normal((1, 20)).astype(np.float32)
    request = dict(prompt="a lighthouse", negative_prompt="blurry", cfg_scale=6.0,
                   height=SIZE, width=SIZE, num_inference_steps=2, seed=5, return_latents=True,
                   controlnet_image=picture(55), ipadapter_scale=0.5)
    want = np.asarray(jp(**request, controlnet_units=[
        JCN.ControlNetUnit(JCN.Annotator("canny"), jparams(cn), scale=0.8, xl=True)],
        ipadapter_params=jparams(ip), ipadapter_image_embeds=jnp.asarray(embeds)))
    got = tp(**request, controlnet_units=[TCN.ControlNetUnit(TCN.Annotator("canny"), cn, 0.8,
                                                             xl=True)],
             ipadapter_params=ip, ipadapter_image_embeds=torch.from_numpy(embeds)).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)
