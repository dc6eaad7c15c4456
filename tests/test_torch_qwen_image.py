"""Qwen-Image against the JAX package: `qwen_rope` (bit-equal, with frame
offsets), the DiT forward (fp32 and bf16, with an extra latent, under an
EliGen bias), the block-wise ControlNet (a block, and inside the forward),
the VAE's renames and a one-frame encode and decode, `QwenImagePipeline`
(t2i, img2img, CFG 4, inpaint, an edit with one image and with two, a
context image, EliGen, ControlNet gating and its inpaint variant), the
converters and `load_model` on synthetic files, and `image_gen --family
qwen`, beside the JAX runner's fault (it fetches no text encoder).

Weights: reference-named state dicts drawn from a numpy seed, read by both
packages' converters (the VAE's from the port's draw, renamed to the
diffusers names). Widths: `QWEN_IMAGE_TINY` (96 wide, 4 heads of 24, 2
blocks) on the text tower of `test_torch_qwen_vl` (256 wide); a Wan2.1
VAE of width 16 with 16 latent channels; requests of 64x64 (16 image
tokens), 2 steps. On the CPU the port's joint attention is K1's plain
version (the capped softmax) and the JAX DiT takes the exact `sdpa` (heads
of 24): fp32 within 2e-5 relative L2; bf16 within the bound stated at the
test.
"""
import argparse
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.qwen_image_controlnet as JC
import video_styler_tpu.models.qwen_image_dit as JD
import video_styler_tpu.models.qwen_image_vae as JQV
import video_styler_tpu.models.qwen_vl_embedder as JE
import video_styler_tpu.models.wan_vae as JW
import video_styler_tpu.pipelines.qwen_image as JP
from video_styler_tpu.utils import ckpt as JCK

import video_styler_tpu_torch.models.qwen_image_controlnet as TC
import video_styler_tpu_torch.models.qwen_image_dit as TD
import video_styler_tpu_torch.models.qwen_image_vae as TQV
import video_styler_tpu_torch.models.wan_vae as TW
import video_styler_tpu_torch.pipelines.qwen_image as TP
from video_styler_tpu_torch import image_gen, safetensors_io
from video_styler_tpu_torch.utils import ckpt as TCK
from video_styler_tpu_torch.utils.ckpt import build_module

from test_torch_fun import _rel
from test_torch_pipeline import cpu_share  # noqa: F401
from test_torch_qwen_vl import (TEXT, stub_tokenizer, synthetic_image, token_ids, torch_sd,
                                vl_state_dict)

TOL_F32 = 2e-5
DIT = dict(dim=96, num_heads=4, num_layers=2, text_dim=TEXT["hidden"], axes_dim=(4, 10, 10))
VAE = dict(dim=16, z_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=1)
SIZE = 64


def dit_cfgs():
    return JD.QwenImageDiTConfig(**DIT), TD.QwenImageDiTConfig(**DIT)


def vae_cfgs():
    return JW.WanVAEConfig(**VAE), TW.WanVAEConfig(**VAE)


def dit_state_dict(seed: int = 0):
    """The reference's DiT names, drawn from a numpy seed (biases and norm
    weights perturbed)."""
    rng = np.random.default_rng(seed)
    cfg = TD.QwenImageDiTConfig(**DIT)
    d = cfg.dim
    model = TD.QwenImageDiT(cfg, device="meta")
    sd = {}
    for name, p in model.state_dict().items():
        if name.endswith(".weight") and p.dim() == 2:
            sd[name] = (rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[1])).astype(np.float32)
        elif "norm" in name:
            sd[name] = (1 + 0.1 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
        else:
            sd[name] = (0.05 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
    assert sd["proj_out.weight"].shape == (cfg.in_dim, d)
    return sd


def cn_state_dict(additional: int = 0, seed: int = 5):
    rng = np.random.default_rng(seed)
    cfg = TC.QwenBlockwiseCNConfig(num_layers=DIT["num_layers"], additional_in_dim=additional,
                                   dim=DIT["dim"])
    sd = {}
    for name, p in TC.QwenBlockwiseControlNet(cfg, device="meta").state_dict().items():
        if p.dim() == 2:
            sd[name] = (rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[1])).astype(np.float32)
        elif "rms" in name:
            sd[name] = (1 + 0.1 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
        else:
            sd[name] = (0.1 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
    return sd


_LEAF_BACK = ((".residual.0.gamma", ".norm1.gamma"), (".residual.2.", ".conv1."),
              (".residual.3.gamma", ".norm2.gamma"), (".residual.6.", ".conv2."),
              (".shortcut.", ".conv_shortcut."))
_PREFIX_BACK = (("encoder.conv1.", "encoder.conv_in."),
                ("encoder.downsamples.", "encoder.down_blocks."),
                ("encoder.middle.0.", "encoder.mid_block.resnets.0."),
                ("encoder.middle.1.", "encoder.mid_block.attentions.0."),
                ("encoder.middle.2.", "encoder.mid_block.resnets.1."),
                ("encoder.head.0.", "encoder.norm_out."), ("encoder.head.2.", "encoder.conv_out."),
                ("decoder.conv1.", "decoder.conv_in."),
                ("decoder.middle.0.", "decoder.mid_block.resnets.0."),
                ("decoder.middle.1.", "decoder.mid_block.attentions.0."),
                ("decoder.middle.2.", "decoder.mid_block.resnets.1."),
                ("decoder.head.0.", "decoder.norm_out."), ("decoder.head.2.", "decoder.conv_out."),
                ("conv1.", "quant_conv."), ("conv2.", "post_quant_conv."))


def diffusers_vae_names(sd, num_res_blocks: int):
    """A `WanVAE` state dict under the Qwen-Image VAE's (diffusers) names."""
    out = {}
    for k, v in sd.items():
        if any(t in k for t in ("downsamples.", "upsamples.", "middle.")):
            for old, new in _LEAF_BACK:
                k = k.replace(old, new)
        if k.startswith("decoder.upsamples."):
            parts = k.split(".")
            i, r = divmod(int(parts[2]), num_res_blocks + 2)
            slot = f"resnets.{r}" if r <= num_res_blocks else "upsamplers.0"
            k = f"decoder.up_blocks.{i}.{slot}." + ".".join(parts[3:])
        else:
            for old, new in _PREFIX_BACK:
                if k.startswith(old):
                    k = new + k[len(old):]
                    break
        out[k] = v
    return out


def vae_state_dicts():
    """(the port's drawn `WanVAE` state dict, the same under diffusers names)."""
    _, tcfg = vae_cfgs()
    gen = torch.Generator().manual_seed(9)
    with torch.device("meta"):
        vae = TW.WanVAE(tcfg, dtype=torch.float32)
    vae = TW.init_wan_vae_(vae.to_empty(device="cpu"), gen)
    sd = {k: v.clone() for k, v in vae.state_dict().items()}
    for k, v in sd.items():   # gammas and biases off their init
        if v.dim() <= 4 and ("gamma" in k or k.endswith("bias")):
            sd[k] = v + 0.05 * torch.randn(v.shape, generator=gen)
    return sd, diffusers_vae_names(sd, VAE["num_res_blocks"])


def np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


# ------------------------------------------------------------ RoPE

def test_qwen_rope_bit_equal():
    jcfg, tcfg = dit_cfgs()
    shapes = [(1, 4, 5), (1, 3, 3), (1, 6, 2)]
    for offsets in (None, [0, 2, 5]):
        for a, b in zip(TD.qwen_rope(tcfg, shapes, 7, frame_offsets=offsets),
                        JD.qwen_rope(jcfg, shapes, 7, frame_offsets=offsets)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(TD.qwen_rope(TD.QWEN_IMAGE, [(1, 83, 83)], 31),
                    JD.qwen_rope(JD.QWEN_IMAGE, [(1, 83, 83)], 31)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ DiT

def _dit_inputs(seed: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, DIT["text_dim"])).astype(np.float32)
    extra = rng.standard_normal((1, 16, 6, 8)).astype(np.float32)
    return x, np.array([0.73], np.float32), ctx, extra


def _eligen_bias(s_txt: int, n_img: int):
    rng = np.random.default_rng(3)
    allow = rng.random((s_txt + n_img,) * 2) > 0.3
    np.fill_diagonal(allow, True)
    return np.where(allow, 0.0, np.finfo(np.float32).min).astype(np.float32)[None, None]


@pytest.mark.parametrize("case,dtype", [("plain", "float32"), ("plain", "bfloat16"),
                                        ("extra", "float32"), ("eligen", "float32"),
                                        ("controlnet", "float32")])
def test_dit_forward(case, dtype):
    jcfg, tcfg = dit_cfgs()
    sd = dit_state_dict()
    x, t, ctx, extra = _dit_inputs()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = JD.convert_qwen_image_dit(sd, jcfg, dtype=jdt)
    model = build_module(TD.QwenImageDiT, tcfg, TD.convert_qwen_image_dit(torch_sd(sd), tcfg),
                         "cpu", tdt)
    jkw, tkw = {}, {}
    if case == "extra":
        jkw["extra_latents"] = [jnp.asarray(extra, jdt)]
        tkw["extra_latents"] = [torch.from_numpy(extra).to(tdt)]
    if case == "eligen":
        bias = _eligen_bias(ctx.shape[1], 16)
        jkw["attn_bias"], tkw["attn_bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    if case == "controlnet":
        csd = cn_state_dict()
        jcn = JC.convert_qwen_blockwise_controlnet(csd, dtype=jdt)
        ccfg = TC.blockwise_cn_config_for(csd)
        tcn = build_module(TC.QwenBlockwiseControlNet, ccfg,
                           TC.convert_qwen_blockwise_controlnet(torch_sd(csd), ccfg), "cpu", tdt)
        cond = np.random.default_rng(4).standard_normal((1, 16, 8, 8)).astype(np.float32)
        jcond = JC.qwen_blockwise_cn_process(jcn, jnp.asarray(cond, jdt))
        with torch.no_grad():
            tcond = TC.qwen_blockwise_cn_process(tcn, torch.from_numpy(cond).to(tdt))
        assert _rel(tcond.float().numpy(), np.asarray(jcond, np.float32)) < TOL_F32
        jkw["blockwise_cn"] = [(jcn["blocks"], jcond, 0.7)]
        tkw["blockwise_cn"] = [(tcn, tcond, 0.7)]
    want = np.asarray(JD.qwen_image_dit_forward(jp, jcfg, jnp.asarray(x, jdt), jnp.asarray(t),
                                                jnp.asarray(ctx, jdt), **jkw), np.float32)
    with torch.no_grad():
        got = TD.qwen_image_dit_forward(model, torch.from_numpy(x).to(tdt), torch.from_numpy(t),
                                        torch.from_numpy(ctx).to(tdt), **tkw).float().numpy()
    assert got.shape == x.shape
    tol = TOL_F32 if dtype == "float32" else 2e-2
    assert _rel(got, want) < tol, _rel(got, want)


@pytest.mark.parametrize("additional", [0, 4])
def test_blockwise_cn_block(additional):
    """One block's residual (exact GELU in fp32), and the inpaint variant's
    config (4 more features a token) read from the file."""
    csd = cn_state_dict(additional)
    jcn = JC.convert_qwen_blockwise_controlnet(csd, dtype=jnp.float32)
    cfg = TC.blockwise_cn_config_for(csd)
    assert cfg == TC.QwenBlockwiseCNConfig(num_layers=2, additional_in_dim=additional,
                                           dim=DIT["dim"])
    tcn = build_module(TC.QwenBlockwiseControlNet, cfg,
                       TC.convert_qwen_blockwise_controlnet(torch_sd(csd), cfg), "cpu",
                       torch.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 16, DIT["dim"])).astype(np.float32)
    y = rng.standard_normal((1, 16, DIT["dim"])).astype(np.float32)
    for i in range(cfg.num_layers):
        bp = {k: {kk: vv[i] for kk, vv in v.items()} for k, v in jcn["blocks"].items()}
        want = np.asarray(JC.qwen_blockwise_cn_block(bp, jnp.asarray(x), jnp.asarray(y)))
        with torch.no_grad():
            got = TC.qwen_blockwise_cn_block(tcn.controlnet_blocks[i], torch.from_numpy(x),
                                             torch.from_numpy(y)).numpy()
        assert _rel(got, want) < TOL_F32, _rel(got, want)


# ------------------------------------------------------------ VAE

def test_vae_renames_and_one_frame():
    jcfg, tcfg = vae_cfgs()
    wan_sd, diff_sd = vae_state_dicts()
    assert any(k.startswith("decoder.up_blocks.1.upsamplers.0.") for k in diff_sd)
    converted = TQV.convert_qwen_image_vae(diff_sd)
    assert sorted(converted) == sorted(wan_sd)
    vae = build_module(TW.WanVAE, tcfg, converted, "cpu", torch.float32)
    jparams = JQV.convert_qwen_image_vae(np_sd(diff_sd), dtype=jnp.float32)
    img = np.random.default_rng(7).uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    want_z = np.asarray(JQV.qwen_vae_encode(jparams, jnp.asarray(img), jcfg))
    with torch.no_grad():
        got_z = TQV.qwen_vae_encode(vae, torch.from_numpy(img)).numpy()
    assert got_z.shape == (1, 16, 4, 4)
    assert _rel(got_z, want_z) < 1e-4, _rel(got_z, want_z)
    want = np.asarray(JQV.qwen_vae_decode(jparams, jnp.asarray(want_z), jcfg))
    with torch.no_grad():
        got = TQV.qwen_vae_decode(vae, torch.from_numpy(want_z.copy())).numpy()
    assert got.shape == img.shape
    assert _rel(got, want) < 1e-4, _rel(got, want)


# ------------------------------------------------------------ pipeline

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The DiT, VAE, Qwen2.5-VL and ControlNet files, safetensors."""
    d = tmp_path_factory.mktemp("qwen")
    paths = {}
    for name, sd in (("dit", torch_sd(dit_state_dict())), ("vae", vae_state_dicts()[1]),
                     ("text_encoder", torch_sd(vl_state_dict())), ("cn", torch_sd(cn_state_dict())),
                     ("cn_inpaint", torch_sd(cn_state_dict(4)))):
        paths[name] = str(d / f"{name}.safetensors")
        safetensors_io.save_file(sd, paths[name])
    return paths


def _tiny_configs(mp):
    """Both packages' QWEN_IMAGE (read by `from_pretrained` and
    `load_model`) and Wan2.1 VAE config held to the tiny ones."""
    jcfg, tcfg = dit_cfgs()
    jv, tv = vae_cfgs()
    for mod, name, value in ((JD, "QWEN_IMAGE", jcfg), (JP, "QWEN_IMAGE", jcfg),
                             (TD, "QWEN_IMAGE", tcfg), (JW, "WAN21_VAE", jv),
                             (JP, "WAN21_VAE", jv), (TW, "WAN21_VAE", tv)):
        mp.setattr(mod, name, value)


@pytest.fixture
def tiny_configs(monkeypatch):
    _tiny_configs(monkeypatch)


@pytest.fixture(scope="module")
def pipes(files):
    """The JAX pipeline and the port's on the same files, fp32. The JAX side
    fetches its text encoder through `transformers.AutoTokenizer`, here the
    stand-in tokenizer, and its QwenVL takes the stand-in's special ids."""
    import transformers
    tok = stub_tokenizer()
    with pytest.MonkeyPatch.context() as mp:
        _tiny_configs(mp)
        mp.setattr(transformers.AutoTokenizer, "from_pretrained", staticmethod(lambda path: tok))
        mp.setattr(JE.QwenVL, "__init__", _with_ids(JE.QwenVL.__init__, tok))
        jp = JP.QwenImagePipeline.from_pretrained(dit_paths=files["dit"], vae_path=files["vae"],
                                                  dtype=jnp.float32)
        jp.fetch_text_encoder(files["text_encoder"], "tokenizer")
        tp = TP.QwenImagePipeline.from_pretrained(dit_paths=files["dit"], vae_path=files["vae"],
                                                  device="cpu", dtype=torch.float32)
    tp.fetch_text_encoder(files["text_encoder"], tok)
    for name in ("cn", "cn_inpaint"):
        jp.load_blockwise_controlnet(files[name])
        tp.load_blockwise_controlnet(files[name])
    tp._vl.__dict__.update(token_ids(tok))
    return jp, tp


def _with_ids(init, tok):
    def wrapped(self, *args, **kwargs):
        init(self, *args, **{**token_ids(tok), **kwargs})
    return wrapped


def _mask(top: float, left: float, bottom: float, right: float):
    m = np.zeros((SIZE, SIZE), np.uint8)
    m[int(top * SIZE):int(bottom * SIZE), int(left * SIZE):int(right * SIZE)] = 255
    return Image.fromarray(m)


def _requests():
    img = synthetic_image(21, SIZE, SIZE)
    return {
        "t2i": {},
        "cfg4": dict(cfg_scale=4.0, negative_prompt="blurry"),
        "img2img": dict(input_image=img, denoising_strength=0.6),
        "inpaint": dict(input_image=img, inpaint_mask=_mask(0.25, 0.25, 0.75, 0.75),
                        denoising_strength=0.8),
        "edit": dict(edit_image=synthetic_image(22, SIZE, SIZE), cfg_scale=4.0),
        "edit2": dict(edit_image=[synthetic_image(23, SIZE, SIZE),
                                  synthetic_image(24, 96, SIZE)]),
        "context": dict(context_image=img),
        "eligen": dict(eligen_entity_prompts=["a red fox", "a blue moon"],
                       eligen_entity_masks=[_mask(0, 0, 1, 0.5), _mask(0, 0.5, 0.5, 1)],
                       cfg_scale=2.0),
        "controlnet": dict(blockwise_controlnet_inputs="cn"),
    }


def _cn_inputs(mod, img):
    return [mod.ControlNetInput(controlnet_id=0, scale=0.7, start=1.0, end=0.5, image=img),
            mod.ControlNetInput(controlnet_id=1, scale=1.0, image=img,
                                inpaint_mask=_mask(0.5, 0, 1, 1))]


@pytest.mark.parametrize("case", list(_requests()))
def test_pipeline_matches_jax(pipes, case):
    jp, tp = pipes
    req = _requests()[case]
    base = dict(prompt="a lighthouse on a cliff at dawn", cfg_scale=1.0, height=SIZE,
                width=SIZE, seed=42, num_inference_steps=2, return_latents=True)
    jreq, treq = {**base, **req}, {**base, **req}
    if case == "controlnet":
        cimg = synthetic_image(25, SIZE, SIZE)
        jreq["blockwise_controlnet_inputs"] = _cn_inputs(JP, cimg)
        treq["blockwise_controlnet_inputs"] = _cn_inputs(TP, cimg)
    want = np.asarray(jp(**jreq), np.float32)
    got = tp(**treq).float().numpy()
    assert got.shape == want.shape == (1, 16, SIZE // 8, SIZE // 8)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_pipeline_decode_and_stages(pipes):
    jp, tp = pipes
    image = tp(prompt="a fox", height=SIZE, width=SIZE, seed=1, num_inference_steps=2,
               cfg_scale=1.0, edit_image=synthetic_image(26, SIZE, SIZE))
    assert image.size == (SIZE, SIZE)
    stages = [name for name, _ in tp.stage_times]
    for name in ("vision_encode", "text_encode_edit", "vae_encode_extra", "denoise_step_0",
                 "denoise_step_1", "vae_decode"):
        assert name in stages
    lat = tp(prompt="a fox", height=SIZE, width=SIZE, seed=1, num_inference_steps=2,
             cfg_scale=1.0, return_latents=True)
    want = np.asarray(jp.decode_image(jnp.asarray(lat.numpy())))
    got = tp.decode_image(lat).numpy()
    assert _rel(got, want) < 1e-4, _rel(got, want)


def test_scheduler_matches_jax():
    from video_styler_tpu.schedulers import FlowMatchScheduler as JS
    from video_styler_tpu_torch.schedulers.flow_match import FlowMatchScheduler as TS
    kw = dict(sigma_min=0.0, sigma_max=1.0, extra_one_step=True, exponential_shift=True,
              exponential_shift_mu=0.8, shift_terminal=0.02)
    js, ts = JS(**kw), TS(**kw)
    for steps, strength, seq, mu in ((30, 1.0, 6889, None), (4, 0.6, 16, None),
                                     (8, 1.0, None, 1.1), (8, 1.0, None, None)):
        js.set_timesteps(steps, denoising_strength=strength, dynamic_shift_len=seq,
                         exponential_shift_mu=mu)
        ts.set_timesteps(steps, denoising_strength=strength, dynamic_shift_len=seq,
                         exponential_shift_mu=mu)
        np.testing.assert_array_equal(ts.sigmas, js.sigmas)
        np.testing.assert_array_equal(ts.timesteps, js.timesteps)


def test_transformers_backend_raises():
    """An unknown backend is refused; the transformers backend (held against
    the native path in test_torch_transformers_backends.py) raises on a
    model directory that is not there."""
    pipe = TP.QwenImagePipeline(device="cpu")
    with pytest.raises(ValueError, match="unknown text-encoder backend"):
        pipe.fetch_text_encoder("te.safetensors", "tok", backend="jax")
    with pytest.raises(OSError):
        pipe.fetch_text_encoder("no_such_model_dir", lambda *a, **k: None,
                                backend="transformers")


# ------------------------------------------------------------ files

def test_converters_and_load_model(files, tiny_configs):
    """`load_model` builds both kinds from the files. The JAX detector calls
    a Qwen-Image DiT file `flux_dit` (its `img_in` matches FLUX's BFL
    rule before the Qwen rule is reached; ROADMAP Queue 3); the port
    detects it by its text norm and dual-stream blocks."""
    jcfg, tcfg = dit_cfgs()
    sd = dit_state_dict()
    assert JCK.detect_model_kind(sd) == "flux_dit"
    kind, dit = TCK.load_model(files["dit"], device="cpu", dtype=torch.float32)
    assert kind == "qwen_image_dit" and dit.cfg == tcfg
    jp = JD.convert_qwen_image_dit(sd, jcfg, dtype=jnp.float32)
    np.testing.assert_array_equal(
        dit.transformer_blocks[1].attn.add_k_proj.weight.detach().numpy().T,
        np.asarray(jp["transformer_blocks"]["attn"]["add_k_proj"]["w"][1]))
    np.testing.assert_array_equal(dit.txt_norm.weight.detach().numpy(),
                                  np.asarray(jp["txt_norm"]["weight"]))
    for name, additional in (("cn", 0), ("cn_inpaint", 4)):
        csd = cn_state_dict(additional)
        assert JCK.detect_model_kind(csd) == "qwen_image_blockwise_controlnet"
        kind, cn = TCK.load_model(files[name], device="cpu", dtype=torch.float32)
        assert kind == "qwen_image_blockwise_controlnet"
        assert cn.cfg.additional_in_dim == additional
        jcn = JC.convert_qwen_blockwise_controlnet(csd, dtype=jnp.float32)
        np.testing.assert_array_equal(cn.img_in.weight.detach().numpy().T,
                                      np.asarray(jcn["img_in"]["w"]))
        np.testing.assert_array_equal(
            cn.controlnet_blocks[1].y_rms.weight.detach().numpy(),
            np.asarray(jcn["blocks"]["y_rms"]["scale"][1]))
    assert not {"qwen_image_dit", "qwen_image_blockwise_controlnet"} & set(TCK.UNPORTED_KINDS)


# ------------------------------------------------------------ CLI

def _jax_image_gen():
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "image_gen.py")
    spec = importlib.util.spec_from_file_location("jax_examples_image_gen", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_run_qwen_fault_and_port_cli(files, tiny_configs, monkeypatch, tmp_path):
    """`examples/image_gen.py` `run_qwen` never fetches a text encoder, so
    its pipeline calls None at the prompt (a TypeError; ROADMAP Queue 3).
    The port's `image_gen --family qwen` takes --text_encoder_path and
    --tokenizer_path, and without them raises a RuntimeError naming what
    it lacks."""
    a = argparse.Namespace(dit_path=files["dit"], vae_path=files["vae"], prompt="a fox",
                           negative_prompt="", cfg_scale=4.0, steps=2, height=SIZE, width=SIZE,
                           seed=0)
    with pytest.raises(TypeError, match="NoneType"):
        _jax_image_gen().run_qwen(a)
    argv = ["--family", "qwen", "--dit_path", files["dit"], "--vae_path", files["vae"],
            "--device", "cpu", "--steps", "2", "--height", str(SIZE), "--width", str(SIZE),
            "--cfg_scale", "4", "--output", str(tmp_path / "q.png")]
    with pytest.raises(RuntimeError, match="no text encoder.*--text_encoder_path"):
        image_gen.main(argv)
    with pytest.raises(RuntimeError, match="needs --tokenizer_path"):
        image_gen.main(argv + ["--text_encoder_path", files["text_encoder"]])
    import transformers
    tok = stub_tokenizer()
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path: tok))
    # the stand-in's special ids sit at its vocabulary's top, not at Qwen's
    init = TP.QwenVL.__init__
    monkeypatch.setattr(TP.QwenVL, "__init__", _with_ids(init, tok))
    assert image_gen.main(argv + ["--text_encoder_path", files["text_encoder"],
                                  "--tokenizer_path", "tok"]) == 0
    assert Image.open(tmp_path / "q.png").size == (SIZE, SIZE)


def test_image_gen_qwen_smoke_cli(tmp_path, capsys):
    out = tmp_path / "qwen.png"
    assert image_gen.main(["--family", "qwen", "--smoke", "--device", "cpu",
                           "--output", str(out)]) == 0
    assert Image.open(out).size == (image_gen.SMOKE_SIZE, image_gen.SMOKE_SIZE)
    assert f"saved {out}" in capsys.readouterr().out
