"""SD 1.5 against the JAX package: the UNet (`sd_unet_forward`, fp32 and
bf16, with ControlNet residuals and IP-Adapter kv pairs), CLIP-L
(`sd_text_encoder_forward` at two clip skips), the SD VAE (encoder and
decoder at the release widths), `EnhancedDDIMScheduler` (tables, steps,
`return_to_timestep`, `add_noise`, v-prediction, zero terminal SNR),
`utils.sd_civitai` (names and tensors bit for bit on one synthetic civitai
file), `SDImagePipeline` over 2 steps (t2i, img2img, local prompts,
textual inversion, `from_civitai_file`), `load_model` on the `sd_unet`
kind, and `image_gen --family sd --smoke`.

The JAX package has no init for these models: the port draws them
(`init_sd_module_`, a torch seed) and the JAX converter reads the same
state dict under the reference's (DiffSynth) names. Widths: `SD_UNET_TINY`
(32/32/64/64, 8 heads of 4 and 8, the 32 groups of GroupNorm set the
least width) with a 48-wide CLIP-L of 12 heads and 3 layers (the JAX
forwards' head count); the VAE at its release widths. Requests of
128x128 (16x16 latents: at 8x8 the innermost level is 1x1, GroupNorm
takes two values a group, and the random UNet's output moves ~1e-4 for
a 1e-7 change of its context in either package). fp32 within 2e-5 relative L2; bf16 within the bound stated
at its test.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.sd as JS
from video_styler_tpu.pipelines.sd_image import SDImagePipeline as JPipe
from video_styler_tpu.schedulers.ddim import EnhancedDDIMScheduler as JDDIM
from video_styler_tpu.utils import sd_civitai as JC

import video_styler_tpu_torch.models.sd as TS
from video_styler_tpu_torch import image_gen
from video_styler_tpu_torch.models.sd3_text_encoder import ClipTextEncoder
from video_styler_tpu_torch.models.sdxl import CLIP_L_TINY_12
from video_styler_tpu_torch.pipelines.sd_image import SDImagePipeline as TPipe
from video_styler_tpu_torch.safetensors_io import save_file
from video_styler_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler as TDDIM
from video_styler_tpu_torch.utils import ckpt as TC
from video_styler_tpu_torch.utils import sd_civitai as TCV

from test_torch_flux import _reference_names
from test_torch_fun import _rel
from test_torch_pipeline import cpu_share  # noqa: F401

TOL_F32 = 2e-5
TOL_BF16 = 3e-2     # bf16 rounding through 67 blocks, both packages in bf16
SIZE = 128


@pytest.fixture(autouse=True, scope="module")
def jit_jax_vae():
    """The JAX VAE functions jitted (their eager run at full width takes
    tens of seconds); the pipelines read them from the module."""
    mp = pytest.MonkeyPatch()
    for name in ("sd_vae_encoder_forward", "sd_vae_decoder_forward"):
        mp.setattr(JS, name, jax.jit(getattr(JS, name)))
    yield
    mp.undo()


def draw(module, seed: int):
    """A port module's random weights (biases and norms off their defaults)."""
    return TS.init_sd_module_(module, torch.Generator().manual_seed(seed)).eval()


def jparams(module, dtype=jnp.float32):
    """The JAX tree of a port module, through the JAX converter."""
    return JS.convert_sd_module(_reference_names(module), dtype)


@functools.lru_cache(maxsize=None)
def sd_models():
    """(UNet, CLIP-L, VAE encoder, VAE decoder), fp32."""
    return (draw(TS.SDUNet(TS.SD_UNET_TINY), 1), draw(ClipTextEncoder(CLIP_L_TINY_12), 2),
            draw(TS.SDVAEEncoder(), 3), draw(TS.SDVAEDecoder(), 4))


def unet_inputs(seed: int = 5, batch: int = 1, text: int = 77):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 4, SIZE // 8, SIZE // 8)).astype(np.float32)
    ctx = rng.standard_normal((1, text, TS.SD_UNET_TINY.text_dim)).astype(np.float32)
    return x, np.array([437.0], np.float32), ctx


def cn_stack(unet, seed: int = 6):
    """13 residuals of the ControlNet trunk's widths."""
    rng = np.random.default_rng(seed)
    _, pushed = TS.program_widths(
        __import__("video_styler_tpu_torch.models.controlnet",
                   fromlist=["x"]).SD_CONTROLNET_PROGRAM, unet.cfg)
    sizes = [16, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2, 2]
    return [0.3 * rng.standard_normal((1, w, s, s)).astype(np.float32)
            for w, s in zip(pushed, sizes)]


# ------------------------------------------------------------ UNet

@pytest.mark.parametrize("hooks", ["plain", "controlnet", "ipadapter"])
def test_unet_matches_jax_fp32(hooks):
    unet = sd_models()[0]
    x, t, ctx = unet_inputs()
    cn = cn_stack(unet) if hooks == "controlnet" else None
    ip_t = ip_j = None
    if hooks == "ipadapter":
        rng = np.random.default_rng(7)
        ip_np = {}
        for b in (1, 29, 60):
            w = TS.program_widths(TS.SD_UNET_PROGRAM, unet.cfg)[0][b][3]
            ip_np[b] = (rng.standard_normal((1, 4, w)).astype(np.float32),
                        rng.standard_normal((1, 4, w)).astype(np.float32), 0.7)
        ip_t = {b: {0: (torch.from_numpy(k), torch.from_numpy(v), s)}
                for b, (k, v, s) in ip_np.items()}
        ip_j = {b: {0: (jnp.asarray(k), jnp.asarray(v), s)} for b, (k, v, s) in ip_np.items()}
    want = np.asarray(JS.sd_unet_forward(
        jparams(unet), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        controlnet_res_stack=None if cn is None else [jnp.asarray(r) for r in cn],
        ipadapter_kwargs_list=ip_j))
    with torch.no_grad():
        got = TS.sd_unet_forward(unet, torch.from_numpy(x), torch.from_numpy(t),
                                 torch.from_numpy(ctx),
                                 controlnet_res_stack=None if cn is None else
                                 [torch.from_numpy(r) for r in cn],
                                 ipadapter_kwargs_list=ip_t).numpy()
    assert got.shape == (1, 4, SIZE // 8, SIZE // 8)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_unet_matches_jax_bf16():
    unet = sd_models()[0]
    x, t, ctx = unet_inputs()
    want = np.asarray(jax.jit(JS.sd_unet_forward)(
        jparams(unet, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
        jnp.asarray(ctx, jnp.bfloat16)), np.float32)
    port = draw(TS.SDUNet(TS.SD_UNET_TINY), 1).to(torch.bfloat16)
    with torch.no_grad():
        got = TS.sd_unet_forward(port, torch.from_numpy(x).bfloat16(), torch.from_numpy(t),
                                 torch.from_numpy(ctx).bfloat16()).float().numpy()
    assert _rel(got, want) < TOL_BF16, _rel(got, want)


def test_unet_release_widths():
    """SD 1.5's UNet: 859.5 M parameters, the blocks' widths and depths of
    the release, read back from the module."""
    with torch.device("meta"):
        unet = TS.SDUNet(TS.SD_UNET)
    assert round(sum(p.numel() for p in unet.parameters()) / 1e6, 1) == 859.5
    assert TS.detect_unet_config(unet.state_dict(), TS.SD_UNET_PROGRAM) == TS.SD_UNET
    assert len(unet.blocks) == len(TS.SD_UNET_PROGRAM) == 67


# ------------------------------------------------------------ CLIP-L, VAE

@pytest.mark.parametrize("clip_skip", [1, 2])
def test_text_encoder_matches_jax(clip_skip):
    te = sd_models()[1]
    ids = np.random.default_rng(8).integers(0, 128, (2, 77))
    want = np.asarray(JS.sd_text_encoder_forward(jparams(te), jnp.asarray(ids),
                                                 clip_skip=clip_skip, num_layers=3))
    with torch.no_grad():
        got = TS.sd_text_encoder_forward(te, torch.from_numpy(ids), clip_skip=clip_skip).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_vae_matches_jax():
    _, _, enc, dec = sd_models()
    x = np.random.default_rng(9).uniform(-1, 1, (1, 3, SIZE, SIZE)).astype(np.float32)
    want_z = np.asarray(JS.sd_vae_encoder_forward(jparams(enc), jnp.asarray(x)))
    want_y = np.asarray(JS.sd_vae_decoder_forward(jparams(dec), jnp.asarray(want_z)))
    with torch.no_grad():
        got_z = TS.sd_vae_encoder_forward(enc, torch.from_numpy(x)).numpy()
        got_y = TS.sd_vae_decoder_forward(dec, torch.from_numpy(want_z)).numpy()
    assert got_z.shape == (1, 4, SIZE // 8, SIZE // 8) and got_y.shape == (1, 3, SIZE, SIZE)
    assert _rel(got_z, want_z) < TOL_F32, _rel(got_z, want_z)
    assert _rel(got_y, want_y) < TOL_F32, _rel(got_y, want_y)


# ------------------------------------------------------------ DDIM

@pytest.mark.parametrize("kw", [dict(), dict(beta_schedule="linear"),
                                dict(prediction_type="v_prediction",
                                     rescale_zero_terminal_snr=True),
                                dict(beta_end=0.014, num_train_timesteps=1100)])
def test_ddim_matches_jax(kw):
    """Tables, timesteps (with a denoising strength) and every update, bit
    for bit (fp32 tensors against numpy fp32 arrays)."""
    j, t = JDDIM(**kw), TDDIM(**kw)
    assert j.alphas_cumprod == t.alphas_cumprod
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    e = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    for steps, strength in ((20, 1.0), (7, 0.6), (1, 1.0)):
        j.set_timesteps(steps, denoising_strength=strength)
        t.set_timesteps(steps, denoising_strength=strength)
        np.testing.assert_array_equal(j.timesteps, t.timesteps)
        for ts in j.timesteps:
            tt = torch.tensor([float(ts)])
            for to_final in (False, True):
                np.testing.assert_array_equal(
                    t.step(torch.from_numpy(e), tt, torch.from_numpy(x), to_final).numpy(),
                    j.step(e, ts, x, to_final))
            np.testing.assert_array_equal(
                t.return_to_timestep(ts, torch.from_numpy(x), torch.from_numpy(e)).numpy(),
                j.return_to_timestep(ts, x, e))
            np.testing.assert_array_equal(t.add_noise(torch.from_numpy(x), torch.from_numpy(e),
                                                      ts).numpy(), j.add_noise(x, e, ts))
            np.testing.assert_array_equal(
                t.training_target(torch.from_numpy(x), torch.from_numpy(e), ts).numpy(),
                j.training_target(x, e, ts))


# ------------------------------------------------------------ civitai

_INV_RES = {v: k for k, v in TCV._RES_LEAVES.items()}


def civitai_file(unet, te, enc, dec, unet_map=None, te_prefix="cond_stage_model.transformer."
                 "text_model.") -> dict:
    """The modules' tensors under the LDM names (the renames inverted,
    `proj_in`/`proj_out` as 1x1 convs, positions without their batch axis)."""
    out = {}
    inv = {v: k for k, v in (unet_map or TCV.sd_unet_rename_map()).items()}
    for k, v in _reference_names(unet).items():
        module, leaf = k.rsplit(".", 1)
        if ".proj_in" in k or ".proj_out" in k:
            v = v[:, :, None, None] if v.ndim == 2 else v
        out[f"model.diffusion_model.{inv[module]}.{leaf}"] = v
    for side, mod, mp in (("enc", enc, TCV.sd_vae_encoder_rename_map()),
                          ("dec", dec, TCV.sd_vae_decoder_rename_map())):
        inv = {v: k for k, v in mp.items()}
        for k, v in _reference_names(mod).items():
            module, leaf = k.rsplit(".", 1)
            if ".transformer_blocks." in k and v.ndim == 2:
                v = v[:, :, None, None]
            out[f"first_stage_model.{inv[module]}.{leaf}"] = v
    leaves = {v: k for k, v in TCV._CLIP_LEAVES.items()}
    for k, v in _reference_names(te).items():
        if k == "token_embedding.weight":
            out[te_prefix + "embeddings.token_embedding.weight"] = v
        elif k == "position_embeds":
            out[te_prefix + "embeddings.position_embedding.weight"] = v[0]
        elif k.startswith("final_layer_norm."):
            out[te_prefix + k] = v
        else:
            _, layer, rest = k.split(".", 2)
            module, leaf = rest.rsplit(".", 1)
            out[f"{te_prefix}encoder.layers.{layer}.{leaves[module]}.{leaf}"] = v
    return out


def test_civitai_maps_match_jax():
    """The rename maps are the JAX converter's, and one civitai file
    converts to the same names and tensors, which are the modules'."""
    assert TCV.sd_unet_rename_map() == JC.sd_unet_rename_map()
    assert TCV.sd_vae_encoder_rename_map() == JC.sd_vae_encoder_rename_map()
    assert TCV.sd_vae_decoder_rename_map() == JC.sd_vae_decoder_rename_map()
    unet, te, enc, dec = sd_models()
    f = civitai_file(unet, te, enc, dec)
    got, want = TCV.convert_sd_civitai(f), JC.convert_sd_civitai(f)
    for part, mod in zip(("unet", "text_encoder", "vae_encoder", "vae_decoder"),
                         (unet, te, enc, dec)):
        assert sorted(got[part]) == sorted(want[part]) == sorted(_reference_names(mod)), part
        for k in got[part]:
            np.testing.assert_array_equal(np.asarray(got[part][k]), np.asarray(want[part][k]))
            np.testing.assert_array_equal(np.asarray(got[part][k]), _reference_names(mod)[k])


# ------------------------------------------------------------ pipeline

@functools.lru_cache(maxsize=None)
def pipes():
    """The JAX and port SD pipelines on the same weights, fp32, no
    tokenizer (the JAX pipeline's stand-in ids)."""
    unet, te, enc, dec = sd_models()
    sds = dict(unet_sd=_reference_names(unet), text_encoder_sd=_reference_names(te),
               vae_encoder_sd=_reference_names(enc), vae_decoder_sd=_reference_names(dec))
    jp = JPipe.from_state_dicts(**sds, dtype=jnp.float32)
    jp.num_text_layers = 3
    tp = TPipe.from_state_dicts(**sds, device="cpu", dtype=torch.float32)
    return jp, tp


def picture(seed: int, size: int = SIZE) -> Image.Image:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    arr = np.stack([127 + 100 * np.sin(xx / (5 + c) + yy / 7 + seed) for c in range(3)], -1)
    return Image.fromarray((arr + rng.normal(0, 5, arr.shape)).clip(0, 255).astype(np.uint8))


def half_mask(size: int = SIZE) -> Image.Image:
    m = np.zeros((size, size), np.uint8)
    m[:, : size // 2] = 255
    return Image.fromarray(m)


REQUESTS = {
    "t2i": dict(),
    "cfg1": dict(cfg_scale=1.0),
    "img2img": dict(input_image=picture(11), denoising_strength=0.7),
    "local_prompts": dict(local_prompts=["a red roof"], masks=[half_mask()], mask_scales=[2.0]),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_pipeline_matches_jax(name):
    jp, tp = pipes()
    base = dict(prompt="a lighthouse at dawn", negative_prompt="blurry", cfg_scale=7.5,
                height=SIZE, width=SIZE, num_inference_steps=2, seed=3, return_latents=True)
    request = {**base, **REQUESTS[name]}
    want = np.asarray(jp(**request))
    got = tp(**request).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_pipeline_image_matches_jax():
    """The decoded picture of a request (uint8, off by at most one level)."""
    jp, tp = pipes()
    req = dict(prompt="a cat on a roof", negative_prompt="", height=SIZE, width=SIZE,
               num_inference_steps=2, seed=4)
    want, got = np.asarray(jp(**req), np.float32), np.asarray(tp(**req), np.float32)
    assert want.shape == got.shape == (SIZE, SIZE, 3)
    assert np.abs(want - got).max() <= 1, np.abs(want - got).max()


class AddTokenizer:
    """A stand-in CLIP tokenizer that can add tokens (textual inversion):
    the start id, one id per word (an added token's own id past the
    vocabulary, else crc32 into it), the end id, padding with it."""

    def __init__(self, vocab: int):
        self.vocab, self.added = vocab, {}

    def add_tokens(self, tokens):
        for t in tokens:
            self.added[t] = self.vocab + len(self.added)

    def __call__(self, texts, max_length: int = 77, **kw):
        import zlib
        text = texts if isinstance(texts, str) else texts[0]
        words = [self.added.get(w, 1 + zlib.crc32(w.encode()) % (self.vocab - 3))
                 for w in text.split()]
        ids = [self.vocab - 2] + words[:max_length - 2] + [self.vocab - 1]
        return {"input_ids": np.asarray([ids + [self.vocab - 1] * (max_length - len(ids))])}


def test_textual_inversion_matches_jax(tmp_path):
    """A file's first 768-wide 2-D tensor becomes new token rows under its
    keyword (the JAX pipeline looks for CLIP-L's 768 only; the port for the
    token table's width), read by both packages from one file: the
    prompt's ids and its embedding agree."""
    import dataclasses
    cfg = dataclasses.replace(CLIP_L_TINY_12, dim=768, ffn_dim=128, num_layers=1)
    te = draw(ClipTextEncoder(cfg), 13)
    rows = np.random.default_rng(12).standard_normal((2, 768)).astype(np.float32)
    path = str(tmp_path / "wtchr.safetensors")
    save_file({"emb_params": torch.from_numpy(rows)}, path)
    jp = JPipe.from_state_dicts(text_encoder_sd=_reference_names(te), dtype=jnp.float32)
    jp.num_text_layers, jp.tokenizer = 1, AddTokenizer(cfg.vocab)
    tp = TPipe.from_state_dicts(text_encoder_sd=_reference_names(te), device="cpu",
                                dtype=torch.float32)
    tp.tokenizer = AddTokenizer(cfg.vocab)
    jp.load_textual_inversions(paths=[path])
    tp.load_textual_inversions(paths=[path])
    assert tp.text_encoder.token_embedding.weight.shape[0] == cfg.vocab + 2
    prompt = "a wtchr cat"
    assert tp._apply_ti_keywords(prompt) == jp._apply_ti_keywords(prompt) \
        == "a  wtchr_0 wtchr_1  cat"
    assert cfg.vocab + 1 in tp.prompt_ids(prompt)
    want = np.asarray(jp.encode_prompt(prompt))
    got = tp.encode_prompt(prompt).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_from_civitai_file_and_load_model(tmp_path):
    """A civitai file builds the same modules as the state dicts; its UNet
    loads as kind `sd_unet` (bare LDM names too), which the JAX loader
    keeps under LDM names its UNet cannot read (ROADMAP Queue 3)."""
    unet, te, enc, dec = sd_models()
    f = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in civitai_file(unet, te, enc, dec).items()}
    path = str(tmp_path / "sd15.safetensors")
    save_file(f, path)
    tp = TPipe.from_civitai_file(path, device="cpu", dtype=torch.float32)
    for mine, ref in ((tp.unet, unet), (tp.text_encoder, te), (tp.vae_encoder, enc),
                      (tp.vae_decoder, dec)):
        for k, v in ref.state_dict().items():
            torch.testing.assert_close(mine.state_dict()[k], v, rtol=0, atol=0, msg=k)
    bare = str(tmp_path / "unet.safetensors")
    save_file({k[len("model.diffusion_model."):]: v for k, v in f.items()
               if k.startswith("model.diffusion_model.")}, bare)
    for p in (path, bare):
        kind, model = TC.load_model(p, device="cpu", dtype=torch.float32)
        assert kind == "sd_unet" and isinstance(model, TS.SDUNet)
        assert model.cfg == TS.SD_UNET_TINY
        for k, v in unet.state_dict().items():
            torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    from video_styler_tpu.utils.ckpt import load_model as jload
    jkind, jtree = jload(bare, dtype=jnp.float32)
    assert jkind == "sd_unet" and "input_blocks" in jtree and "blocks" not in jtree


def test_image_gen_sd_smoke_cli(tmp_path, capsys):
    out = tmp_path / "sd.png"
    assert image_gen.main(["--family", "sd", "--smoke", "--device", "cpu",
                           "--output", str(out)]) == 0
    assert Image.open(out).size == (image_gen.SMOKE_SIZE, image_gen.SMOKE_SIZE)
    assert f"saved {out}" in capsys.readouterr().out
