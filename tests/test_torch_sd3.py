"""The SD3 / SD3.5 family against the JAX package: CLIP-G
(`sdxl_text_encoder_2_forward`, fp32 at two clip skips and bf16) and its
converter, the SD3 DiT medium-style (no q/k norm, no dual block) and
SD3.5-style (RMS q/k norm, one MMDiT-X dual block) in fp32 and bf16,
`infer_sd3_config` and `rename_civitai_sd3` on one synthetic civitai file,
the SD3 prompter (with and without T5; its refusals), `SD3ImagePipeline`
(t2i, img2img, local prompts, with T5) on the same weights,
`from_pretrained` (files back bit for bit; like the JAX pipeline it loads
no text encoder), `load_model` on the `sd3_dit` kind, and `image_gen
--family sd3 --smoke`.

Weights: the DiT from the JAX init with biases, norm weights and the
position table perturbed from a numpy seed; CLIP-L, CLIP-G and the SD3 VAE
drawn by the port and read by both converters under the reference's
names; T5 v1.1 from the JAX init at 4096 wide (the prompter pads CLIP to
4096 and stacks T5's rows under it). Widths: DiTs 128 wide (2 heads of
64), 3 layers, 16-wide position table; CLIP-L 32 wide, CLIP-G 40 wide
with the JAX forward's 20 heads (of 2), 3 layers each (the JAX prompter's
calls are held to 3 layers); T5 one layer. Requests of 64x64 (16 image
tokens), 8 T5 rows, 3 steps, CFG 4. On the CPU both packages take the
exact `sdpa` for heads of 64: fp32 within 2e-5 relative L2, bf16 within
the bound stated at the test.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.sd3_dit as JD
import video_styler_tpu.models.sd3_text_encoder as JCT
import video_styler_tpu.models.sdxl as JX
from video_styler_tpu.models.sd3_vae import convert_sd3_vae
from video_styler_tpu.models.t5 import T5Config as JT5Config, init_t5
from video_styler_tpu.pipelines.sd3_image import SD3ImagePipeline as JPipe
from video_styler_tpu.utils import ckpt as JCK

import video_styler_tpu_torch.models.sd3_dit as TD
from video_styler_tpu_torch import image_gen
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.models import sd3_vae as TV
from video_styler_tpu_torch.models.sd3_text_encoder import (CLIP_L_TINY, ClipTextEncoder,
                                                            init_clip_text_)
from video_styler_tpu_torch.models.sdxl import (CLIP_G_TINY, SDXLTextEncoder2,
                                                convert_sdxl_module, sdxl_text_encoder_2_forward)
from video_styler_tpu_torch.models.t5 import T5Config
from video_styler_tpu_torch.pipelines.sd3_image import SD3ImagePipeline as TPipe
from video_styler_tpu_torch.prompters.flux_prompter import StubClipTokenizer, StubT5Tokenizer
from video_styler_tpu_torch.prompters.sd3_prompter import SD3Prompter
from video_styler_tpu_torch.safetensors_io import save_file
from video_styler_tpu_torch.utils import ckpt as TCK

from test_torch_flux import _cast, _reference_names
from test_torch_fun import _rel
from test_torch_pipeline import _tree, cpu_share  # noqa: F401

TOL_F32 = 2e-5
T5_LEN = 8
T5_4096 = dict(vocab=128, dim=4096, dim_attn=64, dim_ffn=128, num_heads=4, num_layers=1,
               shared_pos=True)
POOLED = CLIP_L_TINY.dim + CLIP_G_TINY.dim
MEDIUM = JD.SD3DiTConfig(dim=128, num_layers=3, pos_embed_max_size=16, context_dim=64,
                         pooled_dim=32)
DIT_CASES = {"medium": MEDIUM, "sd35": JD.SD3_DIT_TINY}


def _port(jcfg) -> TD.SD3DiTConfig:
    return TD.SD3DiTConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(TD.SD3DiTConfig)})


@functools.lru_cache(maxsize=None)
def _dit_tree(case: str, **over):
    cfg = dataclasses.replace(DIT_CASES[case], **over)
    tree = _tree(JD.init_sd3_dit(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)

    def perturb(path, a):
        leaf = jax.tree_util.keystr(path)
        if any(leaf.endswith(f"['{n}']") for n in ("b", "weight", "pos_embed")):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return cfg, jax.tree_util.tree_map_with_path(perturb, tree)


# ------------------------------------------------------------ CLIP-G

@functools.lru_cache(maxsize=None)
def _clip_g():
    gen = torch.Generator().manual_seed(2)
    model = init_clip_text_(SDXLTextEncoder2(CLIP_G_TINY), gen).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _ids(seed: int, vocab: int, length: int = 77):
    ids = np.random.default_rng(seed).integers(0, vocab - 2, (2, length))
    ids[0, 9], ids[1, 30] = vocab - 1, vocab - 1       # one end id a row
    return ids


@pytest.mark.parametrize("clip_skip", [1, 2])
def test_clip_g_fp32(clip_skip):
    model = _clip_g()
    jp = _tree(JX.convert_sdxl_module(_reference_names(model)))
    ids = _ids(3, CLIP_G_TINY.vocab)
    jpool, jhid = JX.sdxl_text_encoder_2_forward(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(ids), clip_skip=clip_skip,
        num_layers=CLIP_G_TINY.num_layers)
    with torch.no_grad():
        pool, hid = sdxl_text_encoder_2_forward(model, torch.from_numpy(ids), clip_skip=clip_skip)
    assert pool.shape == (2, 40) and hid.shape == (2, 77, 40)
    assert _rel(pool.numpy(), np.asarray(jpool)) < TOL_F32
    assert _rel(hid.numpy(), np.asarray(jhid)) < TOL_F32


def test_clip_g_bf16_and_converter():
    """The reference-named state dict through both converters (bit-equal
    modules), then both towers in bf16."""
    model = _clip_g()
    sd = _reference_names(model)
    jtree = _tree(JX.convert_sdxl_module(sd, jnp.float32))
    port = SDXLTextEncoder2(CLIP_G_TINY)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in convert_sdxl_module(sd).items()},
                         strict=True)
    for k, v in from_jax_params("clip_g_text", jtree, CLIP_G_TINY, device="cpu"
                                ).state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=0, msg=k)
    ids = _ids(4, CLIP_G_TINY.vocab)
    jpool, jhid = JX.sdxl_text_encoder_2_forward(
        jax.tree_util.tree_map(jnp.asarray, _cast(jtree, jnp.bfloat16)), jnp.asarray(ids),
        num_layers=CLIP_G_TINY.num_layers)
    with torch.no_grad():
        pool, hid = sdxl_text_encoder_2_forward(port.to(torch.bfloat16), torch.from_numpy(ids))
    # bf16 roundings of the linears and LayerNorms through 3 layers (the
    # same exact attention on both sides). Measured ~0.4%
    assert _rel(pool.float().numpy(), np.asarray(jpool, np.float32)) < 2e-2
    assert _rel(hid.float().numpy(), np.asarray(jhid, np.float32)) < 2e-2


# ------------------------------------------------------------ the DiT

def _dit_inputs(cfg, seed: int = 5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 16, 8, 8)).astype(np.float32), np.array([600.0], np.float32),
            rng.standard_normal((1, 12, cfg.context_dim)).astype(np.float32),
            rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32))


def _run_dit(case, jdtype, tdtype):
    cfg, tree = _dit_tree(case)
    x, t, ctx, pooled = _dit_inputs(cfg)
    jt = _cast(tree, jdtype)
    want = np.asarray(jax.jit(lambda p, *a: JD.sd3_dit_forward(p, cfg, *a))(
        jt, jnp.asarray(x, jdtype), t, jnp.asarray(ctx, jdtype), jnp.asarray(pooled, jdtype)),
        np.float32)
    model = from_jax_params("sd3_dit", jt, _port(cfg), device="cpu")
    tt = lambda a: torch.from_numpy(a).to(tdtype)  # noqa: E731
    with torch.no_grad():
        got = TD.sd3_dit_forward(model, tt(x), torch.from_numpy(t), tt(ctx), tt(pooled))
    return got.float().numpy(), want


@pytest.mark.parametrize("case", sorted(DIT_CASES))
def test_sd3_dit_fp32(case):
    got, want = _run_dit(case, jnp.float32, torch.float32)
    assert got.shape == (1, 16, 8, 8)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


@pytest.mark.parametrize("case", sorted(DIT_CASES))
def test_sd3_dit_bf16(case):
    got, want = _run_dit(case, jnp.bfloat16, torch.bfloat16)
    # bf16 activations through 3 blocks; both sides the exact softmax, CPU
    # GEMM and elementwise roundings that differ by an ULP. Measured <1%
    assert _rel(got, want) < 3e-2, _rel(got, want)


def _diffsynth_names(model: TD.SD3DiT):
    """The port's DiT under the reference's DiffSynth names (the patch
    linear back to a 2x2 conv; dual, regular and final blocks as one
    `blocks.{i}` run)."""
    cfg = model.cfg
    out = {}
    for k, v in model.state_dict().items():
        v = v.clone()
        if k == "pos_embedder.proj.weight":
            v = v.reshape(v.shape[0], cfg.in_channels, 2, 2)
        for emb, src in (("time_embedder", "time_embedder.timestep_embedder"),
                         ("pooled_text_embedder", "pooled_text_embedder")):
            if k.startswith(emb + ".fc"):
                k = f"{src}.{'0' if '.fc1.' in k else '2'}.{k.rsplit('.', 1)[1]}"
        if k.startswith("dual_blocks."):
            k = "blocks." + k[len("dual_blocks."):]
        elif k.startswith("blocks."):
            i, rest = k[len("blocks."):].split(".", 1)
            k = f"blocks.{int(i) + cfg.num_dual_blocks}.{rest}"
        elif k.startswith("final_block."):
            k = f"blocks.{cfg.num_layers - 1}." + k[len("final_block."):]
        out[k] = v
    return out


def _civitai_names(sd, num_layers: int):
    """The inverse of `rename_civitai_sd3` (halves of the single
    modulations swapped back, the position table flattened)."""
    leaf = {v: k for k, v in TD._CIVITAI_LEAF.items()}
    top = {v: k for k, v in TD._CIVITAI_TOP.items()}
    p = TD.CIVITAI_PREFIX
    out = {}
    for k, v in sd.items():
        if k in (f"blocks.{num_layers - 1}.norm1_b.linear.weight",
                 f"blocks.{num_layers - 1}.norm1_b.linear.bias",
                 "norm_out.linear.weight", "norm_out.linear.bias"):
            half = v.shape[0] // 2
            v = torch.cat([v[half:], v[:half]])
        if k == "pos_embedder.pos_embed":
            out[f"{p}pos_embed"] = v.reshape(1, -1, v.shape[-1])
            continue
        prefix, suffix = k.rsplit(".", 1)
        if prefix in top:
            out[f"{p}{top[prefix]}.{suffix}"] = v
        else:
            _, i, mid = prefix.split(".", 2)
            out[f"{p}joint_blocks.{i}.{leaf[mid]}.{suffix}"] = v
    return out


@pytest.mark.parametrize("case", sorted(DIT_CASES))
def test_rename_infer_convert(case):
    """One synthetic civitai file: both renames give the same tensors, both
    inferred configs the test's, and the port's converted module equals
    `from_jax_params` of the JAX conversion and the module it came from."""
    cfg, tree = _dit_tree(case)
    src = from_jax_params("sd3_dit", tree, _port(cfg), device="cpu")
    civitai = _civitai_names(_diffsynth_names(src), cfg.num_layers)
    renamed, j_renamed = TD.rename_civitai_sd3(civitai), JD.rename_civitai_sd3(civitai)
    assert sorted(renamed) == sorted(j_renamed)
    for k in renamed:
        torch.testing.assert_close(renamed[k], j_renamed[k], rtol=0, atol=0, msg=k)
    tcfg = TD.infer_sd3_config(renamed)
    # the port also reads the text and pooled widths (JAX keeps 4096 / 2048)
    assert dataclasses.replace(tcfg, context_dim=4096, pooled_dim=2048) == _port(
        JD.infer_sd3_config(renamed))
    assert tcfg == _port(cfg)
    port = TD.SD3DiT(_port(cfg))
    port.load_state_dict(TD.convert_sd3_dit(civitai, _port(cfg)), strict=True)
    want = from_jax_params("sd3_dit", _tree(JD.convert_sd3_dit(civitai, cfg, dtype=jnp.float32)),
                           _port(cfg), device="cpu").state_dict()
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(v, src.state_dict()[k], rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ prompter

@functools.lru_cache(maxsize=None)
def _towers():
    gen = torch.Generator().manual_seed(6)
    te1 = init_clip_text_(ClipTextEncoder(CLIP_L_TINY), gen).eval()
    with torch.no_grad():
        for p in te1.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    t5_tree = _tree(init_t5(jax.random.PRNGKey(7), JT5Config(**T5_4096)))
    return te1, _clip_g(), t5_tree


def _tokenizers():
    return (StubClipTokenizer(CLIP_L_TINY.vocab), StubClipTokenizer(CLIP_G_TINY.vocab),
            StubT5Tokenizer(T5_4096["vocab"]))


@pytest.fixture
def tiny_jax_towers(monkeypatch):
    """The JAX prompter's CLIP calls held to the tiny towers' depth."""
    monkeypatch.setattr(JCT, "sd3_text_encoder_1_forward", functools.partial(
        JCT.sd3_text_encoder_1_forward, num_layers=CLIP_L_TINY.num_layers,
        num_heads=CLIP_L_TINY.num_heads))
    monkeypatch.setattr(JX, "sdxl_text_encoder_2_forward", functools.partial(
        JX.sdxl_text_encoder_2_forward, num_layers=CLIP_G_TINY.num_layers))


def _prompters(with_t5: bool):
    te1, te2, t5_tree = _towers()
    tok = _tokenizers()
    from video_styler_tpu.prompters.sd3_prompter import SD3Prompter as JPrompter
    jpr = JPrompter()
    jpr.tokenizer_1, jpr.tokenizer_2, jpr.tokenizer_3 = tok
    jpr.fetch_models(_tree(JCT.convert_sd3_text_encoder_1(_reference_names(te1))),
                     _tree(JX.convert_sdxl_module(_reference_names(te2))),
                     t5_tree if with_t5 else None, JT5Config(**T5_4096))
    t5 = from_jax_params("t5", t5_tree, T5Config(**T5_4096), device="cpu") if with_t5 else None
    tpr = SD3Prompter(*tok, te1=te1, te2=te2, t5=t5)
    return jpr, tpr


@pytest.mark.parametrize("with_t5", [False, True], ids=["clip_only", "t5"])
def test_sd3_prompter(tiny_jax_towers, with_t5):
    jpr, tpr = _prompters(with_t5)
    jemb, jpool = jpr.encode_prompt("a castle on a hill", T5_LEN, dtype=jnp.float32)
    emb, pool = tpr.encode_prompt("a castle on a hill", T5_LEN, dtype=torch.float32)
    assert emb.shape == (1, 77 + T5_LEN, 4096) and pool.shape == (1, POOLED)
    assert bool((emb[:, :77, 72:] == 0).all())
    assert bool((emb[:, 77:] == 0).all()) != with_t5
    assert _rel(emb.numpy(), np.asarray(jemb)) < TOL_F32
    assert _rel(pool.numpy(), np.asarray(jpool)) < TOL_F32


@pytest.mark.parametrize("missing", ["tokenizer_1", "tokenizer_2", "te2", "tokenizer_3"])
def test_sd3_prompter_names_what_it_lacks(missing):
    _, tpr = _prompters(with_t5=True)
    setattr(tpr, missing, None)
    with pytest.raises(RuntimeError, match=f"SD3 prompter has no {missing}"):
        tpr.encode_prompt("x", T5_LEN)


# ------------------------------------------------------------ pipeline

def _image(seed, h=64, w=64):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8))


def _mask(ys, xs, size=64):
    arr = np.zeros((size, size, 3), np.uint8)
    arr[ys, xs] = 255
    return Image.fromarray(arr)


@functools.lru_cache(maxsize=None)
def _pipelines(with_t5: bool):
    """The JAX and port SD3 pipelines on the same tiny weights, fp32."""
    cfg, tree = _dit_tree("sd35", context_dim=4096, pooled_dim=POOLED)
    gen = torch.Generator().manual_seed(8)
    enc = TV.init_sd3_vae_(TV.SD3VAEEncoder(TV.SD3_VAE), gen).eval()
    dec = TV.init_sd3_vae_(TV.SD3VAEDecoder(TV.SD3_VAE), gen).eval()
    jpr, tpr = _prompters(with_t5)
    jp = JPipe(dtype=jnp.float32)
    jp.dit_cfg, jp.dit_params = cfg, jax.tree_util.tree_map(jnp.asarray, tree)
    jp.vae_encoder_params = _tree(convert_sd3_vae(_reference_names(enc)))
    jp.vae_decoder_params = _tree(convert_sd3_vae(_reference_names(dec)))
    jp.prompter = jpr
    tp = TPipe(device="cpu", dtype=torch.float32)
    tp.dit_cfg = _port(cfg)
    tp.dit = from_jax_params("sd3_dit", tree, tp.dit_cfg, device="cpu")
    for p in tp.dit.parameters():
        p.data = p.data.contiguous()
    tp.vae_encoder, tp.vae_decoder, tp.prompter = enc, dec, tpr
    return jp, tp


BASE = dict(prompt="a red fox in the snow", negative_prompt="blurry", height=64, width=64,
            seed=7, num_inference_steps=3, cfg_scale=4.0, t5_sequence_length=T5_LEN)
REQUESTS = {
    "t2i": (False, {}),
    "img2img": (False, dict(input_image=_image(0), denoising_strength=0.6)),
    "local_prompts": (False, dict(local_prompts=["a hat", "a tree"],
                                  masks=[_mask(slice(0, 32), slice(0, 64)),
                                         _mask(slice(16, 64), slice(32, 64))],
                                  mask_scales=[0.8, 1.5])),
    "t5": (True, {}),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_sd3_pipeline_matches_jax(tiny_jax_towers, name):
    with_t5, request = REQUESTS[name]
    jp, tp = _pipelines(with_t5)
    kw = {**BASE, **request}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert got.shape == (1, 16, 8, 8)
    assert _rel(got, want) < TOL_F32, _rel(got, want)
    if name == "t2i":
        assert [s for s, _ in tp.stage_times][:2] == ["text_encode", "text_encode"]
        img_j = np.asarray(jp(**kw), np.int16)
        img_t = np.asarray(tp(**kw), np.int16)
        assert img_t.shape == (64, 64, 3)
        assert np.abs(img_t - img_j).max() <= 1
    else:
        base = _pipelines(False)[1](return_latents=True, **BASE).numpy()
        assert _rel(got, base) > 1e-4, "no effect"


def test_from_pretrained_files_and_no_text_encoder(tiny_jax_towers, tmp_path):
    """The DiT written in the civitai layout and the VAE under `encoder.` /
    `decoder.` come back bit for bit; like the JAX pipeline's,
    `from_pretrained` loads no text encoder, so a request raises until the
    caller sets the prompter's towers. (The JAX `from_pretrained` reads a
    civitai file into numpy, which its rename's `torch.concat` refuses: it
    is given the DiffSynth layout; ROADMAP Queue 3.)"""
    _, tp = _pipelines(False)
    files = {n: str(tmp_path / f"{n}.safetensors") for n in ("dit", "diffsynth", "vae")}
    diffsynth = _diffsynth_names(tp.dit)
    save_file(_civitai_names(diffsynth, tp.dit_cfg.num_layers), files["dit"])
    save_file(diffsynth, files["diffsynth"])
    save_file({f"{side}.{k}": torch.from_numpy(v)
               for side, m in (("encoder", tp.vae_encoder), ("decoder", tp.vae_decoder))
               for k, v in _reference_names(m).items()}, files["vae"])
    pipe = TPipe.from_pretrained(dit_path=files["dit"], vae_path=files["vae"], device="cpu",
                                 dtype=torch.float32)
    assert pipe.dit_cfg == tp.dit_cfg
    with pytest.raises(TypeError):
        JPipe.from_pretrained(dit_path=files["dit"], dtype=jnp.float32)
    jp = JPipe.from_pretrained(dit_path=files["diffsynth"], dtype=jnp.float32)
    assert (jp.prompter.te1_params, jp.prompter.te2_params, jp.prompter.t5_params) == (
        None, None, None)
    assert (pipe.prompter.te1, pipe.prompter.te2, pipe.prompter.t5) == (None, None, None)
    with pytest.raises(RuntimeError, match="SD3 prompter has no"):
        pipe(return_latents=True, **BASE)
    with pytest.raises(TypeError):
        jp(return_latents=True, **BASE)
    pipe.prompter = tp.prompter
    kw = {**BASE, **REQUESTS["img2img"][1]}
    torch.testing.assert_close(pipe(return_latents=True, **kw), tp(return_latents=True, **kw),
                               rtol=0, atol=0)


def test_load_model_sd3_dit(tmp_path):
    """`load_model` on a file of the detector's bare mmdit names: the port
    builds it (prefixing the names), the JAX converter, which reads only the
    prefixed ones, fails (a fault recorded in ROADMAP Queue 3)."""
    cfg, tree = _dit_tree("sd35")
    src = from_jax_params("sd3_dit", tree, _port(cfg), device="cpu")
    civitai = _civitai_names(_diffsynth_names(src), cfg.num_layers)
    path = str(tmp_path / "sd3.safetensors")
    save_file({k[len(TD.CIVITAI_PREFIX):]: v.contiguous() for k, v in civitai.items()}, path)
    kind, model = TCK.load_model(path, device="cpu", dtype=torch.float32)
    assert kind == JCK.detect_model_kind(TCK.load_state_dict(path, lazy=True)) == "sd3_dit"
    assert model.cfg == _port(cfg)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, src.state_dict()[k], rtol=0, atol=0, msg=k)
    with pytest.raises(KeyError):
        JCK.load_model(path, dtype=jnp.float32)


def test_image_gen_sd3_smoke_cli(tmp_path, capsys):
    out = tmp_path / "sd3.png"
    assert image_gen.main(["--family", "sd3", "--smoke", "--device", "cpu",
                           "--output", str(out)]) == 0
    assert Image.open(out).size == (image_gen.SMOKE_SIZE, image_gen.SMOKE_SIZE)
    assert f"saved {out}" in capsys.readouterr().out
