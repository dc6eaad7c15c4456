"""The FLUX text-to-image path against the JAX package: the RoPE tables and
image ids (bit-equal), `flux_dit_forward` (fp32 and bf16, dev and schnell,
with and without Kontext tokens; one head-dim-128 case with the JAX
attention through its Pallas kernel in interpret mode), `convert_flux_dit`
and `rename_civitai_flux` from one synthetic BFL / civitai / DiffSynth
state dict, `convert_flux_lora` and the merge in the four layouts of the
JAX package's own LoRA tests, `FluxImagePipeline` (t2i, img2img, two-pass
CFG, embedded guidance, Kontext, TeaCache) on the same weights, the
adapters that still raise (Nexus-Gen, Step1x; the others are held in
`test_torch_flux_adapters.py`), the prompter without a T5 tokenizer, and
the `image_gen` CLI.

Weights: the DiT from the JAX init (`init_flux_dit`) with its biases and
norm weights perturbed from a numpy seed; the pipeline's CLIP-L and VAE
drawn by the port and handed to both converters under the reference's
names, T5 v1.1 from the JAX init. Widths: `FLUX_DIT_TINY` (96 wide, 4
heads of 24, 2 + 2 blocks), CLIP-L and T5 v1.1 at tiny widths (the JAX
prompter's CLIP call is held to the tiny tower's 3 layers and 2 heads), the
FLUX VAE at its release widths. Requests of 64x64 (16 image tokens), 16 T5 tokens.
On the CPU the port's attention is K1's plain version (the capped softmax)
and the JAX DiT takes the exact `sdpa`: fp32 within 2e-5 relative L2; bf16
within the bounds stated at each test.
"""
import copy
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.flux_dit as JF
import video_styler_tpu.models.sd3_text_encoder as JCT
import video_styler_tpu.ops.flash_attention as jfa
from video_styler_tpu.flux_lora import convert_flux_lora as j_convert_lora
from video_styler_tpu.lora import merge_lora as j_merge_lora
from video_styler_tpu.models.sd3_text_encoder import convert_sd3_text_encoder_1
from video_styler_tpu.models.sd3_vae import convert_sd3_vae
from video_styler_tpu.models.t5 import T5_V11_TINY as J_T5_V11_TINY, init_t5
from video_styler_tpu.pipelines.flux_image import FluxImagePipeline as JPipe
from video_styler_tpu.pipelines.flux_image import FluxTeaCache as JTea

import video_styler_tpu_torch.models.flux_dit as TF
from video_styler_tpu_torch import image_gen
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.flux_lora import convert_flux_lora as t_convert_lora
from video_styler_tpu_torch.lora import merge_lora as t_merge_lora
from video_styler_tpu_torch.models import sd3_vae as TV
from video_styler_tpu_torch.models.sd3_text_encoder import (CLIP_L_TINY, ClipTextEncoder,
                                                            init_clip_text_)
from video_styler_tpu_torch.models.t5 import T5_V11_TINY
from video_styler_tpu_torch.pipelines.flux_image import FluxImagePipeline as TPipe
from video_styler_tpu_torch.pipelines.flux_image import FluxTeaCache as TTea
from video_styler_tpu_torch.prompters.flux_prompter import (FluxPrompter, StubClipTokenizer,
                                                            StubT5Tokenizer)

from test_torch_fun import _rel
from test_torch_pipeline import _tree, cpu_share  # noqa: F401

TOL_F32 = 2e-5
T5_LEN = 16


def _port_cfg(jcfg) -> TF.FluxDiTConfig:
    return TF.FluxDiTConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(TF.FluxDiTConfig)})


@functools.lru_cache(maxsize=None)
def _dit_tree(guidance: bool = True, dim: int = 96, heads: int = 4, axes=(4, 10, 10)):
    """JAX-initialised DiT, biases and norm weights perturbed (numpy seed)."""
    cfg = dataclasses.replace(JF.FLUX_DIT_TINY, guidance_embed=guidance, dim=dim,
                              num_heads=heads, axes_dim=axes)
    tree = _tree(JF.init_flux_dit(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)

    def perturb(path, a):
        leaf = jax.tree_util.keystr(path)
        if leaf.endswith("['b']") or leaf.endswith("['weight']"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return cfg, jax.tree_util.tree_map_with_path(perturb, tree)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, dtype)), tree)


def _dit_inputs(cfg, kontext: bool, seed: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, cfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32)
    kl = rng.standard_normal((1, 16, 64)).astype(np.float32) if kontext else None
    ki = JF.prepare_image_ids(1, 4, 4) if kontext else None
    return x, np.array([500.0], np.float32), ctx, pooled, np.array([3.5], np.float32), kl, ki


def _run_both(jcfg, tree, inputs, jdtype, tdtype):
    x, t, ctx, pooled, g, kl, ki = inputs
    jt = _cast(tree, jdtype)
    fwd = jax.jit(lambda p, *a: JF.flux_dit_forward(
        p, jcfg, *a[:5], kontext_latents=a[5], kontext_ids=ki))
    cast = lambda a: None if a is None else jnp.asarray(a, jdtype)  # noqa: E731
    want = np.asarray(fwd(jt, cast(x), t, cast(ctx), cast(pooled), g, cast(kl)), np.float32)
    model = from_jax_params("flux_dit", jt, _port_cfg(jcfg), device="cpu")
    tt = lambda a: None if a is None else torch.from_numpy(a).to(tdtype)  # noqa: E731
    with torch.no_grad():
        got = TF.flux_dit_forward(model, tt(x), torch.from_numpy(t), tt(ctx), tt(pooled),
                                  torch.from_numpy(g), kontext_latents=tt(kl),
                                  kontext_ids=ki).float().numpy()
    return got, want


# ------------------------------------------------------------ RoPE, ids

@pytest.mark.parametrize("f_id,h,w", [(0, 4, 4), (1, 3, 5), (0, 64, 64)])
def test_image_ids_and_rope_tables_bit_equal(f_id, h, w):
    ids = TF.prepare_image_ids(f_id, h, w)
    np.testing.assert_array_equal(ids, JF.prepare_image_ids(f_id, h, w))
    full = np.concatenate([np.zeros((7, 3)), ids, JF.prepare_image_ids(1, 2, 3)])
    for axes in ((16, 56, 56), (4, 10, 10)):
        for a, b in zip(TF.flux_rope_cos_sin(full, axes, 10000),
                        JF.flux_rope_cos_sin(full, axes, 10000)):
            np.testing.assert_array_equal(a, b)


def test_rope_rotation_and_patchify():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 6, 2, 24)).astype(np.float32)
    cos, sin = JF.flux_rope_cos_sin(JF.prepare_image_ids(0, 2, 3), (4, 10, 10), 10000)
    want = np.asarray(JF.rope_apply_interleaved(jnp.asarray(x), cos, sin))
    got = TF.rope_apply_interleaved(torch.from_numpy(x), torch.from_numpy(cos),
                                    torch.from_numpy(sin)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    lat = rng.standard_normal((1, 16, 6, 8)).astype(np.float32)
    tok = TF.patchify(torch.from_numpy(lat))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(JF.patchify(jnp.asarray(lat))))
    np.testing.assert_array_equal(TF.unpatchify(tok, 6, 8).numpy(), lat)


# ------------------------------------------------------------ the DiT

@pytest.mark.parametrize("guidance", [True, False], ids=["dev", "schnell"])
@pytest.mark.parametrize("kontext", [False, True], ids=["t2i", "kontext"])
def test_flux_dit_forward_fp32(guidance, kontext):
    cfg, tree = _dit_tree(guidance)
    assert ("guidance_embedder" in tree) == guidance
    got, want = _run_both(cfg, tree, _dit_inputs(cfg, kontext), jnp.float32, torch.float32)
    assert got.shape == (1, 16, 8, 8)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


@pytest.mark.parametrize("guidance", [True, False], ids=["dev", "schnell"])
@pytest.mark.parametrize("kontext", [False, True], ids=["t2i", "kontext"])
def test_flux_dit_forward_bf16(guidance, kontext):
    cfg, tree = _dit_tree(guidance)
    got, want = _run_both(cfg, tree, _dit_inputs(cfg, kontext), jnp.bfloat16, torch.bfloat16)
    # bf16 activations: the capped softmax (p rounded to bf16 before PV)
    # against the exact softmax, CPU GEMM and elementwise roundings that
    # differ by an ULP, through 4 blocks. Measured 1.10-1.16%
    assert _rel(got, want) < 3e-2, _rel(got, want)


def _use_flash_on_cpu(monkeypatch):
    """The JAX DiT's attention through its Pallas flash kernel (interpret
    mode), as on a TPU."""
    orig = jfa.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", interp_call)
    attention = JF.attention
    monkeypatch.setattr(JF, "attention",
                        lambda q, k, v, **kw: attention(q, k, v, use_flash=True, **kw))


def test_flux_dit_head_dim_128_against_pallas(monkeypatch):
    """Head dim 128 (dim 256, 2 heads, FLUX's axes 16/56/56): the port's K1
    plain version against the JAX Pallas capped kernel in interpret mode,
    bf16, the same capped softmax on both sides."""
    _use_flash_on_cpu(monkeypatch)
    cfg, tree = _dit_tree(True, dim=256, heads=2, axes=(16, 56, 56))
    got, want = _run_both(cfg, tree, _dit_inputs(cfg, True), jnp.bfloat16, torch.bfloat16)
    # both sides round p to bf16 at the same point; the rest as the bf16
    # test above. Measured 1.0%
    assert _rel(got, want) < 3e-2, _rel(got, want)


# ------------------------------------------------------------ conversion

def _bfl_state_dict(model: TF.FluxDiT, prefix: str = ""):
    """The port's DiT under the BFL release's names (the inverse of
    `rename_civitai_flux`; the final adaLN's halves swapped back)."""
    top = {"time_embedder": "time_in", "pooled_text_embedder": "vector_in",
           "guidance_embedder": "guidance_in"}
    joint = {"attn.a_to_qkv": "img_attn.qkv", "attn.b_to_qkv": "txt_attn.qkv",
             "attn.a_to_out": "img_attn.proj", "attn.b_to_out": "txt_attn.proj",
             "attn.norm_q_a": "img_attn.norm.query_norm", "attn.norm_k_a":
             "img_attn.norm.key_norm", "attn.norm_q_b": "txt_attn.norm.query_norm",
             "attn.norm_k_b": "txt_attn.norm.key_norm", "ff_a.0": "img_mlp.0",
             "ff_a.2": "img_mlp.2", "ff_b.0": "txt_mlp.0", "ff_b.2": "txt_mlp.2",
             "norm1_a.linear": "img_mod.lin", "norm1_b.linear": "txt_mod.lin"}
    single = {"to_qkv_mlp": "linear1", "proj_out": "linear2", "norm.linear": "modulation.lin",
              "norm_q_a": "norm.query_norm", "norm_k_a": "norm.key_norm"}
    out = {}
    for name, v in model.state_dict().items():
        parts = name.split(".")
        path, leaf = ".".join(parts[:-1]), parts[-1]
        if parts[0] in top:
            new = f"{top[parts[0]]}.{'in_layer' if parts[1] == 'fc1' else 'out_layer'}.{leaf}"
        elif parts[0] in ("context_embedder", "x_embedder"):
            new = {"context_embedder": "txt_in", "x_embedder": "img_in"}[parts[0]] + f".{leaf}"
        elif parts[0] == "final_proj_out":
            new = f"final_layer.linear.{leaf}"
        elif parts[0] == "final_norm_out":
            half = v.shape[0] // 2
            v = torch.cat([v[half:], v[:half]])
            new = f"final_layer.adaLN_modulation.1.{leaf}"
        else:
            table = joint if parts[0] == "blocks" else single
            block = "double_blocks" if parts[0] == "blocks" else "single_blocks"
            rest = ".".join(parts[2:-1])
            leaf = "scale" if "norm_" in rest and "linear" not in rest else leaf
            new = f"{block}.{parts[1]}.{table[rest]}.{leaf}"
        out[prefix + new] = v.clone()
    return out


def _diffsynth_state_dict(model: TF.FluxDiT):
    out = {}
    for name, v in model.state_dict().items():
        for dst, src in (("time_embedder.", "time_embedder.timestep_embedder."),
                         ("guidance_embedder.", "guidance_embedder.timestep_embedder."),
                         ("pooled_text_embedder.", "pooled_text_embedder.")):
            if name.startswith(dst):
                name = src + name[len(dst):].replace("fc1", "0").replace("fc2", "2")
        out[name] = v.clone()
    return out


@pytest.mark.parametrize("layout", ["bfl", "civitai", "diffsynth"])
def test_convert_flux_dit_layouts(layout):
    """One synthetic file layout through both converters: the port's module
    from its `convert_flux_dit` equals `from_jax_params` of the JAX one."""
    cfg, tree = _dit_tree(True)
    src = from_jax_params("flux_dit", tree, _port_cfg(cfg), device="cpu")
    sd = {"bfl": lambda: _bfl_state_dict(src),
          "civitai": lambda: _bfl_state_dict(src, "model.diffusion_model."),
          "diffsynth": lambda: _diffsynth_state_dict(src)}[layout]()
    if layout == "civitai":
        # the prefixed layout goes through `rename_civitai_flux` by hand on
        # both sides (neither `convert_flux_dit` detects the prefix)
        renamed, j_renamed = TF.rename_civitai_flux(sd), JF.rename_civitai_flux(sd)
        assert sorted(renamed) == sorted(j_renamed)
        for k in renamed:
            torch.testing.assert_close(renamed[k], j_renamed[k], rtol=0, atol=0, msg=k)
        sd = renamed
    if layout != "diffsynth":
        assert TF.flux_config_for(sd).guidance_embed
        assert not TF.flux_config_for({k: v for k, v in sd.items() if "guidance" not in k}
                                      ).guidance_embed
    port = TF.FluxDiT(_port_cfg(cfg))
    port.load_state_dict(TF.convert_flux_dit(sd, _port_cfg(cfg)), strict=True)
    want = from_jax_params("flux_dit", _tree(JF.convert_flux_dit(sd, cfg, dtype=jnp.float32)),
                           _port_cfg(cfg), device="cpu").state_dict()
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ LoRA

def _rand_lora(rng, d_out, d_in, r=2):
    return (rng.standard_normal((r, d_in)).astype(np.float32),
            rng.standard_normal((d_out, r)).astype(np.float32))


def _lora_case(case: str):
    """The four layouts of tests/test_flux_pipeline.py's LoRA tests."""
    d = JF.FLUX_DIT_TINY.dim
    if case == "civitai":
        A, B = _rand_lora(np.random.default_rng(0), 3 * d, d)
        return {"lora_unet_double_blocks_1_img_attn_qkv.lora_down.weight": A,
                "lora_unet_double_blocks_1_img_attn_qkv.lora_up.weight": B}
    if case == "diffusers_qkv":
        rng, sd = np.random.default_rng(1), {}
        for proj in ("to_q", "to_k", "to_v"):
            A, B = _rand_lora(rng, d, d)
            sd[f"transformer.transformer_blocks.0.attn.{proj}.lora_A.weight"] = A
            sd[f"transformer.transformer_blocks.0.attn.{proj}.lora_B.weight"] = B
        return sd
    if case == "single_qkv_mlp":
        rng, sd = np.random.default_rng(2), {}
        for proj in ("to_q", "to_k", "to_v"):
            A, B = _rand_lora(rng, d, d)
            sd[f"transformer.single_transformer_blocks.1.attn.{proj}.lora_A.weight"] = A
            sd[f"transformer.single_transformer_blocks.1.attn.{proj}.lora_B.weight"] = B
        A, B = _rand_lora(rng, 4 * d, d)
        sd["transformer.single_transformer_blocks.1.proj_mlp.lora_A.weight"] = A
        sd["transformer.single_transformer_blocks.1.proj_mlp.lora_B.weight"] = B
        return sd
    A, B = _rand_lora(np.random.default_rng(3), 3 * d, d, r=4)
    return {"lora_unet_double_blocks_0_img_attn_qkv.lora_down.weight": A,
            "lora_unet_double_blocks_0_img_attn_qkv.lora_up.weight": B,
            "lora_unet_double_blocks_0_img_attn_qkv.alpha": np.asarray(2.0)}


@pytest.mark.parametrize("case", ["civitai", "diffusers_qkv", "single_qkv_mlp",
                                  "alpha_rescale"])
def test_flux_lora_convert_and_merge(case):
    sd = _lora_case(case)
    want = j_convert_lora(sd)
    got = t_convert_lora({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    cfg, tree = _dit_tree(True)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    merged = from_jax_params("flux_dit", _tree(j_merge_lora(jtree, want, alpha=0.7)),
                             _port_cfg(cfg), device="cpu").state_dict()
    model = from_jax_params("flux_dit", tree, _port_cfg(cfg), device="cpu")
    t_merge_lora(model, got, alpha=0.7)
    base = from_jax_params("flux_dit", tree, _port_cfg(cfg), device="cpu").state_dict()
    changed = [k for k, v in model.state_dict().items() if not torch.equal(v, base[k])]
    assert changed, "the LoRA changed nothing"
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, merged[k], rtol=1e-6, atol=1e-6, msg=k)


# ------------------------------------------------------------ pipeline

def _reference_names(module):
    """A port module's state dict under the reference's names (norm
    `scale` -> `weight`), as numpy."""
    return {k[:-len("scale")] + "weight" if k.endswith(".scale") else k: v.numpy()
            for k, v in module.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _pipelines():
    """The JAX and port pipelines on the same tiny weights, fp32."""
    cfg, tree = _dit_tree(True)
    gen = torch.Generator().manual_seed(5)
    clip = init_clip_text_(ClipTextEncoder(CLIP_L_TINY), gen).eval()
    with torch.no_grad():
        for p in clip.parameters():     # non-zero biases, norms off 1
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    enc = TV.init_sd3_vae_(TV.SD3VAEEncoder(TV.FLUX_VAE), gen).eval()
    dec = TV.init_sd3_vae_(TV.SD3VAEDecoder(TV.FLUX_VAE), gen).eval()
    t5_tree = _tree(init_t5(jax.random.PRNGKey(4), J_T5_V11_TINY))
    tok1, tok2 = StubClipTokenizer(CLIP_L_TINY.vocab), StubT5Tokenizer(T5_V11_TINY.vocab)

    jp = JPipe(dtype=jnp.float32)
    jp.dit_cfg, jp.dit_params = cfg, jax.tree_util.tree_map(jnp.asarray, tree)
    jp.vae_encoder_params = _tree(convert_sd3_vae(_reference_names(enc)))
    jp.vae_decoder_params = _tree(convert_sd3_vae(_reference_names(dec)))
    jp.prompter.tokenizer_1, jp.prompter.tokenizer_2 = tok1, tok2
    jp.prompter.fetch_models(_tree(convert_sd3_text_encoder_1(_reference_names(clip))),
                             t5_tree, J_T5_V11_TINY)

    tp = TPipe(device="cpu", dtype=torch.float32)
    tp.dit_cfg = _port_cfg(cfg)
    tp.dit = from_jax_params("flux_dit", tree, tp.dit_cfg, device="cpu")
    for p in tp.dit.parameters():
        # row-major, as a file gives them: the transposed JAX weights arrive
        # column-major, and the CPU GEMM then sums in another order
        p.data = p.data.contiguous()
    tp.vae_cfg, tp.vae_encoder, tp.vae_decoder = TV.FLUX_VAE, enc, dec
    tp.prompter = FluxPrompter(tok1, tok2, clip,
                               from_jax_params("t5", t5_tree, T5_V11_TINY, device="cpu"))
    return jp, tp


@pytest.fixture
def pipes(monkeypatch):
    # the JAX prompter calls CLIP with CLIP-L's 12 layers and heads
    monkeypatch.setattr(JCT, "sd3_text_encoder_1_forward", functools.partial(
        JCT.sd3_text_encoder_1_forward, num_layers=CLIP_L_TINY.num_layers,
        num_heads=CLIP_L_TINY.num_heads))
    return _pipelines()


def _image(seed, h=64, w=64):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8))


BASE = dict(prompt="a red fox in the snow", height=64, width=64, seed=7,
            num_inference_steps=3, t5_sequence_length=T5_LEN)
REQUESTS = {
    "t2i": {},
    "img2img": dict(input_image=_image(0), denoising_strength=0.6),
    "cfg_two_pass": dict(cfg_scale=2.5, negative_prompt="blurry, dark"),
    "guidance_7": dict(embedded_guidance=7.0),
    "kontext": dict(kontext_images=[_image(1, 48, 64)]),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_pipeline_matches_jax(pipes, name):
    jp, tp = pipes
    kw = {**BASE, **REQUESTS[name]}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert got.shape == (1, 16, 8, 8)
    assert _rel(got, want) < TOL_F32, _rel(got, want)
    if name == "t2i":
        assert [s for s, _ in tp.stage_times] == [
            "clip_encode", "t5_encode", "denoise_step_0", "denoise_step_1", "denoise_step_2"]
        # the whole path: the decode of each side's latents to 8-bit pixels
        img_j = np.asarray(jp(**kw), np.int16)
        img_t = np.asarray(tp(**kw), np.int16)
        assert img_t.shape == (64, 64, 3)
        assert np.abs(img_t - img_j).max() <= 1


def test_pipeline_options_change_the_output(pipes):
    _, tp = pipes
    base = tp(return_latents=True, **BASE)
    for name in ("img2img", "cfg_two_pass", "guidance_7", "kontext"):
        other = tp(return_latents=True, **BASE, **REQUESTS[name])
        assert (other - base).abs().mean() > 1e-4, name


def _recorded(monkeypatch, cls, log):
    check = cls.check

    def wrapped(self, modulated):
        skip = check(self, modulated)
        log.append(skip)
        return skip
    monkeypatch.setattr(cls, "check", wrapped)


@pytest.mark.parametrize("thresh", [1.0, 1e9])
def test_teacache_matches_jax(pipes, monkeypatch, thresh):
    jp, tp = pipes
    j_log, t_log = [], []
    _recorded(monkeypatch, JTea, j_log)
    _recorded(monkeypatch, TTea, t_log)
    kw = {**BASE, "num_inference_steps": 6, "tea_cache_l1_thresh": thresh}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert t_log == j_log
    assert any(t_log) and not all(t_log)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


ADAPTER_ARGS = ["nexus_gen_reference_image", "step1x_reference_image"]


@pytest.mark.parametrize("arg", ADAPTER_ARGS)
def test_adapter_arguments_raise(pipes, arg):
    """Nexus-Gen's and Step1x's reference image raised until item 11e ported
    them; now each runs, with its embedder and adapters attached (the JAX
    tests' stand-ins), and gives the JAX pipeline's latents
    (`test_torch_step1x_nexus.py` holds the rest of both paths). Without
    them attached the argument is ignored, as in JAX."""
    from test_torch_step1x_nexus import _image, with_step1x_and_nexus
    jp, tp = with_step1x_and_nexus(*pipes, nexus=arg.startswith("nexus"))
    kw = {**BASE, arg: _image(3)}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)
    torch.testing.assert_close(pipes[1](return_latents=True, **kw),
                               pipes[1](return_latents=True, **BASE), rtol=0, atol=0)


def test_adapter_settings_at_jax_defaults(pipes):
    """A call that passes the adapters' scalar settings at the JAX
    signature's defaults runs, and gives the latents of one that does not."""
    import inspect
    from video_styler_tpu_torch.pipelines.flux_image import ADAPTER_SETTINGS
    jax_defaults = {k: p.default for k, p in inspect.signature(JPipe.__call__).parameters.items()
                    if k in ADAPTER_SETTINGS}
    assert jax_defaults == ADAPTER_SETTINGS
    _, tp = pipes
    torch.testing.assert_close(tp(return_latents=True, **BASE, **jax_defaults),
                               tp(return_latents=True, **BASE), rtol=0, atol=0)


@pytest.mark.parametrize("loader", ["fetch_qwenvl"])
def test_adapter_loaders_raise(loader, tmp_path):
    """`fetch_qwenvl` builds Step1x's Qwen2.5-VL embedder (the JAX
    pipeline's `fetch_qwenvl`) from a checkpoint and a tokenizer; a missing
    file raises."""
    from test_torch_qwen_vl import stub_tokenizer, torch_sd, vl_state_dict
    from video_styler_tpu_torch import safetensors_io
    from video_styler_tpu_torch.models.qwen_vl_embedder import QwenVLStep1xEmbedder
    pipe = TPipe(device="cpu", dtype=torch.float32)
    with pytest.raises(FileNotFoundError):
        getattr(pipe, loader)(str(tmp_path / "missing.safetensors"), stub_tokenizer())
    path = str(tmp_path / "qwen_vl.safetensors")
    safetensors_io.save_file(torch_sd(vl_state_dict()), path)
    getattr(pipe, loader)(path, stub_tokenizer())
    assert isinstance(pipe.qwenvl, QwenVLStep1xEmbedder)
    assert pipe.qwenvl.vl.vision is not None and pipe.qwenvl.vl.text_cfg.hidden == 256


def test_pipeline_load_lora_matches_jax(pipes):
    """`load_lora` on a civitai-layout LoRA changes the latents as the JAX
    pipeline's merge does (each side on a fresh copy of its weights)."""
    jp, tp = pipes
    import copy
    j2, t2 = copy.copy(jp), copy.copy(tp)
    j2._jit_cache = {}
    t2.dit = copy.deepcopy(tp.dit)
    sd = _lora_case("civitai")
    j2.load_lora(state_dict=sd, alpha=0.5)
    t2.load_lora(state_dict={k: torch.from_numpy(v) for k, v in sd.items()}, alpha=0.5)
    want = np.asarray(j2(return_latents=True, **BASE), np.float32)
    got = t2(return_latents=True, **BASE).numpy()
    assert _rel(got, want) < TOL_F32
    assert _rel(got, tp(return_latents=True, **BASE).numpy()) > 1e-3


def _hf_t5_names(model):
    """A port T5Encoder under the HF `T5EncoderModel` names."""
    out = {"shared.weight": model.token_embedding,
           "encoder.final_layer_norm.weight": model.norm.scale}
    for i, b in enumerate(model.blocks):
        pre = f"encoder.block.{i}.layer"
        out.update({f"{pre}.0.SelfAttention.{n}.weight": getattr(b.attn, n).weight
                    for n in "qkvo"})
        out[f"{pre}.0.layer_norm.weight"] = b.norm1.scale
        out[f"{pre}.1.layer_norm.weight"] = b.norm2.scale
        for n, hf in (("gate", "wi_0"), ("fc1", "wi_1"), ("fc2", "wo")):
            out[f"{pre}.1.DenseReluDense.{hf}.weight"] = getattr(b.ffn, n).weight
        if hasattr(b, "pos_emb"):
            out[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = b.pos_emb
    return {k: v.detach().clone() for k, v in out.items()}


def test_from_pretrained_files(pipes, tmp_path, monkeypatch):
    """The pipeline's models written as files (the DiT in the BFL layout,
    the VAE under `encoder.` / `decoder.`, CLIP-L under the reference's
    names, T5 in two HF shards) and built again by `from_pretrained`: the
    same latents, bit for bit, as the pipeline they came from."""
    import video_styler_tpu_torch.pipelines.flux_image as FI
    from video_styler_tpu_torch.safetensors_io import save_file
    _, tp = pipes
    monkeypatch.setattr(TF, "FLUX_DEV", tp.dit_cfg)
    monkeypatch.setattr(FI, "CLIP_L", CLIP_L_TINY)
    monkeypatch.setattr(FI, "T5_V11_XXL", T5_V11_TINY)
    files = {name: str(tmp_path / f"{name}.safetensors")
             for name in ("dit", "vae", "clip", "t5a", "t5b")}
    save_file(_bfl_state_dict(tp.dit), files["dit"])
    save_file({f"{side}.{k}": v for side, m in (("encoder", tp.vae_encoder),
                                               ("decoder", tp.vae_decoder))
               for k, v in _reference_names(m).items()}, files["vae"])
    save_file(_reference_names(tp.prompter.clip), files["clip"])
    t5 = sorted(_hf_t5_names(tp.prompter.t5).items())
    save_file(dict(t5[:len(t5) // 2]), files["t5a"])
    save_file(dict(t5[len(t5) // 2:]), files["t5b"])
    pipe = TPipe.from_pretrained(dit_path=files["dit"], vae_path=files["vae"],
                                 clip_path=files["clip"], t5_paths=[files["t5a"], files["t5b"]],
                                 device="cpu", dtype=torch.float32)
    pipe.prompter.tokenizer_1 = tp.prompter.tokenizer_1
    pipe.prompter.tokenizer_2 = tp.prompter.tokenizer_2
    assert pipe.dit_cfg.guidance_embed
    kw = {**BASE, **REQUESTS["img2img"]}
    torch.testing.assert_close(pipe(return_latents=True, **kw), tp(return_latents=True, **kw),
                               rtol=0, atol=0)


# ------------------------------------------------------------ CLI

def test_image_gen_smoke_cli(tmp_path, capsys):
    out = tmp_path / "flux.png"
    assert image_gen.main(["--family", "flux", "--smoke", "--device", "cpu",
                           "--output", str(out)]) == 0
    img = Image.open(out)
    assert img.size == (image_gen.SMOKE_SIZE, image_gen.SMOKE_SIZE)
    assert f"saved {out}" in capsys.readouterr().out


def test_image_gen_cli_refuses(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image_gen.main(["--family", "flux", "--smoke", "--output", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image_gen.main(["--family", "hunyuan_image", "--smoke", "--output",
                        str(tmp_path / "h.png")])


def test_prompter_without_t5_tokenizer_raises(pipes):
    """The JAX runner passes no T5 tokenizer (`examples/image_gen.py:50-60`),
    so its prompter calls None; the port's names what it lacks
    (ROADMAP: where the port departs from JAX on purpose)."""
    _, tp = pipes
    prompter = copy.copy(tp.prompter)
    prompter.tokenizer_2 = None
    with pytest.raises(RuntimeError, match="the FLUX prompter has no tokenizer_2"):
        prompter.encode_prompt("a fox", T5_LEN)


def test_image_gen_passes_tokenizer_2_path(monkeypatch, tmp_path):
    """`--tokenizer_2_path` reaches `from_pretrained` as the T5 tokenizer's
    path (the JAX runner has no such option)."""
    seen = {}

    def from_pretrained(**kw):
        seen.update(kw)
        raise StopIteration
    monkeypatch.setattr(TPipe, "from_pretrained", staticmethod(from_pretrained))
    with pytest.raises(StopIteration):
        image_gen.main(["--family", "flux", "--dit_path", "a.safetensors|b.safetensors",
                        "--tokenizer_path", "clip_tok", "--tokenizer_2_path", "t5_tok",
                        "--device", "cpu", "--output", str(tmp_path / "x.png")])
    assert seen["tokenizer_1_path"] == "clip_tok"
    assert seen["tokenizer_2_path"] == "t5_tok"
    assert seen["dit_path"] == ["a.safetensors", "b.safetensors"]
