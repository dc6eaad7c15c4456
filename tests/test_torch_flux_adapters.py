"""FLUX's adapters against the JAX package: the ControlNet (plain, union
with a `processor_id`, inpainting `additional_input_dim`; fp32 and bf16),
`align_res_stack`, the IP-Adapter's keys and values (both file layouts) and
their injection in the joint and single blocks, the EliGen attention bias
(bit-equal) and the DiT under it, the ControlNet residuals in the DiT
(with Kontext padding), the InfiniteYou projector, the single and multi
value encoders, the LoRA encoder, each adapter through `FluxImagePipeline`
(the ControlNet also under two-pass CFG, InfiniteYou on the ControlNet's
branch, Flex on a DiT with a wider `x_embedder`), and `load_model` on the
five FLUX adapter kinds.

Weights: the JAX inits (ControlNet, IP-Adapter, InfiniteYou, value
encoder) with biases and norm weights perturbed from a numpy seed; the
LoRA encoder, which JAX cannot init, drawn by the port and read by both
converters under the reference's names. Widths: `FLUX_DIT_TINY` (96 wide,
4 heads of 24), the ControlNet at 2 + 2 blocks, the IP-Adapter at 8
tokens a picture from a 48-wide embedding, InfiniteYou 64 wide (its 20
heads of 64, 64 out), the LoRA encoder 64 wide over the full FLUX.1-dev probe
inventory. Requests of 64x64 (16 image tokens), 16 T5 tokens, 3 steps.
Tolerances: fp32 within 2e-5 relative L2 (K1's plain version against the
JAX exact `sdpa` on the CPU, as in `test_torch_flux.py`); bf16 within the
bound stated at the test.
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

import video_styler_tpu.models.flux_adapters as JA
import video_styler_tpu.models.flux_controlnet as JC
import video_styler_tpu.models.flux_dit as JF
from video_styler_tpu.utils import ckpt as JCK

import video_styler_tpu_torch.models.flux_adapters as TA
import video_styler_tpu_torch.models.flux_controlnet as TC
import video_styler_tpu_torch.models.flux_dit as TF
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.safetensors_io import save_file
from video_styler_tpu_torch.utils import ckpt as TCK

from test_torch_flux import (BASE, TOL_F32, _cast, _dit_inputs, _dit_tree, _image,
                             _pipelines, _port_cfg, pipes)  # noqa: F401
from test_torch_fun import _rel
from test_torch_pipeline import _tree, cpu_share  # noqa: F401

# the InfiniteYou projector 64 wide and 64 out (FLUX_DIT_TINY's text width;
# the JAX forward's 20 heads of 64), the LoRA encoder 64 wide
INFINITEYOU_TINY = dataclasses.replace(TA.INFINITEYOU, dim=64, depth=2, num_queries=4,
                                       output_dim=64)
FLUX_LORA_ENCODER_TINY = dataclasses.replace(TA.FLUX_LORA_ENCODER, embed_dim=64,
                                             intermediate_dim=128, num_embeds_per_lora=2)

IP_TOKENS, IP_DIM = 8, 48


def _perturbed(tree, seed: int):
    """Biases, norm weights and scales of a JAX tree moved off their init."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        leaf = jax.tree_util.keystr(path)
        if any(leaf.endswith(f"['{n}']") for n in ("b", "weight", "scale", "bias")):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, _tree(tree))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ------------------------------------------------------------ ControlNet

CN_CASES = {"plain": {}, "union": dict(num_mode=10), "inpaint": dict(additional_input_dim=4)}


@functools.lru_cache(maxsize=None)
def _controlnet(case: str):
    jcfg = dataclasses.replace(JC.FLUX_CONTROLNET_TINY, **CN_CASES[case])
    tree = _perturbed(JC.init_flux_controlnet(jax.random.PRNGKey(3), jcfg), 4)
    tcfg = TC.FluxControlNetConfig(**{**{f.name: getattr(jcfg, f.name)
                                        for f in dataclasses.fields(jcfg)},
                                     "dit": _port_cfg(jcfg.dit)})
    return jcfg, tcfg, tree


def _cn_inputs(case: str, text: int = 6):
    rng = np.random.default_rng(5)
    ch = 16 + CN_CASES[case].get("additional_input_dim", 0) // 4
    d = JF.FLUX_DIT_TINY
    return (rng.standard_normal((1, 16, 8, 8)).astype(np.float32),
            rng.standard_normal((1, ch, 8, 8)).astype(np.float32),
            np.array([700.0], np.float32),
            rng.standard_normal((1, text, d.context_dim)).astype(np.float32),
            rng.standard_normal((1, d.pooled_dim)).astype(np.float32),
            np.array([3.5], np.float32))


def _run_controlnet(case, jdtype, tdtype):
    jcfg, tcfg, tree = _controlnet(case)
    pid = 3 if case == "union" else None
    inputs = _cn_inputs(case)
    jt = _cast(tree, jdtype)
    fwd = jax.jit(lambda p, x, c, t, e, pl, g: JC.flux_controlnet_forward(
        p, jcfg, x, c, t, e, pl, g, processor_id=pid))
    cast = [jnp.asarray(a, jdtype) if i not in (2, 5) else jnp.asarray(a)
            for i, a in enumerate(inputs)]
    want = [np.asarray(r, np.float32) for r in fwd(jt, *cast)]
    model = from_jax_params("flux_controlnet", jt, tcfg, device="cpu")
    args = [_t(a, tdtype) if i not in (2, 5) else _t(a) for i, a in enumerate(inputs)]
    with torch.no_grad():
        got = [r.float().numpy() for r in TC.flux_controlnet_forward(model, *args,
                                                                     processor_id=pid)]
    return got, want


@pytest.mark.parametrize("case", sorted(CN_CASES))
def test_controlnet_forward_fp32(case):
    got, want = _run_controlnet(case, jnp.float32, torch.float32)
    for g, w, n in zip(got, want, (2, 2)):
        assert g.shape == (n, 1, 16, 96)
        assert _rel(g, w) < TOL_F32, _rel(g, w)


def test_controlnet_forward_bf16():
    got, want = _run_controlnet("union", jnp.bfloat16, torch.bfloat16)
    # bf16 activations through 4 blocks, the capped softmax against the
    # exact one (as the DiT's bf16 test). Measured ~1%
    for g, w in zip(got, want):
        assert _rel(g, w) < 3e-2, _rel(g, w)


@pytest.mark.parametrize("n,blocks", [(5, 19), (10, 38), (2, 19), (3, 4), (0, 19)])
def test_align_res_stack(n, blocks):
    res = np.random.default_rng(n).standard_normal((n, 1, 4, 8)).astype(np.float32)
    want = JC.align_res_stack(jnp.asarray(res), blocks)
    got = TC.align_res_stack(torch.from_numpy(res), blocks)
    if n == 0:
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _controlnet_reference_names(model: TC.FluxControlNet):
    """The port's ControlNet under the reference's DiffSynth names."""
    out = {}
    for k, v in model.state_dict().items():
        for emb in ("time_embedder", "guidance_embedder"):
            if k.startswith(emb + ".fc"):
                k = f"{emb}.timestep_embedder.{'0' if '.fc1.' in k else '2'}.{k.rsplit('.', 1)[1]}"
        if k.startswith("pooled_text_embedder.fc"):
            k = k.replace(".fc1.", ".0.").replace(".fc2.", ".2.")
        if k == "mode_embedder":
            k = "controlnet_mode_embedder.weight"
        out[k] = v.clone()
    return out


@pytest.mark.parametrize("case", sorted(CN_CASES))
def test_convert_flux_controlnet(case):
    """The reference-named state dict through both converters: the port's
    module equals `from_jax_params` of the JAX conversion (and its config,
    inferred from the file, the test's)."""
    jcfg, tcfg, tree = _controlnet(case)
    src = from_jax_params("flux_controlnet", tree, tcfg, device="cpu")
    sd = _controlnet_reference_names(src)
    cfg = TC.controlnet_config_for(sd, tcfg.dit)
    assert cfg == tcfg
    port = TC.FluxControlNet(cfg)
    port.load_state_dict(TC.convert_flux_controlnet(sd, cfg), strict=True)
    want = from_jax_params("flux_controlnet",
                           _tree(JC.convert_flux_controlnet(sd, jcfg, dtype=jnp.float32)),
                           tcfg, device="cpu").state_dict()
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ IP-Adapter

@functools.lru_cache(maxsize=None)
def _ipadapter():
    d = JF.FLUX_DIT_TINY
    tree = _perturbed(JC.init_flux_ipadapter(jax.random.PRNGKey(6), d, id_dim=IP_DIM,
                                             num_tokens=IP_TOKENS, num_blocks=4), 7)
    cfg = TC.FluxIpAdapterConfig(dit=_port_cfg(d), image_dim=IP_DIM, num_tokens=IP_TOKENS,
                                 num_blocks=4)
    return tree, cfg


def _ip_reference_names(model: TC.FluxIpAdapter, instantx: bool):
    proj = "image_proj.proj" if instantx else "image_proj"
    mods = "ip_adapter" if instantx else "ipadapter_modules"
    out = {}
    for k, v in model.state_dict().items():
        k = (k.replace("proj.", f"{proj}.", 1) if k.startswith("proj.")
             else k.replace("norm.scale", "image_proj.norm.weight").replace(
                 "norm.bias", "image_proj.norm.bias").replace("blocks.", f"{mods}."))
        out[k] = v.clone()
    return out


@pytest.mark.parametrize("layout", ["diffsynth", "instantx"])
def test_ipadapter_kv(layout):
    """`flux_ipadapter_kv` of two pictures' embeddings, the port's module
    from its converter of the reference-named file against the JAX
    converter and forward (fp32)."""
    tree, cfg = _ipadapter()
    sd = _ip_reference_names(from_jax_params("flux_ipadapter", tree, cfg, device="cpu"),
                             layout == "instantx")
    assert TC.ipadapter_config_for(sd, cfg.dit) == cfg
    port = TC.FluxIpAdapter(cfg)
    port.load_state_dict(TC.convert_flux_ipadapter(sd, 4), strict=True)
    jp = JC.convert_flux_ipadapter(sd, num_blocks=4, dtype=jnp.float32)
    emb = np.random.default_rng(8).standard_normal((2, IP_DIM)).astype(np.float32)
    jk, jv, _ = JC.flux_ipadapter_kv(jp, JF.FLUX_DIT_TINY, jnp.asarray(emb))
    with torch.no_grad():
        k, v = TC.flux_ipadapter_kv(port, torch.from_numpy(emb))
    assert k.shape == (4, 1, 2 * IP_TOKENS, 4, 24)
    assert _rel(k.numpy(), np.asarray(jk)) < TOL_F32
    assert _rel(v.numpy(), np.asarray(jv)) < TOL_F32


def _ip_kv(seed: int = 9):
    tree, _ = _ipadapter()
    emb = np.random.default_rng(seed).standard_normal((1, IP_DIM)).astype(np.float32)
    k, v, _ = JC.flux_ipadapter_kv(jax.tree_util.tree_map(jnp.asarray, tree),
                                   JF.FLUX_DIT_TINY, jnp.asarray(emb))
    return np.asarray(k), np.asarray(v)


def _run_dit(jdtype, tdtype, kontext=False, ip=False, bias=None, cn=False):
    cfg, tree = _dit_tree(True)
    x, t, ctx, pooled, g, kl, ki = _dit_inputs(cfg, kontext)
    kw_j, kw_t = {}, {}
    if ip:
        k, v = _ip_kv()
        kw_j["ip_kv"] = (jnp.asarray(k, jdtype), jnp.asarray(v, jdtype))
        kw_j["ip_scale"] = kw_t["ip_scale"] = 0.7
        kw_t["ip_kv"] = (_t(k, tdtype), _t(v, tdtype))
    if bias is not None:
        kw_j["attn_bias"], kw_t["attn_bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    if cn:
        rng = np.random.default_rng(10)
        res = 0.3 * rng.standard_normal((2, 1, 16, 96)).astype(np.float32)
        single = 0.3 * rng.standard_normal((2, 1, 16, 96)).astype(np.float32)
        kw_j.update(controlnet_res=jnp.asarray(res, jdtype),
                    controlnet_single_res=jnp.asarray(single, jdtype))
        kw_t.update(controlnet_res=_t(res, tdtype), controlnet_single_res=_t(single, tdtype))
    jt = _cast(tree, jdtype)
    cast = lambda a: None if a is None else jnp.asarray(a, jdtype)  # noqa: E731
    want = np.asarray(JF.flux_dit_forward(jt, cfg, cast(x), jnp.asarray(t), cast(ctx),
                                          cast(pooled), jnp.asarray(g),
                                          kontext_latents=cast(kl), kontext_ids=ki, **kw_j),
                      np.float32)
    model = from_jax_params("flux_dit", jt, _port_cfg(cfg), device="cpu")
    with torch.no_grad():
        got = TF.flux_dit_forward(model, _t(x, tdtype), _t(t), _t(ctx, tdtype),
                                  _t(pooled, tdtype), _t(g), kontext_latents=_t(kl, tdtype),
                                  kontext_ids=ki, **kw_t).float().numpy()
    return got, want


@pytest.mark.parametrize("kontext", [False, True], ids=["t2i", "kontext"])
def test_dit_ipadapter_injection_fp32(kontext):
    """IP-Adapter keys and values in every joint block (pre-RoPE image q)
    and single block (post-RoPE q over [text | image])."""
    got, want = _run_dit(jnp.float32, torch.float32, kontext=kontext, ip=True)
    base, _ = _run_dit(jnp.float32, torch.float32, kontext=kontext)
    assert _rel(got, base) > 1e-3, "the IP-Adapter changed nothing"
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_dit_ipadapter_injection_bf16():
    got, want = _run_dit(jnp.bfloat16, torch.bfloat16, ip=True)
    # as the DiT's bf16 test (capped vs exact softmax, bf16 roundings
    # through 4 blocks), plus the IP cross-attention. Measured ~1.2%
    assert _rel(got, want) < 3e-2, _rel(got, want)


@pytest.mark.parametrize("kontext", [False, True], ids=["t2i", "kontext"])
def test_dit_controlnet_residuals_fp32(kontext):
    """Joint residuals on the image stream (zero-padded over the Kontext
    tokens), single residuals past the text rows."""
    got, want = _run_dit(jnp.float32, torch.float32, kontext=kontext, cn=True)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


# ------------------------------------------------------------ EliGen

MASK_CASES = {
    "two_entities": [(slice(0, 8), slice(0, 4)), (slice(4, 8), slice(2, 8))],
    "one_entity": [(slice(2, 6), slice(2, 6))],
    "odd_patch": [(slice(1, 2), slice(3, 4)), (slice(0, 8), slice(0, 8)),
                  (slice(7, 8), slice(0, 1))],
}


def _entity_masks(case: str, h: int = 8, w: int = 8):
    regions = MASK_CASES[case]
    m = np.zeros((1, len(regions), 1, h, w), np.float32)
    for i, (ys, xs) in enumerate(regions):
        m[0, i, 0, ys, xs] = 1.0
    return m


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_entity_attention_bias_bit_equal(case):
    masks = _entity_masks(case)
    for prompt_len in (3, 8):
        want = JF.build_entity_attention_bias(masks, prompt_len, 16)
        got = TF.build_entity_attention_bias(masks, prompt_len, 16)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_dit_under_entity_bias_fp32():
    """The DiT's self-attentions through the exact `sdpa` with the bias of
    [1 entity of 4 | 4 global | 16 image] tokens (ctx of 8 rows)."""
    bias = JF.build_entity_attention_bias(_entity_masks("one_entity"), 4, 16)
    got, want = _run_dit(jnp.float32, torch.float32, bias=bias)
    base, _ = _run_dit(jnp.float32, torch.float32)
    assert _rel(got, base) > 1e-3, "the bias changed nothing"
    assert _rel(got, want) < TOL_F32, _rel(got, want)


# ------------------------------------------------------------ InfiniteYou

@functools.lru_cache(maxsize=None)
def _infiniteyou():
    c = INFINITEYOU_TINY
    tree = _perturbed(JA.init_infiniteyou_projector(
        jax.random.PRNGKey(11), dim=c.dim, depth=c.depth, dim_head=c.dim_head, heads=c.heads,
        num_queries=c.num_queries, output_dim=c.output_dim), 12)
    return tree, c


def _iy_reference_names(model: TA.InfiniteYouProjector):
    names = {"attn.norm1": "0.norm1", "attn.norm2": "0.norm2", "ff.norm": "1.0",
             "attn.to_q": "0.to_q", "attn.to_kv": "0.to_kv", "attn.to_out": "0.to_out",
             "ff.fc1": "1.1", "ff.fc2": "1.3"}
    out = {}
    for k, v in model.state_dict().items():
        k = k.replace(".scale", ".weight")
        if k.startswith("layers."):
            _, i, rest = k.split(".", 2)
            mod, leaf = rest.rsplit(".", 1)
            k = f"layers.{i}.{names[mod]}.{leaf}"
        out[k] = v.clone()
    return out


def test_infiniteyou_projector():
    """The JAX init's projector at 64 wide with the forward's 20 heads of 64
    against the JAX forward, fp32; and the reference-named file through
    both converters."""
    tree, cfg = _infiniteyou()
    model = from_jax_params("infiniteyou", tree, cfg, device="cpu")
    x = np.random.default_rng(13).standard_normal((2, 3, 512)).astype(np.float32)
    want = np.asarray(JA.infiniteyou_projector_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    with torch.no_grad():
        got = TA.infiniteyou_projector_forward(model, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4, 64)
    assert _rel(got, want) < TOL_F32, _rel(got, want)
    sd = _iy_reference_names(model)
    port = TA.InfiniteYouProjector(cfg)
    port.load_state_dict(TA.convert_infiniteyou_projector(sd), strict=True)
    ref = from_jax_params("infiniteyou", _tree(JA.convert_infiniteyou_projector(
        sd, dtype=jnp.float32)), cfg, device="cpu").state_dict()
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)


# ------------------------------------------------------------ value control

def _value_trees(dim_out: int = 32):
    return [_perturbed(JA.init_value_encoder(jax.random.PRNGKey(14 + i), dim_in=16,
                                             dim_out=dim_out, prefer_len=4), 20 + i)
            for i in range(2)]


@pytest.mark.parametrize("value", [0.0, 0.37, 1.0])
def test_single_value_encoder(value):
    tree = _value_trees()[0]
    model = from_jax_params("value_encoder", tree, None, device="cpu")
    want = np.asarray(JA.single_value_encoder_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray([value], jnp.float32)))
    with torch.no_grad():
        got = TA.single_value_encoder_forward(model, torch.tensor([value])).numpy()
    assert got.shape == (4, 32)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


@pytest.mark.parametrize("values", [(0.2, 0.9), (None, 0.9), (0.5, None)])
def test_multi_value_encoder(values):
    trees = _value_trees()
    models = [from_jax_params("value_encoder", t, None, device="cpu") for t in trees]
    want = np.asarray(JA.multi_value_encoder_forward(
        [jax.tree_util.tree_map(jnp.asarray, t) for t in trees], list(values)))
    with torch.no_grad():
        got = TA.multi_value_encoder_forward(models, list(values)).numpy()
    assert got.shape == want.shape == (4 * sum(v is not None for v in values), 32)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


# ------------------------------------------------------------ LoRA encoder

def _lora_encoder_reference_names(model: TA.FluxLoRAEncoder):
    out = {}
    for k, v in model.state_dict().items():
        if k.startswith(("model_dict.", "proj_dict.")):
            k = "embedder." + k
        if k.endswith(".scale"):
            k = k[:-len("scale")] + "weight"
        out[k] = v.clone()
    return out


@functools.lru_cache(maxsize=None)
def _lora_encoder():
    gen = torch.Generator().manual_seed(15)
    model = TA.init_flux_lora_encoder_(TA.FluxLoRAEncoder(FLUX_LORA_ENCODER_TINY), gen)
    return _lora_encoder_reference_names(model.eval())


def _fake_lora(seed: int, rank: int = 2, scale: float = 0.02):
    rng = np.random.default_rng(seed)
    lora = {}
    for pat in TA.default_lora_patterns():
        din, dout = pat["dim"]
        lora[pat["name"] + ".lora_A.weight"] = rng.standard_normal(
            (rank, din)).astype(np.float32) * scale
        lora[pat["name"] + ".lora_B.weight"] = rng.standard_normal(
            (dout, rank)).astype(np.float32) * scale
    return lora


def test_lora_encoder():
    """One drawn state dict read by both converters; a drawn rank-2 LoRA
    over all 304 probed projections (fp32)."""
    sd = _lora_encoder()
    cfg = TA.lora_encoder_config_for(sd)
    assert cfg == FLUX_LORA_ENCODER_TINY
    model = TA.FluxLoRAEncoder(cfg)
    model.load_state_dict(TA.convert_flux_lora_encoder(sd), strict=True)
    lora = _fake_lora(16)
    want = np.asarray(JA.flux_lora_encoder_forward(
        JA.convert_flux_lora_encoder(sd, dtype=jnp.float32), lora))
    with torch.no_grad():
        got = TA.flux_lora_encoder_forward(model, lora).numpy()
    assert got.shape == (1, 1, 64)
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_lora_encoder_missing_factor_raises():
    model = TA.FluxLoRAEncoder(FLUX_LORA_ENCODER_TINY)
    lora = _fake_lora(17)
    del lora["single_blocks.3.proj_out.lora_B.weight"]
    with pytest.raises(KeyError, match="single_blocks.3.proj_out.lora_B"):
        TA.flux_lora_encoder_forward(model, lora)


# ------------------------------------------------------------ pipelines

def _siglip(images):
    """A seeded stand-in for the SigLIP tower: one IP_DIM row a picture
    from its pixels."""
    arr = np.stack([np.asarray(im, np.float32).mean(axis=(0, 1)) for im in images])
    w = np.random.default_rng(18).standard_normal((3, IP_DIM)).astype(np.float32)
    return (arr / 255.0 - 0.5) @ w


def _mask_image(ys, xs, size=64):
    arr = np.zeros((size, size, 3), np.uint8)
    arr[ys, xs] = 255
    return Image.fromarray(arr)


def _attach(jp, tp, name: str):
    """Copies of the two pipelines with one adapter loaded from the same
    reference-named state dict through each side's loader."""
    jp, tp = copy.copy(jp), copy.copy(tp)
    jp._jit_cache = {}
    if name in ("controlnet", "union_controlnet", "infiniteyou"):
        _, tcfg, tree = _controlnet("union" if name == "union_controlnet" else "plain")
        sd = _controlnet_reference_names(from_jax_params("flux_controlnet", tree, tcfg,
                                                         device="cpu"))
        jp.load_controlnet(state_dict=sd)
        tp.load_controlnet(state_dict=sd)
    if name == "infiniteyou":
        tree, cfg = _infiniteyou()
        sd = {"image_proj": _iy_reference_names(from_jax_params("infiniteyou", tree, cfg,
                                                                device="cpu"))}
        jp.load_infiniteyou(state_dict=sd)
        tp.load_infiniteyou(state_dict=sd)
    if name == "ipadapter":
        tree, cfg = _ipadapter()
        sd = _ip_reference_names(from_jax_params("flux_ipadapter", tree, cfg, device="cpu"),
                                 instantx=False)
        jp.load_ipadapter(state_dict=sd, image_encoder=_siglip)
        tp.load_ipadapter(state_dict=sd, image_encoder=_siglip)
    if name == "value":
        sds = [{"prefer_value_embedder.0.weight": torch.from_numpy(t["fc1"]["w"].T.copy()),
                "prefer_value_embedder.0.bias": torch.from_numpy(t["fc1"]["b"]),
                "prefer_value_embedder.2.weight": torch.from_numpy(t["fc2"]["w"].T.copy()),
                "prefer_value_embedder.2.bias": torch.from_numpy(t["fc2"]["b"]),
                "positional_embedding": torch.from_numpy(t["pos"])}
               for t in _value_trees(JF.FLUX_DIT_TINY.context_dim)]
        jp.load_value_controllers(state_dicts=sds)
        tp.load_value_controllers(state_dicts=sds)
    if name == "lora_encoder":
        jp.load_lora_encoder(state_dict=_lora_encoder())
        tp.load_lora_encoder(state_dict=_lora_encoder())
    return jp, tp


ID_EMB = np.random.default_rng(19).standard_normal((1, 512)).astype(np.float32)
ADAPTER_REQUESTS = {
    "controlnet": ("controlnet", dict(controlnet_image=_image(2), controlnet_scale=0.8)),
    "controlnet_cfg": ("controlnet", dict(controlnet_image=_image(2), cfg_scale=2.5,
                                          negative_prompt="blurry, dark")),
    "union_controlnet": ("union_controlnet", dict(controlnet_image=_image(3),
                                                  controlnet_processor_id=4)),
    "ipadapter": ("ipadapter", dict(ipadapter_images=[_image(4)], ipadapter_scale=0.6)),
    "ipadapter_cfg": ("ipadapter", dict(ipadapter_images=[_image(4), _image(5)],
                                        cfg_scale=2.0, negative_prompt="blurry")),
    "eligen": (None, dict(eligen_entity_prompts=["a red hat", "a blue coat"],
                          eligen_entity_masks=[_mask_image(slice(0, 32), slice(0, 64)),
                                               _mask_image(slice(24, 64), slice(8, 40))])),
    "infiniteyou": ("infiniteyou", dict(controlnet_image=_image(6), infinityou_id_emb=ID_EMB,
                                        infinityou_guidance=2.0)),
    "value": ("value", dict(value_controller_inputs=[0.3, 0.8], cfg_scale=2.0)),
    "lora_encoder": ("lora_encoder", dict(lora_encoder_inputs=[_fake_lora(20)],
                                          lora_encoder_scale=0.5)),
}


@pytest.mark.parametrize("name", sorted(ADAPTER_REQUESTS))
def test_pipeline_adapter_matches_jax(pipes, name):
    jp, tp = pipes
    adapter, request = ADAPTER_REQUESTS[name]
    if adapter is not None:
        jp, tp = _attach(jp, tp, adapter)
    kw = {**BASE, **request}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert got.shape == (1, 16, 8, 8)
    assert _rel(got, want) < TOL_F32, _rel(got, want)
    assert _rel(got, tp(return_latents=True, **BASE).numpy()) > 1e-4, "no effect"


@functools.lru_cache(maxsize=None)
def _flex_pipelines():
    """The pipelines with a DiT whose x_embedder takes 16 + 4 channels."""
    jp, tp = _pipelines()
    jp, tp = copy.copy(jp), copy.copy(tp)
    jp._jit_cache = {}
    cfg, _ = _dit_tree(True)
    cfg = dataclasses.replace(cfg, in_dim=80)
    tree = _perturbed(JF.init_flux_dit(jax.random.PRNGKey(21), cfg), 22)
    jp.dit_cfg, jp.dit_params = cfg, jax.tree_util.tree_map(jnp.asarray, tree)
    tp.dit_cfg = _port_cfg(cfg)
    tp.dit = from_jax_params("flux_dit", tree, tp.dit_cfg, device="cpu")
    for p in tp.dit.parameters():
        p.data = p.data.contiguous()
    return jp, tp


@pytest.mark.parametrize("stop", [0.0, 600.0])
def test_pipeline_flex_matches_jax(pipes, stop):
    """Flex: 4 condition channels concatenated to the latents, the
    uncondition (zeros) from the stop timestep down."""
    jp, tp = _flex_pipelines()
    rng = np.random.default_rng(23)
    cond = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    kw = {**BASE, "flex_condition": cond, "flex_uncondition": np.zeros_like(cond),
          "flex_control_stop_timestep": stop}
    want = np.asarray(jp(return_latents=True, **kw), np.float32)
    got = tp(return_latents=True, **kw).numpy()
    assert _rel(got, want) < TOL_F32, _rel(got, want)


def test_pipeline_adapter_stages(pipes):
    jp, tp = _attach(*pipes, "ipadapter")
    tp(return_latents=True, **BASE, ipadapter_images=[_image(4)])
    assert "ipadapter_encode" in dict(tp.stage_times)
    jp, tp = _attach(*pipes, "controlnet")
    tp(return_latents=True, **BASE, controlnet_image=_image(2))
    assert "vae_encode_controlnet" in dict(tp.stage_times)


def test_infiniteyou_image_needs_face_embedder(pipes):
    _, tp = _attach(*pipes, "infiniteyou")
    with pytest.raises(ValueError, match="face embedder"):
        tp(return_latents=True, **BASE, infinityou_id_image=_image(7))


# ------------------------------------------------------------ load_model

def _ip57():
    return dataclasses.replace(_ipadapter()[1], num_blocks=57, dit=dataclasses.replace(
        _port_cfg(JF.FLUX_DIT_TINY), num_joint_blocks=19, num_single_blocks=38))


def _kind_files(tmp_path):
    out = {}
    _, tcfg, tree = _controlnet("union")
    out["flux_controlnet"] = _controlnet_reference_names(
        from_jax_params("flux_controlnet", tree, tcfg, device="cpu"))
    # the JAX loader reads FLUX.1-dev's 57 blocks whatever the file
    tree = _perturbed(JC.init_flux_ipadapter(jax.random.PRNGKey(6), JF.FLUX_DIT_TINY,
                                             id_dim=IP_DIM, num_tokens=IP_TOKENS), 7)
    out["flux_ipadapter"] = _ip_reference_names(
        from_jax_params("flux_ipadapter", tree, _ip57(), device="cpu"), instantx=True)
    tree, cfg = _infiniteyou()
    out["flux_infiniteyou_projector"] = _iy_reference_names(
        from_jax_params("infiniteyou", tree, cfg, device="cpu"))
    t = _value_trees()[0]
    out["flux_value_encoder"] = {
        "prefer_value_embedder.0.weight": torch.from_numpy(t["fc1"]["w"].T.copy()),
        "prefer_value_embedder.0.bias": torch.from_numpy(t["fc1"]["b"]),
        "prefer_value_embedder.2.weight": torch.from_numpy(t["fc2"]["w"].T.copy()),
        "prefer_value_embedder.2.bias": torch.from_numpy(t["fc2"]["b"]),
        "positional_embedding": torch.from_numpy(t["pos"])}
    out["flux_lora_encoder"] = _lora_encoder()
    paths = {}
    for kind, sd in out.items():
        paths[kind] = str(tmp_path / f"{kind}.safetensors")
        save_file({k: v.contiguous() for k, v in sd.items()}, paths[kind])
    return out, paths


@pytest.mark.parametrize("kind", ["flux_controlnet", "flux_ipadapter",
                                  "flux_infiniteyou_projector", "flux_value_encoder",
                                  "flux_lora_encoder"])
def test_load_model_flux_adapter_kinds(kind, tmp_path, monkeypatch):
    """Each kind detected as the JAX detector detects it and built, its
    parameters equal to `from_jax_params` of the JAX `load_model`'s tree
    (the DiT widths monkeypatched to the tiny DiT in both packages)."""
    tiny = _ip57().dit if kind == "flux_ipadapter" else _port_cfg(JF.FLUX_DIT_TINY)
    monkeypatch.setattr(TF, "FLUX_DEV", tiny)
    monkeypatch.setattr(JF, "FLUX_DEV", JF.FLUX_DIT_TINY)
    sds, paths = _kind_files(tmp_path)
    kind_t, module = TCK.load_model(paths[kind], device="cpu", dtype=torch.float32)
    kind_j, tree = JCK.load_model(paths[kind], dtype=jnp.float32)
    assert kind_t == kind_j == kind
    convert_kind, cfg = {
        "flux_controlnet": ("flux_controlnet", _controlnet("union")[1]),
        "flux_ipadapter": ("flux_ipadapter", _ip57()),
        "flux_infiniteyou_projector": ("infiniteyou", _infiniteyou()[1]),
        "flux_value_encoder": ("value_encoder", None),
        "flux_lora_encoder": ("lora_encoder", FLUX_LORA_ENCODER_TINY)}[kind]
    if kind == "flux_controlnet":
        # the JAX loader's config counts no mode table; its tree holds it
        assert "mode_embedder" in tree
    want = from_jax_params(convert_kind, _tree(tree), cfg, device="cpu").state_dict()
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
