"""Block streaming (`parallel/streaming.py`, `models/wan_streaming.py`,
`WanVideoPipeline.enable_block_streaming`) against the JAX package's
streamer and pipeline, and against the port's own resident path; the
infer_ditto and ComfyUI workflow CLIs.

Widths: the smoke models of `test_torch_pipeline.py` (DiT/VACE dim 256, 2
heads of 128, 2 layers, VACE after layers 0 and 1), weights from the JAX
init through `from_jax_params`, inputs from numpy seeds. On the CPU the
ring's copies are synchronous and no stream is made; the card's stream
and events are held in `test_torch_kernels_cuda.py`.

Tolerances (relative L2 against JAX): f32 2e-5 (the same arithmetic in
other orders; measured 6e-7); bf16 1e-2 (each side rounds to bf16 at its
own points; measured 2.7e-3); int8 and int4 5e-3 (the same integers; an
activation that rounds to a neighbouring integer on one side moves its
row by 1/127 of a term; measured 5e-4 and 3e-3).
"""
import copy
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_styler_tpu.models.wan_dit as JD
import video_styler_tpu.models.wan_vace as JV
from video_styler_tpu.models.wan_streaming import WanBlockStreamer as JStreamer
from video_styler_tpu.pipelines.wan_video_editor import WanVideoEditorPipeline as JEditor

import video_styler_tpu_torch.models.wan_dit as TD
import video_styler_tpu_torch.models.wan_vace as TV
from video_styler_tpu_torch.convert import from_jax_params
from video_styler_tpu_torch.models.wan_streaming import WanBlockStreamer
from video_styler_tpu_torch.ops import quant as tq
from video_styler_tpu_torch.parallel import streaming as S
from video_styler_tpu_torch.pipelines.wan_video_editor import WanVideoEditorPipeline as TEditor

from test_torch_pipeline import (DIT, REQUEST, VACE, _frames, _pipelines, _tree,  # noqa: F401
                                 cpu_share)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"f32": 2e-5, "bf16": 1e-2, "int8": 5e-3, "int4": 5e-3}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


_MODELS = {}


def _models():
    """(JAX DiT, JAX VACE, port DiT, port VACE): fp32, the same weights."""
    if not _MODELS:
        jp = JD.init_wan_dit(jax.random.PRNGKey(0), JD.WanDiTConfig(**DIT), jnp.float32)
        jv = JV.init_vace(jax.random.PRNGKey(1), JV.VaceConfig(**VACE), jnp.float32)
        _MODELS["m"] = (jp, jv,
                        from_jax_params("dit", _tree(jp), TD.WanDiTConfig(**DIT), device="cpu"),
                        from_jax_params("vace", _tree(jv), TV.VaceConfig(**VACE), device="cpu"))
    return _MODELS["m"]


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((1, 4, 3, 8, 8)).astype(np.float32),
            np.array([500.0], np.float32),
            r.standard_normal((1, 16, 64)).astype(np.float32),
            r.standard_normal((1, 72, 3, 8, 8)).astype(np.float32))


def _port_forward(st, lat, ts, ctx, vc, **kw):
    t = torch.from_numpy
    return st.forward(t(lat), t(ts), t(ctx), None if vc is None else t(vc), 0.8, **kw)


# --------------------------------------------------------------------------
# The streamer against JAX's and against the port's resident forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_vace", [False, True], ids=["dit", "vace"])
@pytest.mark.parametrize("resident", [0, 1, 2])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int4"])
def test_streamer_matches_jax(mode, resident, use_vace):
    """Every mode, residency (0, 1, all) and VACE case: the velocity, the
    TeaCache residual and the plan (resident and streamed bytes) of the
    port's streamer against the JAX streamer's on the same weights."""
    jp, jv, tdit, tvace = _models()
    lat, ts, ctx, vc = _inputs()
    vc = vc if use_vace else None
    js = JStreamer(jp, JD.WanDiTConfig(**DIT), jv if use_vace else None,
                   JV.VaceConfig(**VACE) if use_vace else None, mode=mode,
                   resident_blocks=resident, prefetch_depth=2)
    want = js.forward(jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx),
                      vace_context=None if vc is None else jnp.asarray(vc), vace_scale=0.8,
                      want_residual=True)
    st = WanBlockStreamer(tdit, vace=tvace if use_vace else None, mode=mode,
                          resident_blocks=resident, prefetch_depth=2)
    got = _port_forward(st, lat, ts, ctx, vc, want_residual=True)
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.dtype == torch.float32
        rel = _rel(g.float().numpy(), jnp.asarray(w, jnp.float32))
        assert rel < TOL[mode], (mode, rel)
    tp, jplan = st.plan_summary(), js.plan_summary()
    for key in ("mode", "num_layers", "resident_blocks", "vace_resident"):
        assert tp[key] == jplan[key]
    for key in ("resident_gb", "streamed_gb_per_pass"):
        assert tp[key] == pytest.approx(jplan[key], rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("use_vace", [False, True], ids=["dit", "vace"])
@pytest.mark.parametrize("resident", [0, 1, 2])
def test_streamer_f32_bit_equal_to_resident(resident, use_vace):
    """f32: the velocity and residual of `wan_dit_forward_with_residual`,
    bit for bit, for the overlapped and the serial walk."""
    _, _, tdit, tvace = _models()
    lat, ts, ctx, vc = (torch.from_numpy(a) for a in _inputs(1))
    vace = tvace if use_vace else None
    with torch.no_grad():
        want, want_res = TD.wan_dit_forward_with_residual(
            tdit, lat, ts, ctx, vace=vace, vace_context=vc if use_vace else None,
            vace_scale=0.8)
    for overlap in (True, False):
        st = WanBlockStreamer(tdit, vace=vace, mode="f32", resident_blocks=resident,
                              prefetch_depth=2, overlap=overlap)
        out, t_mod, residual = st.forward(lat, ts, ctx, vc if use_vace else None, 0.8,
                                          want_residual=True)
        assert torch.equal(out, want) and torch.equal(residual, want_res)
        assert torch.equal(t_mod, TD.time_embed(tdit, ts)[1])
    assert all(p.device.type == "cpu" for p in tdit.parameters())   # source left whole
    assert len(tdit.blocks) == DIT["num_layers"]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_streamer_quantized_equals_quantize_params(mode):
    """int8 / int4: the resident `quantize_params` path (blocks and VACE
    blocks quantised, the rest kept) bit for bit, with one resident block
    and the rest streamed; a pipeline quantised first streams its
    quantised leaves as they are (`--quantize int8 --streaming int8`)."""
    _, _, tdit, tvace = _models()
    lat, ts, ctx, vc = (torch.from_numpy(a) for a in _inputs(2))
    qd, qv = copy.deepcopy(tdit), copy.deepcopy(tvace)
    for model in (qd, qv):
        tq.quantize_params(model, mode=mode, predicate=lambda path, layer: path.startswith(
            ("blocks.", "after_proj.")))
    assert isinstance(qv.after_proj[0], tq.QuantLinear)
    assert not isinstance(qv.before_proj, tq.QuantLinear)
    assert isinstance(qd.blocks[0].ffn.fc1, tq.QuantLinear)
    with torch.no_grad():
        want = TD.wan_dit_forward(qd, lat, ts, ctx, vace=qv, vace_context=vc, vace_scale=0.8)
    for dit, vace in ((tdit, tvace), (qd, qv)):
        st = WanBlockStreamer(dit, vace=vace, mode=mode, resident_blocks=1, prefetch_depth=1)
        assert st.vace_streamed_host is not None and len(st.streamed_host) == 1
        assert torch.equal(st.forward(lat, ts, ctx, vc, 0.8)[0], want)


def test_serial_walk_equals_overlapped_and_reuses_slots():
    """overlap=False is a schedule only: equal outputs; two forwards through
    a ring of 2 slots with 3 streamed items each."""
    _, _, tdit, tvace = _models()
    lat, ts, ctx, vc = _inputs(3)
    outs = []
    for overlap in (True, False):
        st = WanBlockStreamer(tdit, vace=tvace, mode="int8", resident_blocks=1,
                              prefetch_depth=1, overlap=overlap)
        assert len(st.ring.slots) == 2
        outs.append([_port_forward(st, lat, ts, ctx, vc)[0] for _ in range(2)])
        assert st.ring.copies == 2 * 3
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_budget_residency_and_clamp():
    """The budget arithmetic of the JAX streamer: the resident count from
    hbm_budget_gb and the headroom, explicit counts clamped to [0, N], the
    VACE branch resident only beside a whole resident trunk."""
    jp, jv, tdit, tvace = _models()
    for budget in (2.5 + 0.004, 2.5 + 0.02, 2.5 + 0.1):
        js = JStreamer(jp, JD.WanDiTConfig(**DIT), jv, JV.VaceConfig(**VACE), mode="int8",
                       hbm_budget_gb=budget, prefetch_depth=1)
        st = WanBlockStreamer(tdit, vace=tvace, mode="int8", hbm_budget_gb=budget,
                              prefetch_depth=1)
        assert st.plan_summary() == pytest.approx(js.plan_summary())
    assert WanBlockStreamer(tdit, mode="f32", resident_blocks=99).resident_blocks == 2
    assert WanBlockStreamer(tdit, mode="f32", resident_blocks=-3).resident_blocks == 0
    st = WanBlockStreamer(tdit, vace=tvace, mode="f32", resident_blocks=2)
    assert len(st.resident) == 2 and st.streamed_host == []
    assert st.build_schedule(True) == [("trunk", 0), ("vace", 0), ("trunk", 1), ("vace", 1)]
    assert st.resident_block(1)["ffn.fc1.weight"] is not None
    with pytest.raises(IndexError):
        WanBlockStreamer(tdit, mode="f32", resident_blocks=1).resident_block(1)
    with pytest.raises(ValueError):
        WanBlockStreamer(tdit, mode="fp8")


def test_teacache_pieces_match_jax():
    """t_mod_only and skip_forward (the replay of a cached residual)."""
    jp, _, tdit, _ = _models()
    lat, ts, ctx, _ = _inputs(4)
    js = JStreamer(jp, JD.WanDiTConfig(**DIT), mode="f32", resident_blocks=0)
    st = WanBlockStreamer(tdit, mode="f32", resident_blocks=0)
    residual = np.random.default_rng(5).standard_normal((1, 48, 256)).astype(np.float32)
    assert _rel(st.t_mod_only(torch.from_numpy(ts)).numpy(),
                js.t_mod_only(jnp.asarray(ts))) < 2e-5
    got = st.skip_forward(torch.from_numpy(lat), torch.from_numpy(ts), None,
                          torch.from_numpy(residual))
    want = js.skip_forward(jnp.asarray(lat), jnp.asarray(ts), None, jnp.asarray(residual))
    assert _rel(got.numpy(), want) < 2e-5


# --------------------------------------------------------------------------
# The host store
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stack", [1, 2])
def test_host_quantizers_match_ops_quant(stack):
    """The host quantisers give `quantize_params`' values and size rules
    (the stack counted as the JAX stacks count it); quantised leaves pass
    through; the int8 weight stays column-major."""
    g = torch.Generator().manual_seed(0)
    block = TD.init_weights_(TD.DiTBlock(TD.WanDiTConfig(**dict(DIT, ffn_dim=160))), g)
    tree = S.block_tree(block)
    for host, mode in ((S.host_quantize_int8, "int8"), (S.host_quantize_int4, "int4")):
        got = host(tree, stack=stack)
        want = copy.deepcopy(block)
        holder = torch.nn.Module()
        holder.blocks = torch.nn.ModuleList([want] * stack)   # counted as a stack
        tq.quantize_params(holder, mode=mode)
        want = S.block_tree(want)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]) and got[k].stride() == want[k].stride(), k
        # fc2 (160 -> 256) has 40,960 elements: quantised only as a stack of 2
        assert ("ffn.fc2.w_scale" in got) == (stack == 2)
        again = host(got, stack=stack)
        assert all(again[k] is got[k] for k in got)


def test_host_quantizers_match_jax():
    """The same integers and scales as the JAX host quantisers."""
    from video_styler_tpu.parallel.streaming import (host_quantize_int4 as j4,
                                                     host_quantize_int8 as j8)
    w = np.random.default_rng(0).standard_normal((256, 384)).astype(np.float32)  # (out, in)
    tree = {"lin.weight": torch.from_numpy(w), "lin.bias": torch.zeros(256)}
    for port, jax_q, key in ((S.host_quantize_int8, j8, "w_q"), (S.host_quantize_int4, j4, "w_q4")):
        got = port(tree, stack=3)
        want = jax_q({"lin": {"w": np.stack([w.T] * 3)}})["lin"]
        np.testing.assert_array_equal(got[f"lin.{key}"].numpy(), want[key][0])
        np.testing.assert_array_equal(got["lin.w_scale"].numpy(), want["w_scale"][0])


def test_pack_views_bf16_cast_and_alias_dedup():
    """One buffer a block: views hold each tensor's values, shape and layout
    at 512-byte offsets; bf16 mode casts floats and keeps integers; the
    cache packs aliased trees once and distinct ones apart."""
    q = torch.randint(-127, 128, (96, 160), dtype=torch.int8)
    tree = {"lin.w_q": q.t(), "lin.w_scale": torch.rand(1, 160),
            "lin.b": torch.rand(160).to(torch.bfloat16), "norm.scale": torch.rand(96)}
    packed = S.pack_host_block(tree)
    assert S.tree_bytes(packed) == S.tree_bytes(tree)
    assert all(off % S.ALIGN == 0 for _, _, off, _, _ in packed.spec)
    views = S.unpack(packed.buf, packed.spec)
    for k, t in tree.items():
        assert torch.equal(views[k], t) and views[k].stride() == t.stride(), k
    cast = S.host_cast_bf16(tree)
    assert cast["lin.w_q"].dtype == torch.int8
    assert {cast[k].dtype for k in tree if k != "lin.w_q"} == {torch.bfloat16}
    stacked = torch.rand(4, 8).expand(6, 4, 8)
    cache = {}
    p0 = S.pack_host_block({"w": stacked[0]}, cache=cache)
    assert S.pack_host_block({"w": stacked[3]}, cache=cache) is p0
    assert S.pack_host_block({"w": stacked[0].clone()}, cache=cache) is not p0
    assert S.split_host_blocks([tree, tree], 1, 2) == [tree]


def test_bf16_mode_casts_small_and_blocks():
    """mode="bf16" streams and keeps bf16 only; an f32 checkpoint's small
    parameters are cast too (a copy: the source stays f32)."""
    _, _, tdit, tvace = _models()
    st = WanBlockStreamer(tdit, vace=tvace, mode="bf16", resident_blocks=0)
    dtypes = {d for b in st.streamed_host + st.vace_streamed_host for _, d, _, _, _ in b.spec}
    assert dtypes == {torch.bfloat16}
    assert {p.dtype for p in st.small.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in tdit.parameters()} == {torch.float32}
    lat, ts, ctx, vc = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(6))
    assert st.forward(lat, ts.float(), ctx, vc)[0].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# The pipeline, the editor, dit2 and the refusals against JAX's
# --------------------------------------------------------------------------

STREAM = dict(mode="f32", resident_blocks=1, prefetch_depth=1)


@pytest.mark.parametrize("case", ["two-pass-teacache", "cfg_merge"])
def test_pipeline_streaming_matches_jax(case):
    """The VACE edit through `enable_block_streaming` in both packages
    (f32, one resident block): two-pass CFG with a TeaCache that replays
    the residual on the middle step, and the merged CFG batch; bit-equal
    to the port's own resident run."""
    extra = (dict(num_inference_steps=3, tea_cache_l1_thresh=0.5,
                  tea_cache_model_id="Wan2.1-T2V-1.3B") if case == "two-pass-teacache"
             else dict(cfg_merge=True))
    kw = dict(REQUEST, vace_video=_frames(), return_latents=True, **extra)
    jp, tp = _pipelines(jnp.float32, torch.float32)
    resident = tp(**kw)
    jplan = jp.enable_block_streaming(**STREAM)
    plan = tp.enable_block_streaming(**STREAM)
    assert plan == pytest.approx(jplan)
    assert tp.dit is None and tp.vace is None and jp.dit_params is None
    want = np.asarray(jnp.asarray(jp(**kw), jnp.float32))
    got = tp(**kw)
    assert torch.equal(got, resident)
    assert _rel(got.numpy(), want) < 2e-5


def test_editor_streaming_matches_jax():
    """The keyframe-guided editor (joint sequence, RoPE ids) through a
    streamed DiT with no resident block, against JAX's streamed editor."""
    jp, tp = _pipelines(jnp.float32, torch.float32)
    je, te = JEditor(dtype=jnp.float32), TEditor(device="cpu", dtype=torch.float32)
    je.__dict__.update(jp.__dict__)
    te.__dict__.update(tp.__dict__)
    kw = dict(prompt="turn it into a watercolor", negative_prompt="blurry",
              source_video=_frames(), edited_keyframes=255 - _frames()[[0, 8]],
              keyframe_indices=[0, 8], seed=42, height=32, width=32, num_frames=9,
              cfg_scale=5.0, num_inference_steps=2, alpha=10.0, tiled=True, verbose=False,
              return_latents=True)
    resident = te(**kw)
    for p in (je, te):
        p.enable_block_streaming(mode="f32", resident_blocks=0, prefetch_depth=2)
    got = te(**kw)
    assert torch.equal(got, resident)
    assert _rel(got.numpy(), jnp.asarray(je(**kw), jnp.float32)) < 2e-5


def test_dit2_streaming_matches_jax():
    """A dual-expert request (the second expert below switch_DiT_boundary)
    with both experts streamed in the port, against the JAX pipeline with
    its `dit` streamed. (JAX's own `target="dit2"` drops `dit2_params`,
    which its loop reads to decide the switch: the second expert would
    never run; ROADMAP Queue 3.) Bit-equal to the port's resident run."""
    jp, tp = _pipelines(jnp.float32, torch.float32)
    jp.dit2_cfg = jp.dit_cfg
    jp.dit2_params = JD.init_wan_dit(jax.random.PRNGKey(5), jp.dit_cfg, jnp.float32)
    tp.dit2 = from_jax_params("dit", _tree(jp.dit2_params), TD.WanDiTConfig(**DIT),
                              device="cpu")
    kw = dict(REQUEST, prompt="a cat", vace_video=None, num_inference_steps=2,
              return_latents=True)
    resident = tp(**kw)
    jp.enable_block_streaming(**STREAM)
    for target in ("dit", "dit2"):
        tp.enable_block_streaming(target=target, **STREAM)
    assert tp.dit2 is None and set(tp._streamers) == {"dit", "dit2"}
    got = tp(**kw)
    assert torch.equal(got, resident)
    assert _rel(got.numpy(), jnp.asarray(jp(**kw), jnp.float32)) < 2e-5


@pytest.mark.parametrize("what", ["animate", "motion", "camera", "reference"])
def test_streaming_refusals_match_jax(what):
    """Per-layer adapters raise ValueError in both packages once the DiT
    streams."""
    jp, tp = _pipelines(jnp.float32, torch.float32)
    jp.enable_block_streaming(**STREAM)
    tp.enable_block_streaming(**STREAM)
    lat, ts, ctx, _ = _inputs(7)
    z = np.zeros((1, 4, 3, 8, 8), np.float32)
    jkw = {"animate": dict(animate_inputs=(z, z)), "motion": dict(motion_bucket_id=z[:, 0, 0, 0]),
           "camera": dict(control_camera=z), "reference": dict(reference_latents=z)}[what]
    tkw = {k: (tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
               else torch.from_numpy(v)) for k, v in jkw.items()}
    with pytest.raises(ValueError):
        jp._branch_forward("dit", None, None, jnp.asarray(lat), jnp.asarray(ts),
                           jnp.asarray(ctx), None, 1.0, None, **jkw)
    with pytest.raises(ValueError):
        tp._branch_forward("dit", None, torch.from_numpy(lat), torch.from_numpy(ts),
                           torch.from_numpy(ctx), None, 1.0, None, **tkw)


@pytest.mark.parametrize("case", ["two-pass", "cfg_merge"])
def test_streamed_slg_matches_resident_and_jax(case):
    """Skip-layer guidance on block 1 for the whole request through a
    streamed DiT (one block resident, one streamed): bit-equal to the
    port's resident run, and within 2e-5 of the JAX pipeline's resident
    run (the JAX pipeline refuses SLG under streaming: ROADMAP Queue 3)."""
    kw = dict(REQUEST, vace_video=_frames(), slg_blocks=(1,), slg_start=0.0, slg_end=1.0,
              cfg_merge=case == "cfg_merge", return_latents=True)
    jp, tp = _pipelines(jnp.float32, torch.float32)
    resident = tp(**kw)
    want = np.asarray(jnp.asarray(jp(**kw), jnp.float32))
    tp.enable_block_streaming(**STREAM)
    got = tp(**kw)
    assert torch.equal(got, resident)
    assert not torch.equal(got, tp(**dict(kw, slg_blocks=None)))
    assert _rel(got.numpy(), want) < 2e-5
    jp.enable_block_streaming(**STREAM)
    with pytest.raises(ValueError):
        jp(**kw)


_DUAL = {}


def _dual_expert_vace_fun():
    """The Wan2.2-VACE-Fun-A14B layout at smoke widths: two experts, one
    shared `vace`, no `vace2`."""
    _, tp = _pipelines(jnp.float32, torch.float32)
    if "dit2" not in _DUAL:
        _DUAL["dit2"] = _tree(JD.init_wan_dit(jax.random.PRNGKey(5), JD.WanDiTConfig(**DIT),
                                              jnp.float32))
    tp.dit2 = from_jax_params("dit", _DUAL["dit2"], TD.WanDiTConfig(**DIT), device="cpu")
    return tp


@pytest.mark.parametrize("targets", [("dit",), ("dit2",), ("dit", "dit2"), ("dit2", "dit")],
                         ids=["dit", "dit2", "dit-then-dit2", "dit2-then-dit"])
def test_vace_fun_dual_expert_streaming_bit_equal_to_resident(targets):
    """A VACE edit across the expert switch on the VACE-Fun dual-expert
    layout: with either expert streamed, or both in either order, each
    expert still runs the shared VACE, bit-equal to the resident run (a
    resident `dit2` keeps the shared VACE as `vace2`). The second expert's
    hints matter: leaving them out moves the latents."""
    kw = dict(REQUEST, vace_video=_frames(), return_latents=True)
    if "resident" not in _DUAL:
        _DUAL["resident"] = _dual_expert_vace_fun()(**kw)
        tp = _dual_expert_vace_fun()
        forward = tp._branch_forward
        tp._branch_forward = lambda which, vace, *a, **k: forward(
            which, None if which == "dit2" else vace, *a, **k)
        _DUAL["dit2_without_vace"] = tp(**kw)
    assert not torch.equal(_DUAL["resident"], _DUAL["dit2_without_vace"])
    tp = _dual_expert_vace_fun()
    vace = tp.vace
    for target in targets:
        tp.enable_block_streaming(target=target, **STREAM)
    if targets == ("dit",):
        assert tp.vace is None and tp.vace2 is vace
    assert tp._has_vace("dit") and tp._has_vace("dit2")
    assert torch.equal(tp(**kw), _DUAL["resident"])


def test_streaming_releases_modules_and_refuses_a_mesh():
    """The resident modules and a hotload stack of the target go; no
    stream under a mesh, and no mesh over a streamed pipeline."""
    _, tp = _pipelines(jnp.float32, torch.float32)
    tp._lora_stacks["dit"] = {"base": {}, "loras": []}
    tp.enable_block_streaming(**STREAM)
    assert tp.dit is None and tp.vace is None and "dit" not in tp._lora_stacks
    with pytest.raises(ValueError):
        tp.enable_block_streaming(target="dit2")
    with pytest.raises(NotImplementedError):
        tp.shard(mesh=None)
    _, tp2 = _pipelines(jnp.float32, torch.float32)
    tp2.sharding_ctx = object()
    with pytest.raises(NotImplementedError):
        tp2.enable_block_streaming(**STREAM)


# --------------------------------------------------------------------------
# The CLIs
# --------------------------------------------------------------------------

def test_infer_ditto_streaming_cli(tmp_path, capsys):
    """`infer_ditto --smoke --device cpu --quantize int8 --streaming int8`:
    the plan printed, the frames those of the resident int8 run."""
    from video_styler_tpu_torch import infer_ditto
    argv = ["--smoke", "--prompt", "x", "--device", "cpu", "--quantize", "int8",
            "--num_inference_steps", "2"]
    resident = infer_ditto.main(argv + ["--output_path", str(tmp_path / "r.mp4")])
    streamed = infer_ditto.main(argv + ["--streaming", "int8", "--streaming_budget_gb", "0",
                                        "--output_path", str(tmp_path / "s.mp4")])
    out = capsys.readouterr().out
    assert "block streaming: {'mode': 'int8'" in out and "'resident_blocks': 0" in out
    assert np.array_equal(resident, streamed)
    with pytest.raises(SystemExit):
        infer_ditto.main(argv + ["--streaming", "int8", "--mesh", "1,1,1"])


def _workflow(tmp_path, drop=()) -> str:
    """A graph of the reference Ditto workflow's node types (less `drop`)."""
    graph = {"nodes": [
        {"type": "WanVideoSampler",
         "widgets_values": [4, 1.2, 2.0, 7, "randomize", True, "unipc"]},
        {"type": "WanVideoTextEncode", "widgets_values": ["Make it a Pixel Art video.", "bad"]},
        {"type": "WanVideoVACEEncode", "widgets_values": [832, 480, 33, 0.975, 0, 1, False]},
        {"type": "WanVideoModelLoader",
         "widgets_values": ["Wan2_1-T2V-14B_fp8_e4m3fn.safetensors", "fp16", "disabled",
                            "offload_device", "sdpa"]},
        {"type": "WanVideoLoraSelect", "widgets_values": ["causvid_r32.safetensors", 0.5]},
        {"type": "WanVideoVACEModelSelect", "widgets_values": ["ditto_vace.safetensors"]},
        {"type": "WanVideoVAELoader", "widgets_values": ["Wan2_1_VAE_bf16.safetensors"]},
        {"type": "LoadWanVideoT5TextEncoder", "widgets_values": ["umt5-xxl-enc.safetensors"]},
        {"type": "WanVideoBlockSwap", "widgets_values": [20, False, False]},
        {"type": "WanVideoDecode", "widgets_values": [False, 272, 272, 144, 128, "default"]},
        {"type": "WanVideoSLG", "widgets_values": ["1", 0.2, 0.7]},
        {"type": "WanVideoTorchCompileSettings", "widgets_values": []},
    ]}
    graph["nodes"] = [n for n in graph["nodes"] if n["type"] not in drop]
    path = tmp_path / f"workflow{len(drop)}.json"
    path.write_text(json.dumps(graph))
    return str(path)


def test_parse_workflow_matches_jax(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "inference"))
    try:
        from run_comfyui_workflow import parse_workflow as jparse
    finally:
        sys.path.remove(os.path.join(REPO, "inference"))
    from video_styler_tpu_torch.run_comfyui_workflow import parse_workflow
    path = _workflow(tmp_path)
    r = parse_workflow(path)
    assert r == jparse(path)
    assert r["tile_size"] == (34, 34) and r["tile_stride"] == (18, 16)
    assert r["quantized"] and r["blocks_to_swap"] == 20 and r["slg_blocks"] == (1,)


def test_workflow_recipe_matches_jax(tmp_path):
    """The recipe (UniPC at its shift, 4 steps, cfg 1.2, vace_scale 0.975,
    SLG on block 1 in [0.2, 0.7)) on the same fp32 pipelines."""
    from video_styler_tpu.schedulers.flow_unipc import FlowUniPCMultistepScheduler as JUniPC
    from video_styler_tpu_torch.run_comfyui_workflow import parse_workflow
    from video_styler_tpu_torch.schedulers.flow_unipc import FlowUniPCMultistepScheduler
    r = parse_workflow(_workflow(tmp_path))
    jp, tp = _pipelines(jnp.float32, torch.float32)
    jp.scheduler, tp.scheduler = JUniPC(shift=r["shift"]), FlowUniPCMultistepScheduler(
        shift=r["shift"])
    kw = dict(prompt=r["prompt"], negative_prompt=r["negative_prompt"], vace_video=_frames(),
              vace_scale=r["vace_scale"], num_frames=9, height=32, width=32, seed=r["seed"],
              num_inference_steps=r["steps"], cfg_scale=r["cfg_scale"],
              sigma_shift=r["shift"], tiled=False, slg_blocks=r["slg_blocks"],
              slg_start=r["slg_start"], slg_end=r["slg_end"], return_latents=True)
    got = tp(**kw)
    assert _rel(got.numpy(), jnp.asarray(jp(**kw), jnp.float32)) < 2e-5


def test_workflow_cli_smoke(tmp_path, capsys):
    """The reference graph's recipe under --smoke: int8 for the fp8 model,
    block swap streaming every block, SLG inside its window."""
    from video_styler_tpu_torch import run_comfyui_workflow
    frames = run_comfyui_workflow.main(["--workflow", _workflow(tmp_path), "--smoke",
                                        "--device", "cpu",
                                        "--output_path", str(tmp_path / "wf.mp4")])
    assert frames.shape == (9, 32, 32, 3) and frames.dtype == np.uint8
    out = capsys.readouterr().out
    assert "recipe: steps=4 cfg=1.2 shift=2.0 scheduler=unipc" in out
    assert "block streaming: {'mode': 'int8'" in out and "'resident_blocks': 0" in out
    assert os.path.getsize(tmp_path / "wf.mp4") > 0


def test_workflow_cli_block_swap_equals_resident(tmp_path):
    """The graph with and without its WanVideoBlockSwap node under --smoke
    (int8, SLG on block 1 in [0.2, 0.7) of 4 steps): the same frames."""
    from video_styler_tpu_torch import run_comfyui_workflow
    runs = [run_comfyui_workflow.main(["--workflow", _workflow(tmp_path, drop), "--smoke",
                                       "--device", "cpu",
                                       "--output_path", str(tmp_path / f"{len(drop)}.mp4")])
            for drop in ((), ("WanVideoBlockSwap",))]
    assert np.array_equal(runs[0], runs[1])
