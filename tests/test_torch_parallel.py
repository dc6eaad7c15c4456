"""The port's multi-GPU path (`video_styler_tpu_torch/parallel/`) against
the JAX package's, on the CPU: Ulysses, the ring, the DiT and VACE under a
(dp, fsdp, sp) mesh, FSDP2's share of the bytes, the VACE pipeline with
TeaCache, the keyframe editor and `infer_ditto --mesh`.

The ranks are processes on the gloo backend, spawned by
`parallel.run_local` with a `file://` store under the test's temporary
directory, one torch thread each. Two spawns (4 ranks, then 2) run every
case and return numpy arrays; the JAX side runs here on the 8-device CPU
mesh that `tests/conftest.py` sets. A spawned rank imports this module to
find its function, so JAX and the JAX package are imported only inside the
tests, and the `cpu_share` fixture (whose module imports JAX) only in the
pytest process.

Widths: the JAX sharded tests' DiT (4 heads of 48, 2 layers) for the
forwards; the port's pipeline tests' smoke widths (2 heads of 128) for the
pipelines. fp32 holds to rtol 2e-5 unless stated, as the JAX tests do;
the one bf16 case to a few bf16 ULPs.
"""
import multiprocessing
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

# a spawned rank is named before it imports this module to find its function
if multiprocessing.current_process().name == "MainProcess":
    from test_torch_pipeline import cpu_share  # noqa: F401

DIT = dict(dim=4 * 48, in_dim=16, ffn_dim=384, out_dim=16, num_heads=4,
           num_layers=2, text_dim=64, freq_dim=32)
VACE = dict(vace_layers=(0, 1), dim=4 * 48, num_heads=4, ffn_dim=384)
# f, h, w of the latents: 4 x 8 x 8 -> 256 tokens; 3 x 5 x 3 -> 45, which
# pads to 48 at sp = 2 (shares of whole 8 rows: wan_dit.SHARD_ROWS)
GRIDS = {"256": (4, 16, 16), "ragged45": (3, 10, 6)}


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _state(module):
    return {k: v.detach().float().numpy() for k, v in module.state_dict().items()}


def _load(cls, cfg, state, dtype=torch.float32):
    with torch.device("meta"):
        m = cls(cfg, dtype=dtype)
    m.to_empty(device="cpu").load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return m.eval()


def _attention_inputs():
    qkv = [_rand(s, (1, 64, 4, 16)) for s in range(3)]
    ring = [_rand(10 + s, (2, 64, 3, 16)) for s in range(3)]
    return qkv, ring


def _dit_inputs(grid):
    f, h, w = GRIDS[grid]
    return (_rand(1, (1, 16, f, h, w)), np.array([500.0], np.float32),
            _rand(2, (1, 8, 64)), _rand(3, (1, 96, f, h, w)))


# ---------------------------------------------------------------------------
# rank functions (no JAX here)
# ---------------------------------------------------------------------------

def _mesh4_rank(dit_state, vace_state):
    """Every 4-rank case; returns this rank's outputs."""
    torch.set_num_threads(1)
    from video_styler_tpu_torch.models import wan_dit as TD, wan_vace as TV
    from video_styler_tpu_torch.parallel import (
        ShardingContext, broadcast_object, gather_seq, is_main_process, make_mesh,
        process_index, replicate_params, ring_attention, shard_params_fsdp, split_seq,
        ulysses_attention, use_sharding)
    out = {"main": is_main_process(), "bcast": broadcast_object(
        {"seed": 7} if is_main_process() else None)}
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(process_index()))
    out["replicated"] = replicate_params(lin).weight.detach().numpy()
    try:
        make_mesh(1, 1, 2, device_type="cpu")
    except ValueError as e:
        out["mesh_error"] = str(e)

    qkv, ring = _attention_inputs()
    sp4 = ShardingContext(make_mesh(1, 1, 4, device_type="cpu"))
    with use_sharding(sp4):
        for name, arrays, fn in (("ulysses", qkv, ulysses_attention),
                                 ("ring", ring, ring_attention)):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (split_seq(torch.from_numpy(a).to(dtype)) for a in arrays)
                key = name + ("" if dtype == torch.float32 else "_bf16")
                out[key] = gather_seq(fn(q, k, v, sp4)).float().numpy()

    mesh = make_mesh(1, 2, 2, device_type="cpu")
    dit = _load(TD.WanDiT, TD.WanDiTConfig(**DIT), dit_state)
    vace = _load(TV.WanVace, TV.VaceConfig(**VACE), vace_state)
    whole = sum(p.numel() * p.element_size() for p in dit.parameters())
    shard_params_fsdp(dit, mesh)
    shard_params_fsdp(vace, mesh)
    out["param_bytes"] = (whole, sum(p.to_local().numel() * p.element_size()
                                     for p in dit.parameters()))
    for ulysses in (True, False):
        with use_sharding(ShardingContext(mesh, ulysses=ulysses)), torch.no_grad():
            for grid in GRIDS:
                x, t, ctx, vctx = (torch.from_numpy(a) for a in _dit_inputs(grid))
                tag = f"{grid}_{'ulysses' if ulysses else 'ring'}"
                out[f"dit_{tag}"] = TD.wan_dit_forward(dit, x, t, ctx).numpy()
                if grid == "ragged45":
                    out[f"vace_{tag}"] = TD.wan_dit_forward(
                        dit, x, t, ctx, vace=vace, vace_context=vctx).numpy()
    return out


SMOKE_REQUEST = dict(prompt="make it a watercolor painting", negative_prompt="blurry",
                     num_frames=9, height=32, width=32, seed=42, cfg_scale=5.0,
                     num_inference_steps=2, tiled=True)
TEA = dict(num_inference_steps=4, tea_cache_l1_thresh=10.0,
           tea_cache_model_id="Wan2.1-T2V-1.3B")
EDIT = dict(prompt="turn it into a watercolor", negative_prompt="blurry",
            keyframe_indices=[0, 8], seed=42, height=32, width=32, num_frames=9,
            cfg_scale=5.0, num_inference_steps=2, alpha=10.0, tiled=True,
            verbose=False, return_latents=True)


def _mesh2_rank(states, configs, video, keyframes, out_dir):
    """The pipeline, its TeaCache replay and the editor under (1, 1, 2),
    then `infer_ditto --smoke --mesh 1,1,2`."""
    torch.set_num_threads(1)
    from video_styler_tpu_torch import infer_ditto
    from video_styler_tpu_torch.models import t5 as TT, wan_dit as TD, wan_vace as TV, \
        wan_vae as TVAE
    from video_styler_tpu_torch.parallel import ShardingContext, make_mesh, process_index
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.pipelines.wan_video_editor import WanVideoEditorPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer, WanPrompter

    def pipe(cls):
        p = cls(device="cpu", dtype=torch.float32)
        p.dit = _load(TD.WanDiT, TD.WanDiTConfig(**configs["dit"]), states["dit"])
        p.vace = _load(TV.WanVace, TV.VaceConfig(**configs["vace"]), states["vace"])
        p.vae = _load(TVAE.WanVAE, TVAE.WanVAEConfig(**configs["vae"]), states["vae"])
        t5 = _load(TT.T5Encoder, TT.T5Config(**configs["t5"]), states["t5"])
        p.prompter = WanPrompter(StubTokenizer(configs["text_len"]), configs["text_len"], t5)
        p.sharding_ctx = ShardingContext(make_mesh(1, 1, 2, device_type="cpu"))
        return p

    out = {}
    tp = pipe(WanVideoPipeline)
    out["pipeline"] = tp(vace_video=video, return_latents=True, **SMOKE_REQUEST).numpy()
    out["tea_cache"] = tp(vace_video=video, return_latents=True,
                          **dict(SMOKE_REQUEST, **TEA)).numpy()
    te = pipe(WanVideoEditorPipeline)
    out["editor"] = te(source_video=video, edited_keyframes=keyframes, **EDIT).numpy()
    from video_styler_tpu_torch import usp
    out["usp"] = usp.main(["--smoke", "--sp", "2", "--device", "cpu"]).float().numpy()
    from video_styler_tpu_torch import wan_video_gen as G
    out["refused"] = []
    for name in ("Wan2.2-Animate-14B", "Wan2.2-S2V-14B"):
        recipe = G.RECIPES[name]
        h, w, n = G.smoke_size(recipe)
        inputs = G.smoke_inputs(recipe, h, w, n)
        pipe = G.build_smoke_pipeline(recipe, device="cpu").shard(
            make_mesh(1, 1, 2, device_type="cpu"))
        try:
            if recipe.arch == "s2v":
                pipe.s2v("x", inputs["input_image"], None, num_frames=n, height=h, width=w)
            else:
                pipe("x", height=h, width=w, num_frames=n, num_inference_steps=1, **inputs)
        except NotImplementedError as e:
            out["refused"].append(str(e))
    path = os.path.join(out_dir, f"rank{process_index()}.mp4")
    out["cli"] = infer_ditto.main(["--smoke", "--prompt", "a watercolor city",
                                   "--mesh", "1,1,2", "--device", "cpu",
                                   "--output_path", path])
    return out


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

def _jax_models():
    import jax
    import video_styler_tpu.models.wan_dit as JD
    import video_styler_tpu.models.wan_vace as JV
    jcfg, jvcfg = JD.WanDiTConfig(**DIT), JV.VaceConfig(**VACE)
    jp = JD.init_wan_dit(jax.random.PRNGKey(0), jcfg)
    jvp = JV.init_vace(jax.random.PRNGKey(5), jvcfg)
    return jcfg, jp, jvcfg, jvp


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """Both spawns started at once, each in a thread of this process, so
    that the ranks run while the tests compute the JAX side: "mesh4" and
    "mesh2" are futures of the ranks' results, "jax" the JAX pipeline and
    editor whose weights the 2-rank spawn carries."""
    import jax
    import jax.numpy as jnp
    from test_torch_editor import _editors, _keyframes
    from test_torch_pipeline import (DIT as P_DIT, T5, TEXT_LEN, VACE as P_VACE, _frames,
                                     _pipelines)
    from video_styler_tpu_torch.convert import from_jax_params
    from video_styler_tpu_torch.models import wan_dit as TD, wan_vace as TV
    from video_styler_tpu_torch.parallel import run_local
    pool = ThreadPoolExecutor(2)
    _, jp, _, jvp = _jax_models()
    dit = from_jax_params("dit", jax.tree_util.tree_map(np.asarray, jp),
                          TD.WanDiTConfig(**DIT), device="cpu")
    vace = from_jax_params("vace", jax.tree_util.tree_map(np.asarray, jvp),
                           TV.VaceConfig(**VACE), device="cpu")
    store4 = str(tmp_path_factory.mktemp("mesh4") / "store")
    mesh4 = pool.submit(run_local, _mesh4_rank, 4, "gloo", store4, _state(dit), _state(vace),
                        device="cpu", timeout_s=600)
    jpipe, tp = _pipelines(jnp.float32, torch.float32)
    states = {name: _state(m) for name, m in (("dit", tp.dit), ("vace", tp.vace),
                                              ("vae", tp.vae),
                                              ("t5", tp.prompter.text_encoder))}
    configs = dict(dit=P_DIT, vace=P_VACE, t5=T5, text_len=TEXT_LEN,
                   vae=dict(dim=16, z_dim=4, num_res_blocks=1, latent_mean=(0.0,) * 4,
                            latent_std=(1.0,) * 4))
    out_dir = tmp_path_factory.mktemp("mesh2")
    mesh2 = pool.submit(run_local, _mesh2_rank, 2, "gloo", str(out_dir / "store"), states,
                        configs, _frames(), _keyframes(), str(out_dir), device="cpu",
                        timeout_s=600)
    # the editor on its own pipelines: the pipeline runs change shared state
    jedit, _ = _editors(jnp.float32, torch.float32)
    yield dict(mesh4=mesh4, mesh2=mesh2, jax=(jpipe, jedit), out_dir=out_dir)
    pool.shutdown(wait=True)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_process_group_queries_replication_and_mesh_check(spawns):
    mesh4 = spawns["mesh4"].result()
    assert [r["main"] for r in mesh4] == [True, False, False, False]
    assert all(r["bcast"] == {"seed": 7} for r in mesh4)
    assert all(not r["replicated"].any() for r in mesh4)  # rank 0's zeros everywhere
    assert all("needs 2 ranks, the process group has 4" in r["mesh_error"] for r in mesh4)


@pytest.mark.parametrize("name", ["ulysses", "ring"])
def test_sequence_parallel_attention_matches_jax(spawns, name):
    """Ulysses at sp = 4 (4 heads) and the ring at sp = 4 (3 heads, which
    Ulysses cannot split) against the JAX package's on its mesh and its
    sdpa: fp32 at 2e-5; bf16 to the JAX fp32 sdpa within 4 bf16 ULPs of the
    largest magnitude."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import jax
    from video_styler_tpu.ops.attention import sdpa
    from video_styler_tpu.parallel import make_mesh, ulysses_attention
    from video_styler_tpu.parallel.ring import ring_attention
    qkv, ring = _attention_inputs()
    arrays = qkv if name == "ulysses" else ring
    q, k, v = (jnp.asarray(a) for a in arrays)
    want = np.asarray(sdpa(q, k, v))
    if name == "ulysses":
        want_mesh = np.asarray(ulysses_attention(q, k, v, make_mesh(1, 1, 4), axis="sp"))
    else:
        mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
        want_mesh = np.asarray(ring_attention(q, k, v, mesh, axis="sp"))
    for r in spawns["mesh4"].result():
        np.testing.assert_allclose(r[name], want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r[name], want_mesh, rtol=2e-5, atol=2e-5)
        err = np.abs(r[name + "_bf16"] - want).max()
        assert err <= 2.0 ** -6 * np.abs(want).max(), err


@pytest.mark.parametrize("attention", ["ulysses", "ring"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_dit_forward_under_mesh_matches_jax(spawns, grid, attention):
    """The DiT at mesh (1, 2, 2) (FSDP over 2, sp 2), 256 tokens and a
    ragged 45 (padded to 48, the padded keys masked), against the JAX
    forward on one device and under the JAX package's mesh (1, 2, 2), at
    the JAX test's rtol 2e-4 / atol 2e-5."""
    import jax
    import jax.numpy as jnp
    import video_styler_tpu.models.wan_dit as JD
    from video_styler_tpu.parallel import (make_mesh, ShardingContext, use_sharding,
                                           shard_params_fsdp)
    jcfg, jp, _, _ = _jax_models()
    x, t, ctx, _ = (jnp.asarray(a) for a in _dit_inputs(grid))
    want = np.asarray(JD.wan_dit_forward(jp, jcfg, x, t, ctx))
    if attention == "ulysses":
        mesh = make_mesh(dp=1, fsdp=2, sp=2)
        with use_sharding(ShardingContext(mesh)):
            fwd = jax.jit(lambda p, x, t, c: JD.wan_dit_forward(p, jcfg, x, t, c))
            want_mesh = np.asarray(fwd(shard_params_fsdp(jp, mesh), x, t, ctx))
    mesh4 = spawns["mesh4"].result()
    for r in mesh4:
        got = r[f"dit_{grid}_{attention}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    if attention == "ulysses":
        np.testing.assert_allclose(mesh4[0][f"dit_{grid}_ulysses"], want_mesh,
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("attention", ["ulysses", "ring"])
def test_vace_ragged_under_mesh_matches_jax(spawns, attention):
    """The DiT with VACE hints on the ragged 45 tokens at mesh (1, 2, 2)
    against the JAX forward with VACE on one device."""
    import jax.numpy as jnp
    import video_styler_tpu.models.wan_dit as JD
    jcfg, jp, jvcfg, jvp = _jax_models()
    x, t, ctx, vctx = (jnp.asarray(a) for a in _dit_inputs("ragged45"))
    want = np.asarray(JD.wan_dit_forward(jp, jcfg, x, t, ctx, vace_params=jvp,
                                         vace_cfg=jvcfg, vace_context=vctx))
    for r in spawns["mesh4"].result():
        np.testing.assert_allclose(r[f"vace_ragged45_{attention}"], want,
                                   rtol=2e-4, atol=2e-5)


def test_fsdp_share_of_parameter_bytes(spawns):
    """Each rank holds its dim-0 piece of every parameter: at most 1/fsdp
    of the bytes plus one row of each parameter (a piece rounds up)."""
    for r in spawns["mesh4"].result():
        whole, mine = r["param_bytes"]
        assert mine <= whole / 2 + 64 * 1024, (mine, whole)
        assert mine >= whole / 2 - 64 * 1024, (mine, whole)


@pytest.mark.parametrize("case", ["pipeline", "tea_cache", "editor"])
def test_pipelines_under_mesh_match_jax(spawns, case):
    """The tiny VACE pipeline (2 steps, CFG 5), its TeaCache replay (4 steps,
    the residual replayed on steps 1 and 2 with its padded, split rows) and
    the keyframe editor (3 steps, its joint [main | keyframes] sequence and
    RoPE ids) under mesh (1, 1, 2), against the JAX pipelines on one
    device, in fp32 (measured on one device: 1.8e-6, 1.1e-6 and 1.2e-6)."""
    from test_torch_pipeline import REQUEST, _frames
    from test_torch_editor import _keyframes
    import jax.numpy as jnp
    jp, je = spawns["jax"]
    video = _frames()
    if case == "editor":
        want = je(source_video=video, edited_keyframes=_keyframes(), **EDIT)
    else:
        kw = dict(REQUEST, **(TEA if case == "tea_cache" else {}))
        want = jp(vace_video=video, return_latents=True, **kw)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    # the editor's rows of a keyframe equal their source rows in exact
    # arithmetic; on two ranks they pass through row blocks of other sizes
    # and round apart in the last bit, which the reference's correction
    # multiplies by alpha * dt (dt in timestep units: 10 x 500 at the first
    # of 2 steps). Measured: 2.6e-4 at 2 steps, 2.7e-7 at one
    tol = 1e-3 if case == "editor" else 2e-5
    for r in spawns["mesh2"].result():
        assert r[case].shape == want.shape
        assert _rel(r[case], want) < tol, _rel(r[case], want)


def test_infer_ditto_mesh_cli(spawns, tmp_path):
    """`infer_ditto --smoke --mesh 1,1,2 --device cpu` on two ranks: both
    ranks return the same frames, within a bf16 rounding level of the run
    without a mesh, and only rank 0 writes the mp4."""
    from video_styler_tpu_torch import infer_ditto
    single = infer_ditto.main(["--smoke", "--prompt", "a watercolor city", "--device", "cpu",
                               "--output_path", str(tmp_path / "single.mp4")])
    results, out_dir = spawns["mesh2"].result(), spawns["out_dir"]
    assert (out_dir / "rank0.mp4").exists() and not (out_dir / "rank1.mp4").exists()
    np.testing.assert_array_equal(results[0]["cli"], results[1]["cli"])
    diff = np.abs(results[0]["cli"].astype(np.int16) - single.astype(np.int16))
    assert diff.mean() <= 1.0, diff.mean()


def test_animate_and_s2v_refuse_sp(spawns):
    """Animate's hooks and S2V need the whole token grid: under sp > 1
    they raise, naming the ROADMAP item."""
    for r in spawns["mesh2"].result():
        assert len(r["refused"]) == 2
        assert all("not yet under a mesh" in m and "ROADMAP item 8" in m for m in r["refused"])


def test_usp_smoke_under_mesh(spawns):
    """`usp --smoke --sp 2 --device cpu` on two ranks (the T2V-1.3B smoke
    recipe, 5 frames of 32x32, 2 steps, no CFG) against the same recipe in
    one process: bf16 summed in other orders (measured below 1%)."""
    from video_styler_tpu_torch.wan_video_gen import RECIPES, build_smoke_pipeline
    pipe = build_smoke_pipeline(RECIPES["Wan2.1-T2V-1.3B"], device="cpu")
    want = pipe("a cat boxing on a stage", seed=1, height=32, width=32, num_frames=5,
                num_inference_steps=2, cfg_scale=1.0, tiled=False,
                return_latents=True).float().numpy()
    results = spawns["mesh2"].result()
    np.testing.assert_array_equal(results[0]["usp"], results[1]["usp"])
    assert _rel(results[0]["usp"], want) < 2e-2, _rel(results[0]["usp"], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_merge_of_k1_stats_matches_whole_keys(dtype):
    """The card's ring body (K1 with stats on each of 4 key blocks, the
    partial outputs merged in fp32 by their base-2 log-sum-exps), run
    through K1's plain version on the CPU, against K1's plain version over
    all keys: fp32 at 2e-5; bf16 within four bf16 ULPs (the four partials
    are each rounded to bf16)."""
    from video_styler_tpu_torch.ops import flash_attention as fa
    from video_styler_tpu_torch.parallel import ring
    q = torch.from_numpy(_rand(20, (1, 50, 3, 128))).to(dtype)
    k, v = (torch.from_numpy(_rand(21 + i, (1, 120, 3, 128))).to(dtype) for i in range(2))
    state = None
    for i in range(4):
        state = ring.ring_step_kernel(state, q, k[:, 30 * i:30 * (i + 1)],
                                      v[:, 30 * i:30 * (i + 1)], 128 ** -0.5)
    got = ring.ring_finish(state, dtype).float().numpy()
    want = fa.flash_attention_plain(q, k, v).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()
