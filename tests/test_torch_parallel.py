"""The port's multi-GPU path (`video_styler_tpu_torch/parallel/`) against
the JAX package's, on the CPU: Ulysses, the ring, the halo exchange, the
DiT and VACE under a (dp, fsdp, sp) mesh, FSDP2's share of the bytes, the
VACE pipeline with TeaCache, the keyframe editor, the width-sharded Wan2.1
and Wan2.2 VAEs, Animate and S2V under sp, the quantised pipeline under
fsdp and `infer_ditto --mesh` (with `--quantize`).

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
pipelines; the Animate and S2V pipelines of `test_torch_animate` and
`test_torch_s2v`; the VAEs at `tests/test_vae_streaming.py`'s shapes.
fp32 holds to rtol 2e-5 unless stated, as the JAX tests do; the one bf16
case to a few bf16 ULPs.
"""
import copy
import multiprocessing
import os
import warnings
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
        halo_exchange_w, process_index, replicate_params, ring_attention, shard_params_fsdp,
        split_seq, split_w, ulysses_attention, use_sharding)
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
        x = split_w(torch.from_numpy(_rand(30, (1, 2, 3, 4, 16))))
        out["halo"] = [halo_exchange_w(x, left, right).numpy()
                       for left, right in ((1, 1), (0, 1), (2, 3))]
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


def _mesh2_rank(states, configs, video, keyframes, out_dir, extra):
    """The pipeline, its TeaCache replay and the editor under (1, 1, 2);
    the width-sharded VAEs; Animate and S2V under (1, 1, 2); the quantised
    pipeline under (1, 2, 1); then `infer_ditto --smoke --mesh 1,1,2` and
    `--mesh 1,2,1 --quantize int8`."""
    torch.set_num_threads(1)
    from video_styler_tpu_torch import infer_ditto
    from video_styler_tpu_torch.models import t5 as TT, wan_dit as TD, wan_vace as TV, \
        wan_vae as TVAE
    from video_styler_tpu_torch.ops.quant import QuantLinear
    from video_styler_tpu_torch.parallel import (ShardingContext, drop_count, make_mesh,
                                                 process_index, reset_drop_count, use_sharding)
    from video_styler_tpu_torch.parallel.fsdp import local_bytes
    from video_styler_tpu_torch.pipelines.wan_video import WanVideoPipeline
    from video_styler_tpu_torch.pipelines.wan_video_editor import WanVideoEditorPipeline
    from video_styler_tpu_torch.prompters.wan_prompter import StubTokenizer, WanPrompter
    sp2 = ShardingContext(make_mesh(1, 1, 2, device_type="cpu"))

    def pipe(cls, ctx=sp2):
        p = cls(device="cpu", dtype=torch.float32)
        p.dit = _load(TD.WanDiT, TD.WanDiTConfig(**configs["dit"]), states["dit"])
        p.vace = _load(TV.WanVace, TV.VaceConfig(**configs["vace"]), states["vace"])
        p.vae = _load(TVAE.WanVAE, TVAE.WanVAEConfig(**configs["vae"]), states["vae"])
        t5 = _load(TT.T5Encoder, TT.T5Config(**configs["t5"]), states["t5"])
        p.prompter = WanPrompter(StubTokenizer(configs["text_len"]), configs["text_len"], t5)
        p.sharding_ctx = ctx
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

    # the VAEs: width-sharded at sp = 2 and whole, encode and decode
    vaes = {"21": tp.vae, "38": _load(TVAE.WanVAE38, TVAE.WanVAE38Config(**VAE38),
                                     extra["vae38"])}
    clip = torch.from_numpy(extra["vae_video"])
    with torch.no_grad():
        for tag, vae in vaes.items():
            for mode, tiled in (("whole", False), ("stream", True)):
                for ctx in (sp2, None):
                    with use_sharding(ctx):
                        lat = TVAE.encode(vae, clip, tiled=tiled)
                        dec = TVAE.decode(vae, lat, tiled=tiled, streaming=tiled)
                    key = f"vae{tag}_{mode}" + ("" if ctx is None else "_sp")
                    out[key] = (lat.numpy(), dec.numpy())
        reset_drop_count()
        with use_sharding(sp2), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ragged = [TVAE.encode(vaes["21"], clip[..., :40]).numpy() for _ in range(2)]
        out["vae_ragged"] = (ragged[0], TVAE.encode(vaes["21"], clip[..., :40]).numpy(),
                             drop_count(), [str(w.message) for w in caught])

    # Animate and S2V under (1, 1, 2), and in this process with no mesh
    for name, call in (("animate", "__call__"), ("s2v", "s2v")):
        p, kw = extra[name]
        p.sharding_ctx = sp2
        out[name] = getattr(p, call)(**kw).numpy()
        p.sharding_ctx = None
        out[name + "_one"] = getattr(p, call)(**kw).numpy()

    # the DiT in each quantised mode, quantised then sharded over fsdp = 2,
    # sharded then quantised, and whole
    from video_styler_tpu_torch.ops.quant import quantize_params
    from video_styler_tpu_torch.parallel import shard_params_fsdp
    fsdp2 = make_mesh(1, 2, 1, device_type="cpu")
    x, t, ctx, _ = (torch.from_numpy(a) for a in _dit_inputs("256"))
    out["quant_modes"] = {}
    with torch.no_grad():
        for mode in ("int8", "fp8", "int4", "int4_g64"):
            def dit():
                return _load(TD.WanDiT, TD.WanDiTConfig(**DIT), extra["dit"])
            runs = [quantize_params(dit(), mode), shard_params_fsdp(
                quantize_params(dit(), mode), fsdp2), quantize_params(
                shard_params_fsdp(dit(), fsdp2), mode)]
            with use_sharding(ShardingContext(fsdp2)):
                out["quant_modes"][mode] = [TD.wan_dit_forward(m, x, t, ctx).numpy()
                                            for m in runs]

    # quantised, then sharded over fsdp = 2
    tq = pipe(WanVideoPipeline, ShardingContext(make_mesh(1, 2, 1, device_type="cpu")))
    tq.quantize("int8")
    tq.shard(tq.sharding_ctx.mesh)
    out["quantized_fsdp"] = tq(vace_video=video, return_latents=True,
                               **SMOKE_REQUEST).numpy()

    path = os.path.join(out_dir, f"rank{process_index()}.mp4")
    out["cli"] = infer_ditto.main(["--smoke", "--prompt", "a watercolor city",
                                   "--mesh", "1,1,2", "--device", "cpu",
                                   "--output_path", path])
    qpath = os.path.join(out_dir, f"quant_rank{process_index()}.mp4")
    sizes = {}
    build = infer_ditto.build_smoke_pipeline

    def spy(*args, **kwargs):
        p = build(*args, **kwargs)
        shard = p.shard

        def int8_bytes():       # the storage held, not the view's size
            return sum(m.w_q.untyped_storage().nbytes() for m in p.dit.blocks.modules()
                       if isinstance(m, QuantLinear) and m.w_q.dtype == torch.int8)

        def shard_and_count(mesh, **kw):
            whole = int8_bytes(), local_bytes(p.dit.blocks)
            shard(mesh, **kw)
            sizes["int8_blocks"] = whole + (int8_bytes(), local_bytes(p.dit.blocks))
            return p
        p.shard = shard_and_count
        return p
    infer_ditto.build_smoke_pipeline = spy
    try:
        out["cli_quant"] = infer_ditto.main(["--smoke", "--prompt", "a watercolor city",
                                             "--mesh", "1,2,1", "--quantize", "int8",
                                             "--device", "cpu", "--output_path", qpath])
    finally:
        infer_ditto.build_smoke_pipeline = build
    out["cli_quant_bytes"] = sizes["int8_blocks"]
    return out


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

# the Wan2.2 VAE of `tests/test_torch_vae38.py` (the JAX tests' config)
VAE38 = dict(dim=16, dec_dim=16, z_dim=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
             temperal_downsample=(False, True, True), latent_mean=(0.0,) * 8,
             latent_std=(1.0,) * 8)


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
    from test_torch_vae38 import random_vae38
    from video_styler_tpu_torch.models.wan_vae import WanVAE38Config
    vae38 = random_vae38(WanVAE38Config(**VAE38))
    extra = dict(vae38=_state(vae38), vae_video=_rand(40, (1, 3, 9, 32, 64)),
                 animate=_animate_request(), s2v=_s2v_request(), dit=_state(dit))
    mesh2 = pool.submit(run_local, _mesh2_rank, 2, "gloo", str(out_dir / "store"), states,
                        configs, _frames(), _keyframes(), str(out_dir), extra, device="cpu",
                        timeout_s=600)
    # the JAX references of the later cases, each in a thread of its own
    # while the ranks and the tests below run (every JAX pipeline here is
    # built before they start: building one patches a JAX module)
    jax_animate = _jax_smoke_animate()
    jax_quantized = copy.copy(jpipe)        # the same weights, traced anew
    jax_quantized._jit_cache = {}
    refs = ThreadPoolExecutor(4)
    jax_refs = {f"vae{tag}_{mode}": refs.submit(_jax_vae, tag, mode, extra["vae_video"],
                                                vae38)
                for tag in ("21", "38") for mode in ("whole", "stream")}
    jax_refs.update(animate=refs.submit(_jax_animate, jax_animate), s2v=refs.submit(_jax_s2v),
                    quantized=refs.submit(_jax_quantized, jax_quantized))
    # the editor on its own pipelines: the pipeline runs change shared state
    jedit, _ = _editors(jnp.float32, torch.float32)
    yield dict(mesh4=mesh4, mesh2=mesh2, jax=(jpipe, jedit), out_dir=out_dir,
               jax_refs=jax_refs)
    refs.shutdown(wait=True)
    pool.shutdown(wait=True)


def _animate_kwargs():
    """The Animate request (`test_torch_animate`'s): an input image, a
    5-frame pose video, 3 face frames of 64x64, CFG 5, 2 steps."""
    from test_torch_animate import _frames as _animate_frames
    from test_torch_fun import REQUEST as FUN_REQUEST
    rng = np.random.default_rng(0)
    return dict(FUN_REQUEST, input_image=_animate_frames(rng, 1, 32)[0],
                animate_pose_video=_animate_frames(rng, 5, 32),
                animate_face_video=_animate_frames(rng, 3, 64))


def _animate_request():
    """A copy of `test_torch_animate`'s fp32 port pipeline (the JAX runner's
    Animate smoke pipeline, one face block) and its request. A copy:
    spawn's pickler moves a tensor's storage into shared memory, and the
    JAX pipeline's arrays may alias the original's."""
    from test_torch_animate import _animate_pipes
    return copy.deepcopy(_animate_pipes("fp32")[1]), _animate_kwargs()


def _s2v_request():
    """A copy of `test_torch_s2v`'s port pipeline (as `_animate_request`)
    and its 12-frame request with a pose video (two-pass CFG 4.5, 2 steps,
    fp32)."""
    from test_torch_s2v import _pipes, _request
    return copy.deepcopy(_pipes()[1]), _request(12, pose=True)


# the quantised pipelines' relative distance (see the test)
QUANT_TOL = 2e-2


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
    the keyframe editor (2 steps, its joint [main | keyframes] sequence and
    RoPE ids) under mesh (1, 1, 2), the VAE stages width-sharded, against
    the JAX pipelines on one device, in fp32 (measured: 1.3e-6, 9.9e-7 and
    1.55e-6)."""
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
    # the editor's keyframe rows equal their source rows in exact
    # arithmetic, and the reference's correction multiplies their last-bit
    # differences by alpha * dt (10 x 500 at the first of 2 steps). Its
    # ranks hold whole shares of 8 rows (`wan_dit.SHARD_ROWS`), so each row
    # is summed as in one process: bit-equal to one process at one thread a
    # rank, 1.55e-6 from JAX (measured)
    for r in spawns["mesh2"].result():
        assert r[case].shape == want.shape
        assert _rel(r[case], want) < 2e-5, _rel(r[case], want)


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


def test_halo_exchange_w(spawns):
    """`halo_exchange_w` at sp = 4 on 16 columns: each rank's share with
    the neighbours' edge columns, zeros past the frame's edges."""
    x = _rand(30, (1, 2, 3, 4, 16))
    for rank, r in enumerate(spawns["mesh4"].result()):
        for (left, right), got in zip(((1, 1), (0, 1), (2, 3)), r["halo"]):
            padded = np.pad(x, [(0, 0)] * 4 + [(left, right)])
            want = padded[..., 4 * rank:4 * rank + 4 + left + right]
            np.testing.assert_array_equal(got, want)


def _jax_vae(tag, mode, video, vae38):
    """The JAX package's VAE (encode, then decode) on `video` under its mesh
    (1, 1, 2): `tests/test_vae_streaming.py:97`'s run; the whole-clip
    functions jitted under the context, so that they trace width-sharded.
    The Wan2.1 VAE's weights are the pipelines' (`_jax_vae_params`), the
    Wan2.2 VAE's the port's `vae38` through the JAX converter."""
    import jax
    import jax.numpy as jnp
    import video_styler_tpu.models.wan_vae as JVAE
    from video_styler_tpu.parallel import ShardingContext, make_mesh, use_sharding
    from video_styler_tpu_torch.utils.convert import export_wan_vae
    if tag == "21":
        from test_torch_pipeline import _jax_vae_params
        cfg, params = JVAE.WAN_VAE_TINY, _jax_vae_params()
    else:
        cfg = JVAE.WanVAE38Config(**VAE38)
        params = JVAE.convert_wan_vae({k: v.numpy() for k, v in export_wan_vae(vae38).items()},
                                      dtype=jnp.float32)
    with use_sharding(ShardingContext(make_mesh(1, 1, 2))):
        if mode == "stream":
            lat = JVAE.encode(params, jnp.asarray(video), cfg, tiled=True)
            dec = JVAE.decode(params, lat.astype(jnp.float32), cfg, tiled=True)
        else:
            lat = jax.jit(lambda p, v: JVAE.encode(p, v, cfg, tiled=False))(
                params, jnp.asarray(video))
            dec = jax.jit(lambda p, z: JVAE.decode(p, z, cfg, tiled=False))(params, lat)
    return np.asarray(lat, np.float32), np.asarray(dec, np.float32)


def _jax_smoke_animate():
    """`test_torch_animate`'s JAX Animate pipeline, its traces dropped so
    that it traces afresh under the mesh."""
    from test_torch_animate import _animate_pipes
    jp, _ = _animate_pipes("fp32")
    jp._jit_cache.clear()
    return jp


def _jax_animate(jp):
    """The JAX Animate pipeline under its mesh (1, 1, 2) on `_animate_kwargs`
    (its face encoder at the test's face size, as `test_torch_animate`
    runs it)."""
    import jax.numpy as jnp
    import video_styler_tpu.models.wan_animate as JA
    from video_styler_tpu.parallel import ShardingContext, make_mesh, use_sharding
    from test_torch_animate import SMALL
    orig = JA.animate_after_patch_embedding
    JA.animate_after_patch_embedding = lambda p, x, pose, face: orig(
        p, x, pose, face, size=SMALL.face_size)
    try:
        with use_sharding(ShardingContext(make_mesh(1, 1, 2))):
            return np.asarray(jnp.asarray(jp(**_animate_kwargs()), jnp.float32))
    finally:
        JA.animate_after_patch_embedding = orig
        jp._jit_cache.clear()


def _jax_s2v():
    """The JAX pipeline's `s2v` on `_s2v_request`'s request (one device: the
    JAX pipeline runs S2V unsharded under any mesh)."""
    import jax.numpy as jnp
    from test_torch_s2v import _pipes, _request
    return np.asarray(jnp.asarray(_pipes()[0].s2v(**_request(12, pose=True)), jnp.float32))


def _jax_quantized(jp):
    """The JAX VACE pipeline quantised to int8, its trees sharded by
    `shard_params_fsdp` over its mesh (1, 2, 1), on the pipeline request."""
    import jax.numpy as jnp
    from test_torch_pipeline import REQUEST, _frames
    from video_styler_tpu.parallel import (ShardingContext, make_mesh, shard_params_fsdp,
                                           use_sharding)
    jp.quantize("int8")
    mesh = make_mesh(1, 2, 1)
    jp.dit_params = shard_params_fsdp(jp.dit_params, mesh)
    jp.vace_params = shard_params_fsdp(jp.vace_params, mesh)
    with use_sharding(ShardingContext(mesh)):
        return np.asarray(jnp.asarray(jp(vace_video=_frames(), return_latents=True,
                                         **REQUEST), jnp.float32))


@pytest.mark.parametrize("tag,mode", [("21", "whole"), ("21", "stream"), ("38", "whole"),
                                      ("38", "stream")])
def test_vae_width_sharded_matches_unsharded_and_jax(spawns, tag, mode):
    """The Wan2.1 and Wan2.2 VAEs, encode then decode of 9 frames of 32x64,
    split on the width over sp = 2 (shares of 32 columns; 4 and 2 latent
    columns), against the same VAE whole in the rank and against the JAX
    package's under its mesh (1, 1, 2), at `tests/test_vae_streaming.py`'s
    bounds: rtol 1e-4 / atol 1e-5 whole, 1e-3 streamed (the Wan2.2 VAE has
    no JAX sharded test; it is held to the same bounds). Both ranks hold
    the same gathered output."""
    want = spawns["jax_refs"][f"vae{tag}_{mode}"].result()
    tol = dict(rtol=1e-4, atol=1e-5) if mode == "whole" else dict(rtol=1e-3, atol=1e-3)
    results = spawns["mesh2"].result()
    for r in results:
        got, whole = r[f"vae{tag}_{mode}_sp"], r[f"vae{tag}_{mode}"]
        for g, w, j in zip(got, whole, want):
            assert g.shape == w.shape == j.shape
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g, j, **tol)
    for a, b in zip(results[0][f"vae{tag}_{mode}_sp"], results[1][f"vae{tag}_{mode}_sp"]):
        np.testing.assert_array_equal(a, b)


def test_vae_width_that_does_not_split_runs_whole(spawns):
    """A 40-column clip does not split over sp = 2 into shares of whole
    8-column multiples (the encoder's three stride-2 stages): it runs whole
    on each rank, equal to the run without a mesh, warned once per shape
    and counted per run, as JAX's `constrain` drops a sharding."""
    for r in spawns["mesh2"].result():
        sharded, whole, count, messages = r["vae_ragged"]
        np.testing.assert_array_equal(sharded, whole)
        assert count == 2
        assert len(messages) == 1 and "width 40 does not split over sp=2" in messages[0]


def test_animate_under_mesh_matches_jax(spawns):
    """The Animate smoke pipeline (`test_torch_animate`'s: the pose tokens,
    a face block after layer 0, CFG 5, 2 steps) under (1, 1, 2): its 48
    tokens split over 2 ranks, the face block on the gathered rows; against
    the JAX pipeline under its mesh (1, 1, 2) and against one process, fp32
    within 2e-5."""
    want = spawns["jax_refs"]["animate"].result()
    for r in spawns["mesh2"].result():
        assert r["animate"].shape == want.shape == (1, 4, 3, 4, 4)
        assert _rel(r["animate"], want) < 2e-5, _rel(r["animate"], want)
        assert _rel(r["animate"], r["animate_one"]) < 2e-5


def test_s2v_under_mesh_matches_one_process_and_jax(spawns):
    """`s2v` under (1, 1, 2), 12 frames with a pose video: every rank runs
    the S2V model whole with no sequence context, as the JAX pipeline does,
    the reference and pose encodes width-sharded; bit-equal to one process
    and within 2e-5 of the JAX pipeline's `s2v`."""
    want = spawns["jax_refs"]["s2v"].result()
    for r in spawns["mesh2"].result():
        np.testing.assert_array_equal(r["s2v"], r["s2v_one"])
        assert r["s2v"].shape == want.shape
        assert _rel(r["s2v"], want) < 2e-5, _rel(r["s2v"], want)


def test_quantized_pipeline_under_fsdp_matches_jax(spawns):
    """The tiny VACE pipeline quantised to int8 (w8a8 linears), then
    sharded over fsdp = 2 (each rank gathers a block's int8 pieces), against
    the JAX pipeline quantised the same way under its mesh (1, 2, 1), its
    trees sharded by `shard_params_fsdp`. Both sides quantise the same fp32
    weights to the same integers; activations quantised per call round
    apart on a few rows (measured: 0 between the port's ranks)."""
    want = spawns["jax_refs"]["quantized"].result()
    results = spawns["mesh2"].result()
    np.testing.assert_array_equal(results[0]["quantized_fsdp"], results[1]["quantized_fsdp"])
    assert _rel(results[0]["quantized_fsdp"], want) < QUANT_TOL, \
        _rel(results[0]["quantized_fsdp"], want)


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4", "int4_g64"])
def test_quantized_dit_sharded_in_either_order(spawns, mode):
    """The JAX sharded tests' DiT (4 heads of 48) in each quantised mode
    (group scales of 64 rows: its 192-wide inputs take no group of 128)
    over fsdp = 2: quantised then sharded, and sharded then quantised (each
    rank quantising its own rows), both bit-equal to the whole quantised
    DiT; each rank gathers the same pieces."""
    for r in spawns["mesh2"].result():
        whole, then_shard, then_quantize = r["quant_modes"][mode]
        np.testing.assert_array_equal(then_shard, whole)
        np.testing.assert_array_equal(then_quantize, whole)


def test_infer_ditto_quantize_fsdp_cli(spawns, tmp_path):
    """`infer_ditto --smoke --mesh 1,2,1 --quantize int8 --device cpu` on
    two ranks: both ranks return the same frames, within a bf16 rounding
    level of the quantised run without a mesh; each rank holds half of the
    int8 block weights (and about half of the blocks' bytes)."""
    from video_styler_tpu_torch import infer_ditto
    single = infer_ditto.main(["--smoke", "--prompt", "a watercolor city", "--device", "cpu",
                               "--quantize", "int8",
                               "--output_path", str(tmp_path / "single.mp4")])
    results, out_dir = spawns["mesh2"].result(), spawns["out_dir"]
    assert (out_dir / "quant_rank0.mp4").exists()
    assert not (out_dir / "quant_rank1.mp4").exists()
    np.testing.assert_array_equal(results[0]["cli_quant"], results[1]["cli_quant"])
    diff = np.abs(results[0]["cli_quant"].astype(np.int16) - single.astype(np.int16))
    assert diff.mean() <= 1.0, diff.mean()
    for r in results:
        int8_whole, whole, int8_mine, mine = r["cli_quant_bytes"]
        assert int8_whole > 0 and int8_mine == int8_whole // 2
        assert abs(mine - whole / 2) <= 0.01 * whole, (mine, whole)


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
