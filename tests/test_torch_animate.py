"""The Wan2.2-Animate adapter against the JAX package: `upfirdn2d`, the
motion encoder (at face size 64), the face encoder, one face block at the
14B width (5120, 40 heads) and the animate smoke pipeline end to end.

The JAX package has no init for the adapter, so the port draws one
(`init_wan_animate_`, from a torch seed) and its state dict, under the
reference's key names, goes to both converters (the JAX
`convert_wan_animate`, the port's `build_wan_animate`). Widths: the motion
encoder at 64x64 (the reference's channel table: 256 -> 512), the face
encoder's convs 32 wide, 4 motion tokens, pose latents of the z=4 VAE;
the pipeline on the JAX runner's animate smoke pipeline
(`examples/wanvideo/_runner.py`: the I2V config, dim 96, 2 heads of 48, 2
layers, the z=4 VAE, the 257-token CLIP tower) with one face block. Request as the JAX package's own animate test
(`tests/test_animate_parity.py`): 9 frames of 32x32, a 5-frame pose video,
3 face frames. fp32 within 2e-5 relative L2; bf16 within 5%.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import video_styler_tpu.models.wan_animate as JA

import video_styler_tpu_torch.models.wan_animate as TA

from test_torch_fun import REQUEST, _rel, jax_smoke_pipe, port_pipe

from test_torch_pipeline import cpu_share  # noqa: F401

SMALL = TA.AnimateConfig(dim=96, num_face_blocks=1, face_size=64, face_conv_dim=32,
                         pose_in_dim=4)


def _adapter(cfg, head_dim, seed=0, dtype=torch.float32):
    """A random port adapter and its state dict (the reference's names),
    biases and the padding token made non-zero."""
    with torch.device("meta"):
        m = TA.WanAnimateAdapter(cfg, head_dim)
    m = TA.init_wan_animate_(m.to_empty(device="cpu"), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias") or name.endswith("padding_tokens"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    m = m.to(dtype)
    return m, {k: v.clone() for k, v in m.state_dict().items()}


def _jax(sd, dtype=jnp.float32):
    return JA.convert_wan_animate(sd, dtype=dtype)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (2, 1)), (1, 2, (2, 1)), (2, 1, (1, -1))])
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    k = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32)
    k /= k.sum()
    want = np.asarray(JA.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up, down, pad))
    got = TA.upfirdn2d(torch.from_numpy(x), torch.from_numpy(k), up, down, pad).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 2e-5


def test_motion_encoder_matches_jax():
    """`get_motion` at face size 64 on two face crops, fp32: the appearance
    encoder, the equalised-linear head and the QR direction basis (taken on
    the host once and kept)."""
    m, sd = _adapter(SMALL, 48)
    params = _jax(sd)
    img = np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(np.float32)
    want = np.asarray(JA.get_motion(params["motion_encoder"], jnp.asarray(img), size=64))
    with torch.no_grad():
        got = TA.get_motion(m.motion_encoder, torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 512)
    assert _rel(got, want) < 2e-5
    q = m.motion_encoder._q[1]
    assert TA.motion_directions(m.motion_encoder) is q   # kept per weight


def test_face_encoder_matches_jax():
    m, sd = _adapter(SMALL, 48)
    params = _jax(sd)
    x = np.random.default_rng(2).standard_normal((1, 9, 512)).astype(np.float32)
    want = np.asarray(JA.face_encoder(params["face_encoder"], jnp.asarray(x), num_heads=4))
    with torch.no_grad():
        got = TA.face_encoder(m.face_encoder, torch.from_numpy(x), 4).numpy()
    # 9 frames -> 5 -> 3 after the two stride-2 causal convs; 4 tokens + pad
    assert got.shape == want.shape == (1, 3, 5, 96)
    assert _rel(got, want) < 2e-5


def test_face_block_14b_width_matches_jax():
    """One face block at the 14B width (5120, 40 heads of 128) in fp32: 3
    frames of 40 tokens, each attending to its frame's 5 motion tokens."""
    cfg = dataclasses.replace(SMALL, dim=5120)
    with torch.device("meta"):
        m = TA.FaceBlock(5120, 128)
    m = m.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, 1.0 / 5120 ** 0.5, generator=gen)
            else:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    params = _jax(sd)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 3 * 40, cfg.dim)).astype(np.float32)
    mv = rng.standard_normal((1, 3, 5, cfg.dim)).astype(np.float32)
    want = np.asarray(JA.face_block(params, jnp.asarray(x), jnp.asarray(mv), heads_num=40))
    with torch.no_grad():
        got = TA.face_block(m, torch.from_numpy(x), torch.from_numpy(mv), 40).numpy()
    assert got.shape == want.shape == (1, 120, 5120)
    assert _rel(got, want) < 2e-5


def _frames(rng, n, hw):
    return [Image.fromarray(rng.integers(0, 255, (hw, hw, 3), np.uint8)) for _ in range(n)]


_PIPES = {}


def _animate_pipes(dtype):
    """The JAX runner's Animate smoke pipeline and the port's, the same
    small adapter on both (kept per dtype: the fp32 cases share them)."""
    if dtype not in _PIPES:
        jp = jax_smoke_pipe("Wan2.2-Animate-14B", dtype)
        tp = port_pipe(jp, dtype)
        _, sd = _adapter(SMALL, 48, dtype=tp.dtype)
        jp.animate_params = _jax(sd, jp.dtype)
        jp.animate_face_size = SMALL.face_size
        tp.animate = TA.build_wan_animate(sd, torch.device("cpu"), tp.dtype)
        _PIPES.clear()
        _PIPES[dtype] = jp, tp
    return _PIPES[dtype]


@pytest.mark.parametrize("case", ["fp32", "fp32-cfg_merge", "bf16"])
def test_animate_pipeline_matches_jax(case, monkeypatch):
    """The Wan2.2-Animate smoke pipeline with an input image, a 5-frame pose
    video (2 latent frames: frames 1.. of 3) and 3 face frames at 64x64,
    CFG 5 (two-pass, or merged), 2 steps, against the JAX pipeline on the
    same weights; the adapter changes the result."""
    dtype = "bf16" if case == "bf16" else "fp32"
    jp, tp = _animate_pipes(dtype)
    td = tp.dtype
    orig = JA.animate_after_patch_embedding
    monkeypatch.setattr(JA, "animate_after_patch_embedding",
                        lambda p, x, pose, face: orig(p, x, pose, face, size=SMALL.face_size))
    rng = np.random.default_rng(0)
    kw = dict(REQUEST, input_image=_frames(rng, 1, 32)[0],
              animate_pose_video=_frames(rng, 5, 32), animate_face_video=_frames(rng, 3, 64),
              cfg_merge=case.endswith("cfg_merge"))
    want = np.asarray(jnp.asarray(jp(**kw), jnp.float32))
    got = tp(**kw)
    assert got.shape == want.shape == (1, 4, 3, 4, 4) and got.dtype == td
    assert _rel(got.float().numpy(), want) < (5e-2 if dtype == "bf16" else 2e-5)
    assert "vae_encode_pose" in dict(tp.stage_times)
    if case == "fp32":
        animate, tp.animate = tp.animate, None
        plain = tp(**kw)
        tp.animate = animate
        assert _rel(plain.numpy(), got.numpy()) > 1e-3


def test_animate_tea_cache_replay_matches_jax(monkeypatch):
    """TeaCache on the Animate pipeline, 4 steps at a threshold that replays
    the cached residual on the two middle steps of each CFG branch: the
    replay (the JAX pipeline's `skip`) takes neither the pose tokens nor the
    face blocks, and the port mirrors it, so the run matches JAX; a replay
    happened, and the run differs from the one without TeaCache."""
    jp, tp = _animate_pipes("fp32")
    orig = JA.animate_after_patch_embedding
    monkeypatch.setattr(JA, "animate_after_patch_embedding",
                        lambda p, x, pose, face: orig(p, x, pose, face, size=SMALL.face_size))
    replays = []
    skip = tp._skip
    monkeypatch.setattr(tp, "_skip", lambda *a, **kw: replays.append(1) or skip(*a, **kw))
    rng = np.random.default_rng(0)
    kw = dict(REQUEST, input_image=_frames(rng, 1, 32)[0],
              animate_pose_video=_frames(rng, 5, 32), animate_face_video=_frames(rng, 3, 64),
              num_inference_steps=4)
    tea = dict(tea_cache_l1_thresh=10.0, tea_cache_model_id="Wan2.1-T2V-1.3B")
    want = np.asarray(jnp.asarray(jp(**kw, **tea), jnp.float32))
    got = tp(**kw, **tea)
    assert len(replays) == 4
    assert got.shape == want.shape == (1, 4, 3, 4, 4)
    assert _rel(got.numpy(), want) < 2e-5
    assert _rel(tp(**kw).numpy(), got.numpy()) > 1e-3
