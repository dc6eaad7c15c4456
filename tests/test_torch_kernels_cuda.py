"""The port's hand-written CUDA kernels (K1 with and without stats, K2, K3,
K4, K5, K6, K7, K8, and FastBlend's F1-F3) against their plain versions,
at the widths and token counts of the paths that run them, and the
quantized linears' library GEMMs against the CPU's exact products, on the
card. They skip on a host without a GPU; on the card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest` because the suite's conftest imports JAX, which the card's
machine does not have; this file imports only torch and the port).

Tolerance: two bf16 ULPs at the output's largest magnitude. The kernel and
the plain version round at the same points; exp2 and rsqrt differ in their
last fp32 bits, which can move one bf16 rounding by one ULP. F1-F3 are
fp32 and sum in their plain versions' order: 2^-20 of the largest
magnitude.
"""
import pytest
import torch

from video_styler_tpu_torch.ops import flash_attention as fa
from video_styler_tpu_torch.ops import fused_norm_rope as fnr
from video_styler_tpu_torch.ops.attention import attention
from video_styler_tpu_torch.ops.rope import assemble_freqs_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.Generator("cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _assert_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    tol = 2.0 ** -7 * want.float().abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("b,sq,sk,n,mag", [(1, 64, 64, 1, 1.0), (2, 200, 333, 3, 1.0),
                                           (1, 1000, 512, 4, 1.0), (1, 300, 257, 2, 24.0)])
def test_k1_matches_plain(gen, b, sq, sk, n, mag):
    q = _randn(gen, b, sq, n, 128, scale=mag)
    k, v = _randn(gen, b, sk, n, 128), _randn(gen, b, sk, n, 128)
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    _assert_close(out, fa.flash_attention_plain(q, k, v))


def test_k1_reads_strided_views(gen):
    """(B, S, N*D) projections viewed as (B, S, N, D), and the kv_valid
    slice: no copy, the kernel reads through the strides."""
    x = _randn(gen, 1, 130, 3 * 2 * 128)
    q, k, v = x.view(1, 130, 6, 128).split(2, dim=2)
    out = attention(q, k, v, kv_valid=97)
    _assert_close(out, fa.flash_attention_plain(q, k[:, :97], v[:, :97]))


def test_k1_rejects_what_it_does_not_take(gen):
    q = _randn(gen, 1, 16, 2, 128)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        small = _randn(gen, 1, 16, 2, 64)
        fa.flash_attention(small, small, small)


@pytest.mark.parametrize("s,n", [(231, 2), (1560, 40)])
def test_k4_k5_match_plain(gen, s, n):
    f, h, w = {231: (3, 7, 11), 1560: (1, 30, 52)}[s]
    xq, xk = _randn(gen, 2, s, n * 128), _randn(gen, 2, s, n * 128, scale=0.7)
    wq = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    wk = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    cos, sin = assemble_freqs_grid(128, f, h, w, device="cuda")
    before = (fnr.ROPE_KERNEL.launches, fnr.RMS_KERNEL.launches)
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    o5 = fnr.fused_rmsnorm(xq, wq)
    torch.cuda.synchronize()
    assert (fnr.ROPE_KERNEL.launches, fnr.RMS_KERNEL.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    _assert_close(oq, pq)
    _assert_close(ok, pk)
    _assert_close(o5, fnr.fused_rmsnorm_plain(xq, wq))


def test_k4_editor_rope_ids(gen):
    """K4 on the editor's joint [main | keyframes] sequence at 480x832, 9
    frames, keyframes at pixel frames 0 and 8: 3 + 2 latent frames, 7,800
    tokens (not a multiple of 128), temporal rope ids 0, 1, 2, 0, 2 (the
    keyframe tokens repeat their source frames' rotations)."""
    rope_ids = [0, 1, 2, 0, 2]
    s, n = 5 * 30 * 52, 40
    xq, xk = _randn(gen, 1, s, n * 128), _randn(gen, 1, s, n * 128, scale=0.7)
    wq = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    wk = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    cos, sin = assemble_freqs_grid(128, 5, 30, 52, rope_ids, device="cuda")
    assert cos.shape == (7800, 64)
    torch.testing.assert_close(cos[3 * 1560:4 * 1560], cos[:1560], rtol=0, atol=0)
    before = fnr.ROPE_KERNEL.launches
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    torch.cuda.synchronize()
    assert fnr.ROPE_KERNEL.launches == before + 1
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    _assert_close(oq, pq)
    _assert_close(ok, pk)


@pytest.mark.parametrize("sq,sk", [(4680, 257), (4680, 769), (32760, 257), (32760, 769)])
def test_k1_image_cross_lengths(gen, sq, sk):
    """K1 on the I2V path's cross-attention: 257 CLIP rows (the image
    branch) and FLF2V's 769-row text branch (512 text + the end image's 257
    CLIP rows), key tails that are not a multiple of 128, at the 9-frame and
    the 81-frame (32,760-token) 480x832 query rows, 40 heads; the image
    branch's keys are a slice of a (B, 514, D) context, read through its
    strides."""
    q = _randn(gen, 1, sq, 40, 128)
    ctx = _randn(gen, 1, max(sk, 514), 40, 128)
    k, v = ctx[:, :sk], _randn(gen, 1, sk, 40, 128)
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    rows = torch.cat([torch.arange(0, 1024), torch.arange(sq - 1024, sq)]).cuda()
    _assert_close(out[:, rows], fa.flash_attention_plain(q[:, rows], k, v))


@pytest.mark.parametrize("sq", [4096, 4608])
@pytest.mark.parametrize("sk", [128, 256])
def test_k1_flux_ipadapter_cross(gen, sq, sk):
    """K1 on the FLUX IP-Adapter's cross-attention: the joint blocks'
    4,096 image rows and the single blocks' 4,608 [text | image] rows, 24
    heads, against one picture's 128 keys (one key tile) or two pictures'
    256; the keys and values are one block's slice of the (57, 1, T, N, D)
    stacks."""
    q = _randn(gen, 1, sq, 24, 128)
    ks, vs = _randn(gen, 3, 1, sk, 24, 128), _randn(gen, 3, 1, sk, 24, 128)
    k, v = ks[1], vs[1]
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    rows = torch.cat([torch.arange(0, 1024), torch.arange(sq - 1024, sq)]).cuda()
    _assert_close(out[:, rows], fa.flash_attention_plain(q[:, rows], k, v))


@pytest.mark.parametrize("s", [4609, 4105, 4612, 8704])
def test_k1_flux_adapter_self_lengths(gen, s):
    """K1 at the FLUX adapters' self-attention lengths, 24 heads, v a chunk
    of the single blocks' fused qkv: the union ControlNet's 4,609 (its mode
    token ahead of 512 text and 4,096 image tokens), InfiniteYou's 4,105 (8
    id tokens and the mode token in place of the text), the value
    encoder's 4,612 (4 tokens after the text) and Kontext's 8,704 (a
    reference image's 4,096 tokens after the image)."""
    q, k = _randn(gen, 1, s, 24, 128), _randn(gen, 1, s, 24, 128)
    v = _randn(gen, 1, s, 72, 128).chunk(3, dim=2)[2]
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    rows = torch.cat([torch.arange(0, 1024), torch.arange(s - 1024, s)]).cuda()
    _assert_close(out[:, rows], fa.flash_attention_plain(q[:, rows], k, v))


def test_k1_k4_k5_ti2v_width(gen):
    """TI2V-5B's width: 24 heads of 128 (Dm 3072: 12 chunks of 16 bytes a
    lane, K5's 16-chunk instantiation) over its 5,070 tokens (13 x 15 x 26,
    not a multiple of 128): K4 on q and k, K5, and K1 self and cross."""
    f, h, w, n = 13, 15, 26, 24
    s = f * h * w
    xq, xk = _randn(gen, 1, s, n * 128), _randn(gen, 1, s, n * 128, scale=0.7)
    wq = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    wk = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    cos, sin = assemble_freqs_grid(128, f, h, w, device="cuda")
    before = (fnr.ROPE_KERNEL.launches, fnr.RMS_KERNEL.launches, fa.KERNEL.launches)
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    o5 = fnr.fused_rmsnorm(xq, wq)
    v = _randn(gen, 1, s, n, 128)
    o1 = fa.flash_attention(oq, ok, v)
    ctx = _randn(gen, 1, 512, n, 128)
    o1x = fa.flash_attention(oq, ctx, ctx)
    torch.cuda.synchronize()
    assert (fnr.ROPE_KERNEL.launches, fnr.RMS_KERNEL.launches, fa.KERNEL.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    _assert_close(oq, pq)
    _assert_close(ok, pk)
    _assert_close(o5, fnr.fused_rmsnorm_plain(xq, wq))
    rows = torch.cat([torch.arange(0, 1024), torch.arange(s - 1024, s)]).cuda()
    _assert_close(o1[:, rows], fa.flash_attention_plain(oq[:, rows], ok, v))
    _assert_close(o1x[:, rows], fa.flash_attention_plain(oq[:, rows], ctx, ctx))


def test_k4_k1_fun_reference_frame(gen):
    """The Fun V1.1 reference frame at 480x832, 9 frames: 3 latent frames
    and the reference's one in front, 4 x 1,560 = 6,240 tokens with RoPE
    rows over f + 1 = 4 frames (the reference at temporal index 0): K4 on
    q and k, then K1 self-attention over all 6,240, 40 heads."""
    s, n = 4 * 30 * 52, 40
    xq, xk = _randn(gen, 1, s, n * 128), _randn(gen, 1, s, n * 128, scale=0.7)
    wq = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    wk = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    cos, sin = assemble_freqs_grid(128, 4, 30, 52, device="cuda")
    assert cos.shape == (6240, 64)
    v = _randn(gen, 1, s, n, 128)
    before = (fnr.ROPE_KERNEL.launches, fa.KERNEL.launches)
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    out = fa.flash_attention(oq, ok, v)
    torch.cuda.synchronize()
    assert (fnr.ROPE_KERNEL.launches, fa.KERNEL.launches) == (before[0] + 1, before[1] + 1)
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    _assert_close(oq, pq)
    _assert_close(ok, pk)
    rows = torch.cat([torch.arange(0, 1024), torch.arange(s - 1024, s)]).cuda()
    _assert_close(out[:, rows], fa.flash_attention_plain(oq[:, rows], ok, v))


def test_k1_k4_k5_speed_control_width(gen):
    """Wan2.1-T2V-1.3B's width (the speed-control recipe): 12 heads of 128,
    Dm 1536 (6 chunks of 16 bytes a lane: K5's 8-chunk instantiation) over
    the 9-frame 480x832 clip's 4,680 tokens: K4, K5, K1 self and cross."""
    f, h, w, n = 3, 30, 52, 12
    s = f * h * w
    xq, xk = _randn(gen, 1, s, n * 128), _randn(gen, 1, s, n * 128, scale=0.7)
    wq = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    wk = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    cos, sin = assemble_freqs_grid(128, f, h, w, device="cuda")
    before = (fnr.ROPE_KERNEL.launches, fnr.RMS_KERNEL.launches, fa.KERNEL.launches)
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    o5 = fnr.fused_rmsnorm(xq, wq)
    v = _randn(gen, 1, s, n, 128)
    o1 = fa.flash_attention(oq, ok, v)
    ctx = _randn(gen, 1, 512, n, 128)
    o1x = fa.flash_attention(oq, ctx, ctx)
    torch.cuda.synchronize()
    assert (fnr.ROPE_KERNEL.launches, fnr.RMS_KERNEL.launches, fa.KERNEL.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    _assert_close(oq, pq)
    _assert_close(ok, pk)
    _assert_close(o5, fnr.fused_rmsnorm_plain(xq, wq))
    rows = torch.cat([torch.arange(0, 1024), torch.arange(s - 1024, s)]).cuda()
    _assert_close(o1[:, rows], fa.flash_attention_plain(oq[:, rows], ok, v))
    _assert_close(o1x[:, rows], fa.flash_attention_plain(oq[:, rows], ctx, ctx))


@pytest.mark.parametrize("rows,blocks,n", [(300, 4, 3), (1000, 2, 2), (64, 3, 1)])
def test_ring_body_matches_plain(gen, rows, blocks, n):
    """The ring's per-rank body: K1 with stats on each key block (one launch
    a block), the partials merged in fp32, against K1's plain version over
    all keys within four bf16 ULPs (four bf16-rounded partials) and against
    the JAX body's online softmax (`ring_body_plain`) alike."""
    from video_styler_tpu_torch.parallel import ring
    q = _randn(gen, 1, rows, n, 128)
    k, v = _randn(gen, 1, rows * blocks, n, 128), _randn(gen, 1, rows * blocks, n, 128)
    kv = [(k[:, i * rows:(i + 1) * rows], v[:, i * rows:(i + 1) * rows])
          for i in range(blocks)]
    before = fa.KERNEL.launches
    out = ring.ring_body(q, kv)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + blocks
    for want in (fa.flash_attention_plain(q, k, v), ring.ring_body_plain(q, kv)):
        err = (out.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -6 * want.float().abs().max().item(), err


def test_k1_rows_keep_their_bits_at_shifts_of_8(gen):
    """A query row's output depends on its position modulo 8 only (its norm
    bound sums the row's chunks in the order of their 128-byte swizzle):
    why each rank's share of a sequence is a whole number of 8 rows
    (`models.wan_dit.SHARD_ROWS`), so that cross-attention on a rank's rows
    keeps every bit of the one-process result."""
    q = _randn(gen, 1, 4688, 2, 128)
    k, v = _randn(gen, 1, 512, 2, 128), _randn(gen, 1, 512, 2, 128)
    whole = fa.flash_attention(q, k, v)
    for start in (8, 2344, 4680):
        part = fa.flash_attention(q[:, start:].contiguous(), k, v)
        assert torch.equal(part, whole[:, start:]), start


@pytest.mark.parametrize("sp", [2, 4])
def test_k1_ulysses_share_cuts_padded_keys(gen, sp):
    """One Ulysses rank's share as the all-to-all leaves it: the receive
    buffer (sp, 1, S/sp, N/sp, D) viewed as (1, S, N/sp, D) with no copy,
    over a sequence of 997 real tokens padded to a multiple of sp; K1 reads
    it through its tensor maps and cuts the padded keys at kv_valid."""
    real = 997
    s = real + (-real) % sp
    recv = _randn(gen, sp, 1, s // sp, 2, 128)
    q, k, v = (recv.view(1, s, 2, 128), _randn(gen, sp, 1, s // sp, 2, 128).view(1, s, 2, 128),
               _randn(gen, sp, 1, s // sp, 2, 128).view(1, s, 2, 128))
    out = attention(q, k, v, kv_valid=real)
    _assert_close(out, fa.flash_attention_plain(q, k[:, :real], v[:, :real]))


@pytest.mark.parametrize("frames", [3, 20])
def test_k1_k5_s2v_audio_cross(gen, frames):
    """Wan2.2-S2V's audio injection at 448x832: each latent frame's 1,456
    tokens (a batch row per frame: 3 at 12 frames, 20 at 80) attend to
    that frame's 5 audio tokens (4 and a padding token), 40 heads: K5 on
    the (frames, 1,456, 5120) query rows, K1 with one key tile of 5 real
    keys and 123 rows of TMA zero-fill."""
    s, n = 28 * 52, 40
    xq = _randn(gen, frames, s, n * 128)
    wq = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    k, v = _randn(gen, frames, 5, n, 128), _randn(gen, frames, 5, n, 128)
    before = (fnr.RMS_KERNEL.launches, fa.KERNEL.launches)
    q = fnr.fused_rmsnorm(xq, wq)
    out = fa.flash_attention(q.view(frames, s, n, 128), k, v)
    torch.cuda.synchronize()
    assert (fnr.RMS_KERNEL.launches, fa.KERNEL.launches) == (before[0] + 1, before[1] + 1)
    _assert_close(q, fnr.fused_rmsnorm_plain(xq, wq))
    _assert_close(out, fa.flash_attention_plain(q.view(frames, s, n, 128), k, v))


@pytest.mark.parametrize("frames", [12, 80])
def test_k4_k1_s2v_segment_tables(gen, frames):
    """Wan2.2-S2V's self-attention at 448x832: the latent frames' tokens
    and the reference frame's 1,456 at temporal RoPE index 30 (5,824
    tokens at 12 frames, 30,576 at 80), their cos/sin rows from
    `s2v_rope_segments`: K4 on q and k, K1 self, the text cross (512
    keys) on 5,824 query rows."""
    from video_styler_tpu_torch.models.wan_s2v import s2v_rope_segments, video_segments
    f, h, w, n = (frames - 1) // 4 + 1, 28, 52, 40
    cos, sin = (torch.from_numpy(t).cuda()
                for t in s2v_rope_segments(128, video_segments(f, h, w, h, w)))
    s = (f + 1) * h * w
    assert cos.shape == (s, 64)
    xq, xk = _randn(gen, 1, s, n * 128), _randn(gen, 1, s, n * 128, scale=0.7)
    wq = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    wk = (1 + 0.1 * torch.randn(n * 128, generator=gen, device="cuda")).to(torch.bfloat16)
    v = _randn(gen, 1, s, n, 128)
    ctx = _randn(gen, 1, 512, n, 128)
    before = (fnr.ROPE_KERNEL.launches, fa.KERNEL.launches)
    oq, ok = fnr.fused_rmsnorm_rope(xq, xk, wq, wk, cos, sin)
    out = fa.flash_attention(oq, ok, v)
    outx = fa.flash_attention(oq, ctx, ctx)
    torch.cuda.synchronize()
    assert (fnr.ROPE_KERNEL.launches, fa.KERNEL.launches) == (before[0] + 1, before[1] + 2)
    pq, pk = fnr.fused_rmsnorm_rope_plain(xq, xk, wq, wk, cos, sin)
    _assert_close(oq, pq)
    _assert_close(ok, pk)
    rows = torch.cat([torch.arange(0, 1024), torch.arange(s - 1024, s)]).cuda()
    _assert_close(out[:, rows], fa.flash_attention_plain(oq[:, rows], ok, v))
    _assert_close(outx[:, rows], fa.flash_attention_plain(oq[:, rows], ctx, ctx))


@pytest.mark.parametrize("rows", [29640, 4680, 4681])
def test_k5_ditto_rows(gen, rows):
    """K5 at the Ditto width (Dm = 5120: 20 chunks of 16 bytes a lane) on
    the 29,640- and 4,680-token rows, and a count that leaves the last
    block of 4 rows short; a row wider than 8192 is refused."""
    x = _randn(gen, 1, rows, 5120)
    w = (1 + 0.1 * torch.randn(5120, generator=gen, device="cuda")).to(torch.bfloat16)
    before = fnr.RMS_KERNEL.launches
    out = fnr.fused_rmsnorm(x, w)
    torch.cuda.synchronize()
    assert fnr.RMS_KERNEL.launches == before + 1
    _assert_close(out, fnr.fused_rmsnorm_plain(x, w))
    wide = _randn(gen, 1, 4, 8200)
    with pytest.raises(ValueError):
        fnr.fused_rmsnorm(wide, torch.ones(8200, dtype=torch.bfloat16, device="cuda"))
    assert fnr.RMS_KERNEL.launches == before + 1


def _k3_check(q, k, v, g, need_kv=True):
    """K1-with-stats then K3 against the plain forward's stats and the plain
    backward on the same o and L2."""
    o, l2 = fa._flash_cuda(q, k, v, 1 / 128 ** 0.5, with_stats=True)
    po, pl2 = fa.flash_attention_plain(q, k, v, return_stats=True)
    _assert_close(o, po)
    # L2 is fp32 on both sides: m2 from the same rounded q, l summed in
    # another order
    assert (l2 - pl2).abs().max().item() <= 1e-4 * max(1.0, pl2.abs().max().item())
    before = (fa.BWD_KERNEL.launches, fa.BWD_DQ_KERNEL.launches)
    got = fa.flash_attention_bwd(q, k, v, o, l2, g, need_kv=need_kv)
    torch.cuda.synchronize()
    assert (fa.BWD_KERNEL.launches, fa.BWD_DQ_KERNEL.launches) == (
        before[0] + int(need_kv), before[1] + int(not need_kv))
    want = fa.flash_attention_bwd_plain(q, k, v, o, l2, g)
    for t, w in zip(got, want):
        if t is not None:
            assert t.shape == w.shape and t.dtype == w.dtype
            _assert_close(t, w)
    return got


@pytest.mark.parametrize("b,sq,sk,n,mag", [(1, 64, 64, 1, 1.0), (2, 200, 333, 3, 1.0),
                                           (1, 300, 40, 2, 1.0), (1, 1000, 512, 4, 1.0),
                                           (1, 300, 257, 2, 24.0)])
def test_k1_stats_and_k3_match_plain(gen, b, sq, sk, n, mag):
    q = _randn(gen, b, sq, n, 128, scale=mag)
    k, v = _randn(gen, b, sk, n, 128), _randn(gen, b, sk, n, 128)
    _k3_check(q, k, v, _randn(gen, b, sq, n, 128))


def test_k3_reads_strided_views_and_skips_unwanted_dkv(gen):
    """q/k/v as head slices of one projection (strided rows), dO from a
    (B, S, N*D) view; without dK/dV wanted the dq-only kernel runs."""
    x = _randn(gen, 1, 130, 3 * 2 * 128)
    q, k, v = x.view(1, 130, 6, 128).split(2, dim=2)
    g = _randn(gen, 1, 130, 256).view(1, 130, 2, 128)
    _k3_check(q, k, v, g)
    dq, dk, dv = _k3_check(q, k, v, g, need_kv=False)
    assert dk is None and dv is None


@pytest.mark.parametrize("sq,sk,n,mag", [(4680, 4680, 2, 1.0), (4680, 512, 2, 1.0),
                                         (4680, 4680, 2, 8.0), (333, 200, 3, 8.0)])
def test_k1_k3_ragged_ditto_lengths(gen, sq, sk, n, mag):
    """The run's token count (4,680 = 36 x 128 + 72), the 512 text tokens
    and the q x8 magnitude stress: ragged last tiles of 128 keys (K1, K3)
    and of 64 or 128 query rows."""
    q = _randn(gen, 1, sq, n, 128, scale=mag)
    k, v = _randn(gen, 1, sk, n, 128), _randn(gen, 1, sk, n, 128)
    g = _randn(gen, 1, sq, n, 128)
    _k3_check(q, k, v, g)
    _k3_check(q, k, v, g, need_kv=False)


def test_k3_dq_repeats_within_tolerance(gen):
    """dQ is summed by fp32 reduce-adds in an order that changes from run to
    run: two runs agree within the stated tolerance, not bit for bit; dK
    and dV are sums in registers and repeat exactly."""
    q, k, v, g = (_randn(gen, 1, 1000, 2, 128) for _ in range(4))
    o, l2 = fa._flash_cuda(q, k, v, 1 / 128 ** 0.5, with_stats=True)
    first = fa.flash_attention_bwd(q, k, v, o, l2, g)
    second = fa.flash_attention_bwd(q, k, v, o, l2, g)
    _assert_close(second[0], first[0])
    assert torch.equal(second[1], first[1]) and torch.equal(second[2], first[2])


def test_autograd_through_kernels_matches_plain(gen):
    """`attention` under autograd on the card (K1 stats + K3) against the same
    Function run on the plain versions; K4/K5 gradients likewise."""
    q, k, v = (_randn(gen, 1, 200, 2, 128) for _ in range(3))
    g = _randn(gen, 1, 200, 2, 128)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(attention(*ins), ins, g)
    o, l2 = fa.flash_attention_plain(q, k, v, return_stats=True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, l2, g)
    for t, w in zip(got, want):
        _assert_close(t, w)
    f, h, w_ = 1, 6, 10
    xq, xk = _randn(gen, 1, 60, 256), _randn(gen, 1, 60, 256)
    wq, wk = (1 + 0.1 * torch.randn(256, generator=gen, device="cuda")).to(torch.bfloat16), \
        (1 + 0.1 * torch.randn(256, generator=gen, device="cuda")).to(torch.bfloat16)
    cos, sin = assemble_freqs_grid(128, f, h, w_, device="cuda")
    gq, gk = _randn(gen, 1, 60, 2, 128), _randn(gen, 1, 60, 2, 128)
    a = [t.clone().requires_grad_() for t in (xq, xk)]
    got = torch.autograd.grad(fnr.fused_rmsnorm_rope(*a, wq, wk, cos, sin), a, (gq, gk))
    b = [t.clone().requires_grad_() for t in (xq, xk)]
    want = torch.autograd.grad(fnr.fused_rmsnorm_rope_plain(*b, wq, wk, cos, sin), b,
                               (gq, gk))
    for t, w in zip(got, want):
        _assert_close(t, w)
    a = xq.clone().requires_grad_()
    b = xq.clone().requires_grad_()
    _assert_close(torch.autograd.grad(fnr.fused_rmsnorm(a, wq), a, gq.view(1, 60, 256))[0],
                  torch.autograd.grad(fnr.fused_rmsnorm_plain(b, wq), b, gq.view(1, 60, 256))[0])


def test_k3_rejects_what_it_does_not_take(gen):
    q = _randn(gen, 1, 16, 2, 128)
    o, l2 = fa._flash_cuda(q, q, q, 1 / 128 ** 0.5, with_stats=True)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q.float(), q.float(), q.float(), o, l2, q)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, o, l2[:, :, :8], q)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, q, q, o[:, :8], l2, q)
    with pytest.raises(ValueError):
        small = _randn(gen, 1, 16, 2, 64)
        fa.flash_attention_bwd(small, small, small, small, l2, small)


# --------------------------------------------------------------------------
# K2 / K8 (online softmax), K6 / K7 (int8 Q K^T), quantized linears
# --------------------------------------------------------------------------

ONLINE_CASES = [(1, 64, 64, 1, 1.0), (2, 200, 333, 3, 1.0), (1, 1000, 512, 4, 1.0),
                (1, 300, 257, 2, 24.0), (1, 130, 129, 2, 1.0), (1, 200, 300, 2, 1.0)]


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("b,sq,sk,n,mag", ONLINE_CASES)
def test_k2_k8_match_plain(gen, b, sq, sk, n, mag, dual):
    q = _randn(gen, b, sq, n, 128, scale=mag)
    k, v = _randn(gen, b, sk, n, 128), _randn(gen, b, sk, n, 128)
    kern = fa.DUAL_KERNEL if dual else fa.ONLINE_KERNEL
    before = (kern.launches, fa.KERNEL.launches)
    out = fa.flash_attention(q, k, v, capped=False, dual=dual)
    torch.cuda.synchronize()
    assert (kern.launches, fa.KERNEL.launches) == (before[0] + 1, before[1])
    _assert_close(out, fa.flash_attention_online_plain(q, k, v, dual=dual))


def test_k2_stats_feed_k3_and_3d_entry(gen):
    """K2's L2 against the plain version's; autograd on the online route
    (K2 with stats, then K3) against the plain pair; the (BH, S, D) entry
    with and without grad."""
    q, k, v = _randn(gen, 1, 200, 2, 128), _randn(gen, 1, 333, 2, 128), _randn(gen, 1, 333, 2, 128)
    g = _randn(gen, 1, 200, 2, 128)
    o, l2 = fa._flash_forward(q, k, v, 128 ** -0.5, with_stats=True, capped=False)
    po, pl2 = fa.flash_attention_online_plain(q, k, v, return_stats=True)
    _assert_close(o, po)
    assert (l2 - pl2).abs().max().item() <= 1e-4 * max(1.0, pl2.abs().max().item())
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.ONLINE_KERNEL.launches, fa.BWD_KERNEL.launches)
    got = torch.autograd.grad(fa.flash_attention(*ins, capped=False), ins, g)
    assert (fa.ONLINE_KERNEL.launches, fa.BWD_KERNEL.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    for t, w in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, l2, g)):
        _assert_close(t, w)
    q3, k3, v3, g3 = (t[0].transpose(0, 1).contiguous() for t in (q, k, v, g))
    _assert_close(fa.flash_attention_3d(q3, k3, v3), po[0].transpose(0, 1))
    ins = [t.clone().requires_grad_() for t in (q3, k3, v3)]
    got3 = torch.autograd.grad(fa.flash_attention_3d(*ins), ins, g3)
    for t, w in zip(got3, got):
        _assert_close(t, w[0].transpose(0, 1))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("sk", [29640, 300, 512])
def test_k2_k8_ragged_ditto_lengths(gen, sk, dual):
    """The Ditto self-attention keys (29,640 = 115 x 256 + 200: K8's last
    second sub-tile holds 72 keys), Sk = 300 (K8's last second sub-tile
    holds none) and the 512 text tokens (whole steps), on a ragged query
    tail; K2 also with stats."""
    q = _randn(gen, 1, 333, 2, 128)
    k, v = _randn(gen, 1, sk, 2, 128), _randn(gen, 1, sk, 2, 128)
    _assert_close(fa.flash_attention(q, k, v, capped=False, dual=dual),
                  fa.flash_attention_online_plain(q, k, v, dual=dual))
    if not dual:
        o, l2 = fa._flash_forward(q, k, v, 128 ** -0.5, with_stats=True, capped=False)
        po, pl2 = fa.flash_attention_online_plain(q, k, v, return_stats=True)
        _assert_close(o, po)
        assert (l2 - pl2).abs().max().item() <= 1e-4 * max(1.0, pl2.abs().max().item())


@pytest.mark.parametrize("dual", [False, True])
def test_k2_k8_read_strided_views(gen, dual):
    """Head slices of one (B, S, 3 N D) projection and the kv_valid slice of
    the keys: the kernels read through the tensor maps' strides, no copy."""
    x = _randn(gen, 2, 130, 3 * 2 * 128)
    q, k, v = x.view(2, 130, 6, 128).split(2, dim=2)
    kern = fa.DUAL_KERNEL if dual else fa.ONLINE_KERNEL
    before = kern.launches
    out = fa.flash_attention(q, k[:, :97], v[:, :97], capped=False, dual=dual)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _assert_close(out, fa.flash_attention_online_plain(q, k[:, :97].contiguous(),
                                                       v[:, :97].contiguous(), dual=dual))


def test_k2_rejects_what_it_does_not_take(gen):
    q = _randn(gen, 1, 16, 2, 128)
    for dual in (False, True):
        with pytest.raises(TypeError):
            fa.flash_attention(q.float(), q.float(), q.float(), capped=False, dual=dual)
        with pytest.raises(ValueError):
            small = _randn(gen, 1, 16, 2, 64)
            fa.flash_attention(small, small, small, capped=False, dual=dual)
        with pytest.raises(ValueError):  # rows 260 bytes apart: not a TMA stride
            wide = _randn(gen, 1, 16, 2, 130)[..., :128]
            fa.flash_attention(q, wide, wide, capped=False, dual=dual)
    with pytest.raises(ValueError):
        fa._flash_forward(q, q, q, 128 ** -0.5, with_stats=True, capped=False, dual=True)


@pytest.mark.parametrize("sq,sk,n", [(4680, 4680, 2), (333, 300, 3), (300, 512, 2)])
def test_k2_stats_feed_k3_ragged(gen, sq, sk, n):
    """The online training route under autograd at ragged lengths: K2 with
    stats, then K3 (dq, dk, dv) from its L2, against the plain pair."""
    q = _randn(gen, 1, sq, n, 128)
    k, v = _randn(gen, 1, sk, n, 128), _randn(gen, 1, sk, n, 128)
    g = _randn(gen, 1, sq, n, 128)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.ONLINE_KERNEL.launches, fa.BWD_KERNEL.launches)
    out = fa.flash_attention(*ins, capped=False)
    l2 = out.grad_fn.saved_tensors[4]
    got = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    assert (fa.ONLINE_KERNEL.launches, fa.BWD_KERNEL.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    po, pl2 = fa.flash_attention_online_plain(q, k, v, return_stats=True)
    _assert_close(out.detach(), po)
    assert (l2 - pl2).abs().max().item() <= 1e-4 * max(1.0, pl2.abs().max().item())
    for t, w in zip(got, fa.flash_attention_bwd_plain(q, k, v, out.detach(), l2, g)):
        _assert_close(t, w)


@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("b,sq,sk,n,mag", ONLINE_CASES)
def test_k6_matches_plain(gen, b, sq, sk, n, mag, capped):
    q = _randn(gen, b, sq, n, 128, scale=mag)
    k, v = _randn(gen, b, sk, n, 128) + 0.7, _randn(gen, b, sk, n, 128)
    kern = fa.INT8_CAPPED_KERNEL if capped else fa.INT8_ONLINE_KERNEL
    before = kern.launches
    out = fa.flash_attention_int8(q, k, v, capped=capped)
    torch.cuda.synchronize()
    assert kern.launches == before + 1 and out.dtype == q.dtype
    # the same pre-pass on the same device gives both the same integers
    _assert_close(out, fa.flash_attention_int8_plain(q, k, v, capped=capped))


@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("sk,mag", [(29640, 1.0), (512, 1.0), (301, 1.0), (77, 1.0),
                                    (4680, 8.0)])
def test_k6_ragged_ditto_lengths(gen, sk, mag, capped):
    """The Ditto self-attention keys (29,640 = 231 x 128 + 72), the 512 text
    tokens (whole steps), Sk = 301 and 77 (a short last step, and one step
    shorter than a tile), and q x8 at 4,680 tokens (logits of std ~11), on a
    ragged query tail: the key-scale padding, the masked last step and
    the running max over 128-key steps."""
    q = _randn(gen, 1, 333, 2, 128, scale=mag)
    k, v = _randn(gen, 1, sk, 2, 128) + 0.7, _randn(gen, 1, sk, 2, 128)
    kern = fa.INT8_CAPPED_KERNEL if capped else fa.INT8_ONLINE_KERNEL
    before = kern.launches
    out = fa.flash_attention_int8(q, k, v, capped=capped)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _assert_close(out, fa.flash_attention_int8_plain(q, k, v, capped=capped))


def test_k6_rejects_what_it_does_not_take(gen):
    """float32 v, head dim 64 and int8 rows that TMA cannot read (130 bytes
    apart) are refused before any launch."""
    q, k, v = _randn(gen, 1, 16, 2, 128), _randn(gen, 1, 16, 2, 128), _randn(gen, 1, 16, 2, 128)
    pre = fa.int8_prepass(q, k, v, 128 ** -0.5, capped=True)
    kernels = (fa.INT8_CAPPED_KERNEL, fa.INT8_ONLINE_KERNEL, fa.INT8_3D_KERNEL)
    before = [kern.launches for kern in kernels]
    with pytest.raises(TypeError):
        fa._flash_int8_cuda(pre[0], pre[1], v.float(), *pre[3:])
    small = fa.int8_prepass(*(t[..., :64].contiguous() for t in (q, k, v)), 0.125, True)
    with pytest.raises(ValueError):
        fa._flash_int8_cuda(*small)
    wide = torch.zeros((1, 16, 2, 130), dtype=torch.int8, device="cuda")
    wide[..., :128] = pre[0]
    with pytest.raises(ValueError):
        fa._flash_int8_cuda(wide[..., :128], *pre[1:])
    torch.cuda.synchronize()
    assert [kern.launches for kern in kernels] == before


def test_k6_reads_strided_views_and_k7_matches_plain(gen):
    x = _randn(gen, 1, 130, 3 * 2 * 128)
    q, k, v = x.view(1, 130, 6, 128).split(2, dim=2)
    pre = fa.int8_prepass(q, k, v, 128 ** -0.5, capped=True)
    wide = torch.zeros((1, 130, 4, 128), dtype=torch.int8, device="cuda")
    wide[:, :, 1:3] = pre[0]
    out = fa._flash_int8_cuda(wide[:, :, 1:3], *pre[1:])
    _assert_close(out, fa.flash_attention_int8_core_plain(*pre))
    q3, k3, v3 = _randn(gen, 5, 300, 128), _randn(gen, 5, 257, 128) + 0.7, _randn(gen, 5, 257, 128)
    before = (fa.INT8_3D_KERNEL.launches, fa.INT8_ONLINE_KERNEL.launches)
    out3 = fa.flash_attention_int8_3d(q3, k3, v3)
    torch.cuda.synchronize()
    # K7 is K6's online entry on (BH, S, 1, D) views, counted apart
    assert (fa.INT8_3D_KERNEL.launches, fa.INT8_ONLINE_KERNEL.launches) == (before[0] + 1,
                                                                            before[1])
    assert out3.dtype == torch.bfloat16
    want = fa.flash_attention_int8_plain(q3[:, :, None], k3[:, :, None], v3[:, :, None],
                                         capped=False)[:, :, 0]
    _assert_close(out3, want)
    with pytest.raises(RuntimeError):
        fa.flash_attention_int8(q.clone().requires_grad_(), k, v)


@pytest.mark.parametrize("rows", [1, 16, 77, 512])
def test_quantized_linears_match_cpu(gen, rows):
    """The library GEMMs of the quantized linears on the card against the
    CPU's exact products: the same integers / e4m3 values on both sides."""
    from video_styler_tpu_torch.ops import quant
    x = _randn(gen, rows, 256)
    w = (torch.randn(256, 384, generator=gen, device="cuda") / 16).to(torch.bfloat16)
    bias = _randn(gen, 384)
    for quantize, lin in ((quant.quantize_weight_int8, quant.linear_int8),
                          (quant.quantize_weight_fp8, quant.linear_fp8),
                          (quant.quantize_weight_int4, quant.linear_int4),
                          (quant.quantize_weight_int4_g, quant.linear_int4_g)):
        wq, ws = quantize(w)
        cq, cs = quantize(w.cpu())
        assert torch.equal(wq.cpu().view(torch.uint8), cq.view(torch.uint8))
        assert torch.equal(ws.cpu(), cs)
        got = lin(x, wq, ws, bias)
        want = lin(x.cpu(), cq, cs, bias.cpu())
        _assert_close(got.cpu(), want)
    assert torch.equal(quant.unpack_int4(wq).cpu(), quant.unpack_int4(cq))
    grid = torch.linspace(-448, 448, 100001, device="cuda")
    assert torch.equal(grid.to(quant.FP8).cpu().view(torch.uint8),
                       grid.cpu().to(quant.FP8).view(torch.uint8))


def _fastblend_inputs(gen, b, h, w, pad, kind, c=3):
    from torch.nn.functional import pad as fpad
    img = [fpad(torch.rand((b, h, w, c), generator=gen, device="cuda") * 255,
                (0, 0, pad, pad, pad, pad)) for _ in range(2)]
    if kind == "random":
        nnf = torch.stack([torch.randint(0, h, (b, h, w), generator=gen, device="cuda"),
                           torch.randint(0, w, (b, h, w), generator=gen, device="cuda")], -1)
    elif kind == "borders":  # every entry on an edge row or column
        pick = lambda n: torch.randint(0, 2, (b, h, w), generator=gen, device="cuda") * (n - 1)
        nnf = torch.stack([pick(h), pick(w)], -1)
    else:  # "outside": shifted identity, so votes near the border fall outside
        ii, jj = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"),
                                indexing="ij")
        nnf = torch.stack([(ii + 3).clamp(max=h - 1), (jj - 4).clamp(min=0)], -1).expand(
            b, h, w, 2)
    return img[0], img[1], nnf.to(torch.int32).contiguous()


@pytest.mark.parametrize("shape", [(2, 12, 10), (3, 61, 97), (8, 480, 832)])
@pytest.mark.parametrize("ps", [3, 5, 13])
@pytest.mark.parametrize("kind", ["random", "borders", "outside"])
def test_fastblend_kernels_match_plain(gen, shape, ps, kind):
    """F1-F3 against their plain versions: the kernels add and divide in the
    plain versions' order without FMA contraction, so they agree bit for
    bit (the stated bound, fp32: 2^-20 of the largest magnitude, is not
    needed)."""
    from video_styler_tpu_torch.extensions.fastblend import kernels as fk
    b, h, w = shape
    pad = 6  # patch_size varies, pad_size stays that of the largest patch
    src, tgt, nnf = _fastblend_inputs(gen, b, h, w, pad, kind)
    counts = [k.launches for k in (fk.REMAP_KERNEL, fk.PATCH_ERROR_KERNEL, fk.PAIRWISE_KERNEL)]
    got = [fk.remap(h, w, 3, ps, pad, src, nnf),
           fk.patch_error(h, w, 3, ps, pad, src, nnf, tgt),
           fk.pairwise_patch_error(h, w, 3, ps, pad, src, nnf, tgt, nnf.flip(0).contiguous())]
    torch.cuda.synchronize()
    assert [k.launches for k in (fk.REMAP_KERNEL, fk.PATCH_ERROR_KERNEL,
                                 fk.PAIRWISE_KERNEL)] == [n + 1 for n in counts]
    want = [fk.remap_plain(h, w, 3, ps, pad, src, nnf),
            fk.patch_error_plain(h, w, 3, ps, pad, src, nnf, tgt),
            fk.pairwise_patch_error_plain(h, w, 3, ps, pad, src, nnf, tgt,
                                          nnf.flip(0).contiguous())]
    for g, w_ in zip(got, want):
        err = (g - w_).abs().max().item()
        assert err <= 2.0 ** -20 * w_.abs().max().item(), err


@pytest.mark.parametrize("opts", [{}, {"use_mean_target_style": True},
                                  {"use_pairwise_patch_error": True, "tracking_window_size": 1}])
def test_fastblend_pyramid_waits_for_no_host(gen, opts):
    """A pyramid estimate on the card makes no synchronising call: at 50x70
    the levels take cv2's fractional area tables and the field's upsample
    the linear resize, whose tables, like the random draws, cross from
    pinned memory without a wait."""
    from video_styler_tpu_torch.extensions.fastblend import PyramidPatchMatcher
    imgs = torch.rand((3, 4, 50, 70, 3), generator=gen, device="cuda") * 255
    warm = torch.rand((3, 4, 24, 24, 3), generator=gen, device="cuda") * 255
    cfg = dict(minimum_patch_size=3, num_iter=2, device="cuda", **opts)
    PyramidPatchMatcher(24, 24, 3, **cfg).estimate_nnf(*warm)  # binds the kernels
    pm = PyramidPatchMatcher(50, 70, 3, **cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nnf, style = pm.estimate_nnf(*imgs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pm.pyramid_level == 3 and tuple(nnf.shape) == (4, 50, 70, 2)
    assert torch.isfinite(style).all()


def test_fastblend_kernels_refuse_and_count(gen):
    from video_styler_tpu_torch.extensions.fastblend import kernels as fk
    src, tgt, nnf = _fastblend_inputs(gen, 2, 16, 16, 2, "random")
    before = fk.PATCH_ERROR_KERNEL.launches
    with pytest.raises(ValueError):
        fk.patch_error(16, 16, 3, 7, 2, src, nnf, tgt)  # radius 3 > pad 2
    with pytest.raises(ValueError):
        fk.patch_error(16, 16, 3, 5, 2, src, nnf.long(), tgt)
    with pytest.raises(ValueError):
        fk.patch_error(16, 16, 3, 5, 2, src, nnf.cpu(), tgt)
    assert fk.PATCH_ERROR_KERNEL.launches == before
    from video_styler_tpu_torch.extensions.fastblend.patch_match import PatchMatcher
    pm = PatchMatcher(16, 16, 3, minimum_patch_size=3, num_iter=2, device="cuda")
    counts = (fk.REMAP_KERNEL.launches, fk.PATCH_ERROR_KERNEL.launches)
    pm.estimate_nnf(src[:, 2:-2, 2:-2], tgt[:, 2:-2, 2:-2], src[:, 2:-2, 2:-2], nnf)
    torch.cuda.synchronize()
    # per iteration: 1 remap, 2 errors for the start, 2 for each of 4 + 3 updates
    assert fk.REMAP_KERNEL.launches - counts[0] == 2 + 1
    assert fk.PATCH_ERROR_KERNEL.launches - counts[1] == 2 * 16


# --------------------------------------------------------------------------
# Block streaming: the copy stream, the slot ring and the pinned store
# --------------------------------------------------------------------------

def _streamed_models(gen, layers=6):
    """A bf16 DiT of 2 heads of 128 (so K1/K4/K5 run) and a 2-block VACE
    branch on the card, from the seed."""
    from video_styler_tpu_torch.models import wan_dit as TD
    from video_styler_tpu_torch.models import wan_vace as TV
    cfg = TD.WanDiTConfig(dim=256, in_dim=4, ffn_dim=512, out_dim=4, num_heads=2,
                          num_layers=layers, text_dim=64, freq_dim=32)
    vcfg = TV.VaceConfig(vace_layers=(0, 3), vace_in_dim=72, dim=256, num_heads=2,
                         ffn_dim=512)
    dit = TD.init_weights_(TD.WanDiT(cfg, device="cuda", dtype=torch.bfloat16), gen)
    vace = TD.init_weights_(TV.WanVace(vcfg, device="cuda", dtype=torch.bfloat16), gen)
    inputs = (_randn(gen, 1, 4, 5, 32, 32), torch.tensor([700.0], device="cuda"),
              _randn(gen, 1, 16, 64), _randn(gen, 1, 72, 5, 32, 32))
    return dit, vace, inputs


def test_streaming_serial_walk_equals_overlapped_with_slots_reused(gen):
    """5 streamed trunk blocks and 2 VACE blocks through a ring of 3 slots
    (depth 2), two forwards in a row each way: bit-equal. A slot written
    while the compute still read it would show here."""
    from video_styler_tpu_torch.models.wan_streaming import WanBlockStreamer
    dit, vace, inputs = _streamed_models(gen)
    st = WanBlockStreamer(dit, vace=vace, mode="int8", resident_blocks=1, prefetch_depth=2)
    assert len(st.ring.slots) == 3 and len(st.streamed_host) == 5
    outs = {}
    for overlap in (True, False):
        st.overlap = overlap
        outs[overlap] = [st.forward(*inputs, vace_scale=0.9)[0] for _ in range(2)]
    torch.cuda.synchronize()
    assert st.ring.copies == 4 * 7
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
    assert torch.equal(outs[True][0], outs[True][1])


def test_streamed_forward_waits_for_no_host(gen):
    """The overlapped forward under sync debug mode "error": no host wait
    (the copies, the RoPE tables and the VACE scale go without one)."""
    from video_styler_tpu_torch.models.wan_streaming import WanBlockStreamer
    dit, vace, inputs = _streamed_models(gen)
    st = WanBlockStreamer(dit, vace=vace, mode="int8", resident_blocks=2, prefetch_depth=2)
    st.forward(*inputs)                     # builds the kernels and the shells
    torch.cuda.synchronize()
    before = fa.KERNEL.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = st.forward(*inputs, vace_scale=0.9)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fa.KERNEL.launches == before + 2 * (6 + 2)
    assert torch.isfinite(out).all()


def test_streamed_slg_gate_equals_resident_forward(gen):
    """Skip-layer guidance's per-row gate in the streamed walk (bf16, 2 of
    6 trunk blocks resident, the VACE blocks streamed; row 1 skips blocks
    1 and 4) against the resident forward with the same gate: bit-equal,
    and no host wait under sync debug mode "error"."""
    from video_styler_tpu_torch.models import wan_dit as TD
    from video_styler_tpu_torch.models.wan_streaming import WanBlockStreamer
    dit, vace, (lat, ts, ctx, vc) = _streamed_models(gen)
    lat, ctx, vc = (torch.cat([t, t]) for t in (lat, ctx, vc))
    gate = torch.ones((6, 2), device="cuda")
    gate[[1, 4], 1] = 0.0
    with torch.no_grad():
        want = TD.wan_dit_forward_with_residual(dit, lat, ts, ctx, vace=vace, vace_context=vc,
                                                vace_scale=0.9, layer_gate=gate)[0]
    st = WanBlockStreamer(dit, vace=vace, mode="bf16", resident_blocks=2, prefetch_depth=2)
    st.forward(lat, ts, ctx, vc, 0.9, layer_gate=gate)      # builds the shells
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = st.forward(lat, ts, ctx, vc, 0.9, layer_gate=gate)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    assert not torch.equal(got[0], got[1])


def test_pinned_store_views_match_the_host_tree(gen):
    """A packed block (int8 column-major weights, fp32 scales, bf16 biases
    and modulation) in pinned memory, copied through a slot twice: its
    views hold the tree's values, shapes and layouts; a buffer from
    `pinned_empty` copies its bytes."""
    from video_styler_tpu_torch.parallel.streaming import (PrefetchQueue, SlotRing,
                                                           pack_host_block, pinned_empty)
    w = torch.randint(-127, 128, (640, 384), dtype=torch.int8, device="cuda")
    tree = {"q.w_q": w.t(),                                   # (384, 640) column-major
            "q.w_scale": torch.rand((1, 640), generator=gen, device="cuda"),
            "q.b": _randn(gen, 640), "modulation": _randn(gen, 1, 6, 384),
            "norm.scale": _randn(gen, 7)}
    packed = pack_host_block(tree, pin=True)
    assert packed.buf.is_pinned() and packed.buf.device.type == "cpu"
    ring = SlotRing(2, packed.buf.numel(), "cuda")
    queue = PrefetchQueue([packed, packed], ring, depth=1)
    for _ in range(2):
        slot, views = queue.pop()
        for name, t in tree.items():
            got = views[name]
            assert got.shape == t.shape and got.dtype == t.dtype and got.stride() == t.stride()
            assert torch.equal(got, t), name
            assert got.data_ptr() % 512 == 0
        queue.done(slot)
    host = pinned_empty(1 << 20)
    host.copy_(torch.randint(0, 256, (1 << 20,), dtype=torch.uint8))
    assert host.is_pinned() and torch.equal(host.to("cuda", non_blocking=True).cpu(), host)


def test_card_quantizers_equal_the_host_quantizers(gen):
    """Quantising a block on the card gives the host quantiser's values: the
    streamer may quantise where the weights lie, then copy to its store."""
    from video_styler_tpu_torch.parallel.streaming import host_quantize_int4, host_quantize_int8
    tree = {"ffn.fc1.weight": _randn(gen, 13824, 5120, scale=0.02),
            "ffn.fc1.bias": _randn(gen, 13824), "self_attn.o.weight": _randn(gen, 512, 256),
            "self_attn.o.bias": _randn(gen, 512), "norm3.scale": _randn(gen, 256)}
    host = {k: v.cpu() for k, v in tree.items()}
    for quant in (host_quantize_int8, host_quantize_int4):
        card = quant(tree, stack=40)
        want = quant(host, stack=40)
        assert card.keys() == want.keys()
        for k in want:
            assert torch.equal(card[k].cpu(), want[k]), (quant.__name__, k)
