"""The port's hand-written CUDA kernels (K1 with and without stats, K2, K3,
K4, K5, K6, K7, K8) against their plain versions, and the quantized linears'
library GEMMs against the CPU's exact products, on the card. They skip on a host without a GPU; on the card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest` because the suite's conftest imports JAX, which the card's
machine does not have; this file imports only torch and the port).

Tolerance: two bf16 ULPs at the output's largest magnitude. The kernel and
the plain version round at the same points; exp2 and rsqrt differ in their
last fp32 bits, which can move one bf16 rounding by one ULP.
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
