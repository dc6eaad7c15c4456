"""The tensor-map layouts through which K1, K2, K3, K6 and K8 load q, k, v
and dO (K6: the int8 q8 and k8, and v) on the card (`tma_layout`), computed
and checked on CPU tensors: the dims innermost first (D, N, S, B), the byte
strides of N, S and B, and the tensors that TMA cannot read, which the
wrappers refuse before a launch."""
import pytest
import torch

from video_styler_tpu_torch.ops import flash_attention as fa
from video_styler_tpu_torch.ops.flash_attention import tma_layout


def _aligned(*shape, dtype=torch.bfloat16):
    t = torch.empty(shape, dtype=dtype)
    assert t.data_ptr() % 16 == 0
    return t


@pytest.mark.parametrize("b,s,n", [(1, 4680, 40), (2, 333, 3), (1, 29640, 40)])
def test_contiguous_tensor(b, s, n):
    t = _aligned(b, s, n, 128)
    assert tma_layout(t) == (128, n, s, b, 256, n * 256, s * n * 256)


def test_head_slices_of_a_fused_projection():
    """q, k, v as head slices of one (B, S, 3 N D) projection: strided rows,
    the base of k and v offset by whole heads."""
    x = _aligned(1, 130, 3 * 2 * 128)
    q, k, v = x.view(1, 130, 6, 128).split(2, dim=2)
    for i, t in enumerate((q, k, v)):
        assert t.data_ptr() - x.data_ptr() == i * 2 * 256
        assert tma_layout(t) == (128, 2, 130, 1, 256, 6 * 256, 130 * 6 * 256)


def test_size_one_dims_take_a_contiguous_stride():
    """The (BH, S, 1, D) view of the 3-D entry and a batch of one: the
    stride of a dimension of size 1 is never stepped along."""
    x = _aligned(5, 300, 128)
    assert tma_layout(x[:, :, None]) == (128, 1, 300, 5, 256, 256, 300 * 256)
    y = _aligned(7, 2, 128).transpose(0, 1)[None, :1]    # (1, 1, 7, 128), odd strides
    assert tma_layout(y) == (128, 7, 1, 1, 256 * 2, 7 * 256 * 2, 7 * 256 * 2)


def test_kv_valid_slice_keeps_the_layout():
    """The first 97 of 130 keys: the same row strides, 97 rows in the map
    (the batch of one takes the stride of 97 contiguous rows)."""
    k = _aligned(2, 130, 2, 128)[:, :97]
    assert tma_layout(k) == (128, 2, 97, 2, 256, 512, 130 * 512)
    assert tma_layout(k[:1]) == (128, 2, 97, 1, 256, 512, 97 * 512)


@pytest.mark.parametrize("make", [
    lambda: _aligned(1, 16, 2, 130)[..., :128],                  # row stride 260 bytes
    lambda: _aligned(1, 16, 3, 128 + 4)[..., :128].transpose(1, 2),  # head stride 264 bytes
    lambda: _aligned(1, 16, 2, 128, 2)[..., 0],                  # D not contiguous
    lambda: _aligned(4 + 16 * 2 * 128)[4:].view(1, 16, 2, 128),  # base + 8 bytes
    lambda: _aligned(1, 1, 2, 128).expand(1, 16, 2, 128),        # broadcast rows
])
def test_refuses_what_tma_cannot_read(make):
    with pytest.raises(ValueError):
        tma_layout(make())


def test_3d_entry_on_strided_rows():
    """`flash_attention_3d` hands K2 the (BH, S, 1, D) view of its inputs;
    a (BH, S, D) tensor that is itself a transposed (S, BH, D) buffer keeps
    its strides: S steps over every head, BH over one row of D."""
    x = _aligned(300, 40, 128).transpose(0, 1)                # (40, 300, 128)
    assert tma_layout(x[:, :, None]) == (128, 1, 300, 40, 256, 40 * 256, 256)


def test_cross_attention_kv_of_a_fused_projection():
    """The online route's cross-attention keys and values: head views of one
    (B, 512, 2 N D) projection of the text, rows 2 N D elements apart."""
    kv = _aligned(2, 512, 2 * 40 * 128)
    k, v = kv.view(2, 512, 80, 128).split(40, dim=2)
    assert v.data_ptr() - k.data_ptr() == 40 * 256
    for t in (k, v):
        assert tma_layout(t) == (128, 40, 512, 2, 256, 80 * 256, 512 * 80 * 256)


@pytest.mark.parametrize("dual", [False, True], ids=["k2", "k8"])
@pytest.mark.parametrize("make,error", [
    (lambda: [_aligned(1, 16, 2, 128, dtype=torch.float32)] * 3, TypeError),
    (lambda: [_aligned(1, 16, 2, 64)] * 3, ValueError),            # head dim 64
    (lambda: [_aligned(1, 16, 2, 128), _aligned(1, 16, 2, 130)[..., :128],
              _aligned(1, 16, 2, 128)], ValueError),                # rows 260 bytes apart
    (lambda: [_aligned(1, 16, 2, 128), _aligned(1, 1, 2, 128).expand(1, 16, 2, 128),
              _aligned(1, 16, 2, 128)], ValueError),                # broadcast rows
    (lambda: [_aligned(1, 16, 2, 128), _aligned(1, 16, 3, 128), _aligned(1, 16, 3, 128)],
     ValueError),                                                   # heads differ
], ids=["float32", "head_dim_64", "misaligned_rows", "broadcast", "heads"])
def test_online_wrapper_refuses_before_a_launch(make, error, dual):
    """K2's and K8's wrapper checks its inputs and their tensor maps before
    it launches anything (here on CPU tensors, where a launch could not
    happen at all: a refusal is the only outcome that passes)."""
    q, k, v = make()
    with pytest.raises(error):
        fa._flash_online_cuda(q, k, v, 1.0, dual=dual)


def test_dual_wrapper_writes_no_stats():
    t = _aligned(1, 16, 2, 128)
    with pytest.raises(ValueError, match="no stats"):
        fa._flash_online_cuda(t, t, t, 1.0, with_stats=True, dual=True)


# --------------------------------------------------------------------------
# K6 / K7: int8 q8 and k8 (one byte an element)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,n", [(1, 4680, 40), (2, 333, 3), (1, 29640, 40)])
def test_int8_contiguous_tensor(b, s, n):
    t = _aligned(b, s, n, 128, dtype=torch.int8)
    assert tma_layout(t) == (128, n, s, b, 128, n * 128, s * n * 128)


def test_int8_head_slices_of_a_fused_projection():
    """int8 q8, k8 and a third slice as head views of one (B, S, 3 N D)
    int8 buffer: rows 3 N D bytes apart, bases offset by whole heads."""
    x = _aligned(1, 130, 3 * 2 * 128, dtype=torch.int8)
    parts = x.view(1, 130, 6, 128).split(2, dim=2)
    for i, t in enumerate(parts):
        assert t.data_ptr() - x.data_ptr() == i * 2 * 128
        assert tma_layout(t) == (128, 2, 130, 1, 128, 6 * 128, 130 * 6 * 128)
    # K7's (BH, S, 1, D) view of a (BH, S, D) int8 tensor
    assert tma_layout(_aligned(5, 300, 128, dtype=torch.int8)[:, :, None]) == \
        (128, 1, 300, 5, 128, 128, 300 * 128)


@pytest.mark.parametrize("make", [
    lambda: _aligned(1, 16, 2, 130, dtype=torch.int8)[..., :128],         # heads 130 bytes apart
    lambda: _aligned(1, 16, 3, 136, dtype=torch.int8)[..., :128],         # heads 136 bytes apart
    lambda: _aligned(1, 1, 2, 128, dtype=torch.int8).expand(1, 16, 2, 128),  # broadcast rows
    lambda: _aligned(8 + 16 * 2 * 128, dtype=torch.int8)[8:].view(1, 16, 2, 128),  # base + 8
], ids=["rows_130", "rows_136", "broadcast", "base_plus_8"])
def test_refuses_int8_that_tma_cannot_read(make):
    with pytest.raises(ValueError):
        tma_layout(make())


def _int8_inputs(sq=16, sk=16, n=2, d=128):
    """What the pre-pass hands K6: q8, k8, v, qs, ks, m2 (CPU tensors)."""
    return [_aligned(1, sq, n, d, dtype=torch.int8), _aligned(1, sk, n, d, dtype=torch.int8),
            _aligned(1, sk, n, d), torch.ones(1, n, sq), torch.ones(1, n, sk),
            torch.ones(1, n, sq)]


def _replace(i, make):
    def inputs():
        pre = _int8_inputs()
        pre[i] = make()
        return pre
    return inputs


@pytest.mark.parametrize("capped", [True, False], ids=["capped", "online"])
@pytest.mark.parametrize("make,error", [
    (_replace(2, lambda: _aligned(1, 16, 2, 128, dtype=torch.float32)), TypeError),
    (lambda: _int8_inputs(d=64), ValueError),                              # head dim 64
    (_replace(0, lambda: _aligned(1, 16, 2, 130, dtype=torch.int8)[..., :128]),
     ValueError),                                                          # rows 130 bytes apart
    (_replace(1, lambda: _aligned(1, 1, 2, 128, dtype=torch.int8).expand(1, 16, 2, 128)),
     ValueError),                                                          # broadcast rows
    (_replace(4, lambda: torch.ones(1, 2, 15)), ValueError),               # ks of 15 keys
], ids=["float32_v", "head_dim_64", "misaligned_rows", "broadcast", "ks_length"])
def test_int8_wrapper_refuses_before_a_launch(make, error, capped):
    """K6's wrapper checks its inputs and their tensor maps before it
    launches anything (CPU tensors: a refusal is the only outcome that
    passes)."""
    pre = make()
    if not capped:
        pre[5] = None
    with pytest.raises(error):
        fa._flash_int8_cuda(*pre)
