"""The tensor-map layouts through which K1 and K3 load q, k, v and dO on
the card (`tma_layout`), computed and checked on CPU tensors: the dims
innermost first (D, N, S, B), the byte strides of N, S and B, and the
tensors that TMA cannot read, which the wrappers refuse before a launch."""
import pytest
import torch

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
