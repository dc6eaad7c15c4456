"""Which kernel a CUDA call launches, by the input's dtype, and what each
wrapper refuses, checked without a card: the flash wrappers take bfloat16
(K1, K2, K3, K8) or float32 (K1f, K3f, K3q-f), the norm wrappers bfloat16
(K4, K5) or float32 (K4f, K5f); K2 and K8 on float32 and every other dtype
raise TypeError before anything is launched. On the card the kernels
themselves are held against their plain versions by
`tests/test_torch_kernels_cuda.py`.
"""
import pytest
import torch

from video_styler_tpu_torch.ops import flash_attention as fa
from video_styler_tpu_torch.ops import fused_norm_rope as fnr

from test_torch_pipeline import cpu_share  # noqa: F401

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize("dtype,capped,dual,want", [
    (BF16, True, False, "KERNEL"), (BF16, False, False, "ONLINE_KERNEL"),
    (BF16, False, True, "DUAL_KERNEL"), (F32, True, False, "F32_KERNEL")])
def test_forward_kernel_by_dtype(dtype, capped, dual, want):
    assert fa.forward_kernel(dtype, capped=capped, dual=dual) is getattr(fa, want)


@pytest.mark.parametrize("capped,dual", [(False, False), (False, True), (True, True)])
def test_k2_k8_have_no_float32_instantiation(capped, dual):
    with pytest.raises(TypeError, match="ROADMAP Queue 2 item 9"):
        fa.forward_kernel(F32, capped=capped, dual=dual)


@pytest.mark.parametrize("dtype,need_kv,want", [
    (BF16, True, "BWD_KERNEL"), (BF16, False, "BWD_DQ_KERNEL"),
    (F32, True, "BWD_F32_KERNEL"), (F32, False, "BWD_DQ_F32_KERNEL")])
def test_backward_kernel_by_dtype(dtype, need_kv, want):
    assert fa.backward_kernel(dtype, need_kv) is getattr(fa, want)


@pytest.mark.parametrize("dtype,want", [(BF16, ("ROPE_KERNEL", "RMS_KERNEL")),
                                        (F32, ("ROPE_F32_KERNEL", "RMS_F32_KERNEL"))])
def test_norm_kernels_by_dtype(dtype, want):
    assert (fnr.rope_kernel(dtype), fnr.rms_kernel(dtype)) == tuple(
        getattr(fnr, w) for w in want)


@pytest.mark.parametrize("dtype", [F16, torch.float64, torch.int8])
def test_every_other_dtype_is_refused(dtype):
    for pick in (fa.forward_kernel, fa.backward_kernel, fnr.rope_kernel, fnr.rms_kernel):
        with pytest.raises(TypeError, match="bfloat16.*float32"):
            pick(dtype)


def test_float32_instantiations_are_distinct_entry_points():
    """Each float32 instantiation has a C entry point and a launch count of
    its own, in the library its source builds."""
    kernels = (fa.F32_KERNEL, fa.BWD_F32_KERNEL, fa.BWD_DQ_F32_KERNEL,
               fnr.ROPE_F32_KERNEL, fnr.RMS_F32_KERNEL)
    assert len({k.symbol for k in kernels}) == len(kernels)
    assert {k.library for k in kernels} == {"flash_attention_f32", "fused_norm_rope"}
    assert all(k.symbol.endswith(("f32_fwd", "f32_bwd", "f32_bwd_dq")) for k in kernels)
    assert fa.BWD_F32_KERNEL is not fa.BWD_KERNEL and fa.F32_KERNEL is not fa.KERNEL


def test_check_messages_name_both_dtypes():
    q = torch.zeros((1, 8, 2, 128))
    with pytest.raises(TypeError, match="bfloat16.*float32"):
        fa._check("q", q.half(), q.device, F32)
    with pytest.raises(TypeError, match="float32"):
        fa._check("k", q.to(BF16), q.device, F32)  # one call, one dtype
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa._check("q", torch.zeros((1, 8, 2, 64)), q.device, F32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa._check("q", torch.zeros((1, 8, 2, 130))[..., :128], q.device, F32)
    fa._check("q", q, q.device, F32)
    fa._check("q", q.to(BF16), q.device)
    x = torch.zeros((1, 8, 256))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fnr._check_rows("k_proj", x.to(BF16), 256, F32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fnr._check_rows("x", x[:, ::2], 256, F32)
    fnr._check_rows("x", x, 256, F32)


def test_cuda_entries_refuse_before_any_launch():
    """The CUDA paths check dtypes first: on CPU tensors of a refused dtype
    they raise TypeError without building or launching a kernel."""
    q = torch.zeros((1, 8, 2, 128), dtype=F16)
    before = (fa.F32_KERNEL.launches, fa.KERNEL.launches, fa.BWD_F32_KERNEL.launches)
    with pytest.raises(TypeError):
        fa._flash_cuda(q, q, q, 0.1)
    with pytest.raises(TypeError, match="Queue 2 item 9"):
        fa._flash_online_cuda(q.float(), q.float(), q.float(), 0.1)
    with pytest.raises(TypeError):
        fa._BwdLaunch(q, q, q, q, torch.zeros((1, 2, 8)), q, 0.1, need_kv=True)
    with pytest.raises(TypeError):
        fa._BwdLaunch(q.float(), q.float(), q.float(), q.to(BF16), torch.zeros((1, 2, 8)),
                      q.float(), 0.1, need_kv=True)
    assert before == (fa.F32_KERNEL.launches, fa.KERNEL.launches,
                      fa.BWD_F32_KERNEL.launches)
