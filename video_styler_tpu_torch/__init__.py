"""video_styler_tpu_torch: the PyTorch/CUDA port of video_styler_tpu.

The JAX package `video_styler_tpu` is the reference; this package has the
same layout (ops/, models/, schedulers/, prompters/, pipelines/, data/) and
imports neither JAX nor anything of the JAX package. Its hot kernels are
hand-written CUDA C++ for Hopper (csrc/), built with nvcc at first use.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no explicit CPU request they raise.

Numerics: TF32 is switched off for matmuls and cuDNN convolutions here, so
fp32 work (the VAE, fp32 models) runs in full fp32 as the JAX reference
does. cuDNN's default would run fp32 convolutions in TF32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402,F401
