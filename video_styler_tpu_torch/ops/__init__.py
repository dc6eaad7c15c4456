"""Tensor ops and the hand-written kernels (K1 flash attention, K3 its
backward, K4 fused RMSNorm+RoPE, K5 RMSNorm); kernel sources are in
../csrc."""
