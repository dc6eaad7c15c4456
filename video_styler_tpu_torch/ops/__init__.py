"""Tensor ops, the quantized linears, and the hand-written kernels (K1, K2
and K8 flash attention forwards, K3 their backward, K6 and K7 int8
attention, K4 fused RMSNorm+RoPE, K5 RMSNorm); kernel sources are in
../csrc."""
