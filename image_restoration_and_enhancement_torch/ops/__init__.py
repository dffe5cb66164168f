"""Ops with hand-written CUDA kernels: attention (K1) and GroupNorm(+SiLU) (K2)."""
