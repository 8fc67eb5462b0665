"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``codebook_attention``: fused FDT codebook pooling, forward (K1-fwd) and
  backward (K1-bwd dq, K1-bwd dsd).
- ``fused_attention``: tiny-sequence packed-QKV attention, forward (K2-fwd)
  and backward (K2-bwd).
- ``_build``: compiles ``csrc/*.cu`` with nvcc at first use, binds with ctypes.
"""
