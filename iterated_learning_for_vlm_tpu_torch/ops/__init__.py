"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``codebook_attention``: fused FDT codebook pooling forward (K1-fwd).
- ``fused_attention``: tiny-sequence packed-QKV attention forward (K2-fwd).
- ``_build``: compiles ``csrc/*.cu`` with nvcc at first use, binds with ctypes.
"""
