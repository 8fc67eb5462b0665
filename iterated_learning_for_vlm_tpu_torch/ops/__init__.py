"""Hand-written Hopper kernels and their plain PyTorch versions.

- ``codebook_attention``: fused FDT codebook pooling, forward (K1-fwd) and
  backward (K1-bwd dq, K1-bwd dsd).
- ``fused_attention``: tiny-sequence packed-QKV attention, forward (K2-fwd)
  and backward (K2-bwd).
- ``flash_attention``: attention over ``[B, S, H, 64]`` heads at any S up to
  1024, forward (K3-fwd) and backward (K3-bwd); the towers' ``use_flash`` route.
- ``window_attention``: Swin's shifted-window attention with its per-head
  bias, forward (K4-fwd) and backward (K4-bwd).
- ``graphs``: CUDA-graph replay for the train step and the eval encoder, and
  the registry of the counters (each wrapper's ``.launches``) it advances.
- ``_build``: compiles ``csrc/*.cu`` with nvcc at first use, binds with ctypes.
"""
