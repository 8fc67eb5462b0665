"""PyTorch/CUDA port of the iterated-learning VLM framework, for NVIDIA Hopper.

The JAX package ``iterated_learning_for_vlm_tpu`` beside it is the reference;
this package mirrors its module names (``models/``, ``ops/``, ``eval/``,
``tools/``, ``train/``), imports ``torch`` and never ``jax``, and holds every
Pallas TPU kernel it ports as a hand-written Hopper kernel under ``csrc/``,
built at first use by ``ops/_build.py``. So far it ports the CLIP-FDT
ViT-B/32 serving path (image and text embeddings) and its training step with
the iterated-learning engine; see ROADMAP.md for what follows.
"""
