"""PyTorch/CUDA port of the iterated-learning VLM framework, for NVIDIA Hopper.

The JAX package ``iterated_learning_for_vlm_tpu`` beside it is the reference;
this package mirrors its module names (``models/``, ``ops/``, ``eval/``,
``tools/``, ``train/``, ``utils/``, ``data/``), imports ``torch`` and never
``jax``, and holds every Pallas TPU kernel it ports as a hand-written Hopper
kernel under ``csrc/``, built at first use by ``ops/_build.py``. So far it
ports the CLIP-FDT ViT-B/32 serving path (image and text embeddings), its
training step with the iterated-learning engine and the solver around it
(checkpoints, resume, the ``ilvlm-train-torch`` launcher in ``cli_entry``;
webdataset shards or synthetic data), the evaluation suite (the
``ilvlm-eval-torch`` CLI in ``eval/cli.py`` and the Solver's eval hooks),
the baseline CLIP (ViT-B/32 and ViT-B/16 towers), serving and training,
and the flash-attention route; see ROADMAP.md for what follows.
"""
