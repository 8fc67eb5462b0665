"""Evaluation of the PyTorch port: the encoders, the model loader, the scorers
and the eval CLI (``ilvlm-eval-torch``)."""
