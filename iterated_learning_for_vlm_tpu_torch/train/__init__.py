"""Training slice of the PyTorch port: loss, optimizer, schedules, train
state, the train step and the iterated-learning engine (counterparts of the
JAX package's ``train/`` modules of the same names)."""
