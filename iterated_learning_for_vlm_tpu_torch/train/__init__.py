"""Training slice of the PyTorch port: loss, optimizer, schedules, train
state, the train step, the iterated-learning engine, checkpoints and the
solver (counterparts of the JAX package's ``train/`` modules of the same
names)."""
