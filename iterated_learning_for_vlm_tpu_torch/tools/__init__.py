"""Host-side tools of the PyTorch port: the weight bridge, the data and eval-set
writers, the eval sweep and the kernel benches."""
