"""Host-side tools of the PyTorch port (weight bridge)."""
