"""Host-side data utilities of the PyTorch port (the caption tokenizer)."""
