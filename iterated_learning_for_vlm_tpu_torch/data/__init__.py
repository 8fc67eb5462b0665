"""Host-side data of the PyTorch port: the caption tokenizer and the
synthetic datasets."""
