"""Host-side data of the PyTorch port: the caption tokenizer, the synthetic
datasets, and the webdataset training pipeline (tar shards, samplers, the
MOCOV2 / ONECROP augment with its native C tier, context buckets, and the
prefetcher that stages batches on the device)."""
