"""LM training (PyTorch port of `repro/train`): AdamW, the train step and
loop, int8-compressed gradient all-reduce, pipeline parallelism."""
