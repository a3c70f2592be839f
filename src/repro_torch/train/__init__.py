"""Training of the port: the optimizer, the data pipeline, checkpoints,
wire compression and the training loop (``python -m
repro_torch.launch.train``)."""
