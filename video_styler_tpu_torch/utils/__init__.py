"""Checkpoint loading (`ckpt`), the reference-to-port converters
(`convert`), local weight sources (`model_config`) and the loaders' host
measures (`host_memory`)."""
