"""The port's models: Wan DiT, VACE branch, umT5 encoder, Wan2.1 VAE."""
