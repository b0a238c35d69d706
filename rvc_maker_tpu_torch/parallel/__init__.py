"""Multi-rank training and conversion over torch.distributed (JAX `parallel/`)."""
