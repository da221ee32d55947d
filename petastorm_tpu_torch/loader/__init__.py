"""Loaders: reader rows -> batches of tensors on the card."""
from petastorm_tpu_torch.loader.loader import DataLoader

__all__ = ["DataLoader"]
