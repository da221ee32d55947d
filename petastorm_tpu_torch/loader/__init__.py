"""Loaders: reader output -> batches of tensors on the card."""
from petastorm_tpu_torch.loader.dtypes import DTypePolicy
from petastorm_tpu_torch.loader.loader import (BatchedDataLoader, DataLoader,
                                               InMemBatchedDataLoader, aligned_steps_per_epoch)

__all__ = ["BatchedDataLoader", "DataLoader", "DTypePolicy", "InMemBatchedDataLoader",
           "aligned_steps_per_epoch"]
