"""Loaders: reader output -> batches of tensors on the card, data-parallel
ingestion over per-host shards, the device cache, and checkpoints of the
training state with the input position."""
from petastorm_tpu_torch.loader.checkpoint import CheckpointManager
from petastorm_tpu_torch.loader.device_cache import DeviceCachedDataset
from petastorm_tpu_torch.loader.dtypes import DTypePolicy
from petastorm_tpu_torch.loader.loader import (BatchedDataLoader, DataLoader,
                                               InMemBatchedDataLoader, aligned_steps_per_epoch)
from petastorm_tpu_torch.loader.mesh_loader import (MeshDataLoader, MeshHostLostError,
                                                    MeshReaderFactory)

__all__ = ["BatchedDataLoader", "CheckpointManager", "DataLoader", "DeviceCachedDataset",
           "DTypePolicy", "InMemBatchedDataLoader", "MeshDataLoader", "MeshHostLostError",
           "MeshReaderFactory", "aligned_steps_per_epoch"]
