"""petastorm_tpu_torch: the PyTorch/CUDA counterpart of ``petastorm_tpu``.

Parquet stores written by either package, read with :func:`make_reader`
(rows, or :class:`NGram` windows of a token store) on decode threads or
spawned decode processes, their row groups chosen by partition filters,
predicates, stored indexes, shards and subsets and their rows reshaped
by a :class:`TransformSpec` in the workers, in a free or a deterministic
order (``sample_order=``), mixed by :class:`WeightedSamplingReader`, batched
and staged onto an NVIDIA GPU by :class:`DataLoader`, or sharded over
simulated hosts or data-parallel ranks by :class:`MeshDataLoader`; any
Parquet store read column by column with :func:`make_batch_reader` and
batched by :class:`BatchedDataLoader` or
:class:`InMemBatchedDataLoader`, or held on the card by
:class:`DeviceCachedDataset`; training checkpointed with its input position by
:class:`CheckpointManager`; and consumed on the card: images are
augmented (``ops.augment``) and normalised by
:func:`normalize_images`, and token windows feed the Llama forward and its
AdamW training step (``models.llama``) on :func:`flash_attention`, whose
gradient runs the flash backward kernels. The normalization and the
attention forward and backward are hand-written CUDA kernels. The package
imports ``torch`` and never ``jax``.

The names below load on first use (module ``__getattr__``): importing a
submodule does not import ``torch``, so the reader's spawned workers run
without it.
"""
import importlib

_EXPORTS = {
    "BatchedDataLoader": "petastorm_tpu_torch.loader",
    "CheckpointManager": "petastorm_tpu_torch.loader",
    "DeviceCachedDataset": "petastorm_tpu_torch.loader",
    "DataLoader": "petastorm_tpu_torch.loader",
    "InMemBatchedDataLoader": "petastorm_tpu_torch.loader",
    "make_batch_reader": "petastorm_tpu_torch.reader",
    "NGram": "petastorm_tpu_torch.ngram",
    "flash_attention": "petastorm_tpu_torch.ops.flash_attn",
    "make_flash_attention": "petastorm_tpu_torch.ops.flash_attn",
    "make_reader": "petastorm_tpu_torch.reader",
    "MetadataError": "petastorm_tpu_torch.errors",
    "MetadataGenerationError": "petastorm_tpu_torch.errors",
    "MeshDataLoader": "petastorm_tpu_torch.loader",
    "MeshHostLostError": "petastorm_tpu_torch.loader",
    "MeshReaderFactory": "petastorm_tpu_torch.loader",
    "NoDataAvailableError": "petastorm_tpu_torch.errors",
    "normalize_images": "petastorm_tpu_torch.ops.image_ops",
    "PetastormTpuError": "petastorm_tpu_torch.errors",
    "SchemaError": "petastorm_tpu_torch.errors",
    "TransformSpec": "petastorm_tpu_torch.transform",
    "Unischema": "petastorm_tpu_torch.unischema",
    "UnischemaField": "petastorm_tpu_torch.unischema",
    "WeightedSamplingReader": "petastorm_tpu_torch.weighted_sampling_reader",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'petastorm_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
