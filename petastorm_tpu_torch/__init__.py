"""petastorm_tpu_torch: the PyTorch/CUDA counterpart of ``petastorm_tpu``.

Parquet stores written by either package, read with :func:`make_reader`,
batched and staged onto an NVIDIA GPU by :class:`DataLoader`, and
normalised on the card by :func:`normalize_images`, a hand-written CUDA
kernel. The package imports ``torch`` and never ``jax``.
"""
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.ops.image_ops import normalize_images
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ["DataLoader", "make_reader", "normalize_images", "Unischema", "UnischemaField"]
