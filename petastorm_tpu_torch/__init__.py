"""petastorm_tpu_torch: the PyTorch/CUDA counterpart of ``petastorm_tpu``.

Parquet stores written by either package, read with :func:`make_reader`
(rows, or :class:`NGram` windows of a token store), batched and staged onto
an NVIDIA GPU by :class:`DataLoader`, and consumed on the card: images are
normalised by :func:`normalize_images`, and token windows feed the Llama
forward and its AdamW training step (``models.llama``) on
:func:`flash_attention`, whose gradient runs the flash backward kernels.
All of these are hand-written CUDA kernels. The package imports ``torch``
and never ``jax``.
"""
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops.flash_attn import flash_attention, make_flash_attention
from petastorm_tpu_torch.ops.image_ops import normalize_images
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

__all__ = ["DataLoader", "NGram", "flash_attention", "make_flash_attention", "make_reader",
           "normalize_images", "Unischema", "UnischemaField"]
