"""Batch augmentation on the device, after staging (the JAX package's
``ops/augment.py``): the host ships compact uint8 batches and the card does
the per-sample randomness.

Each op is split in two. A draw takes an explicit ``torch.Generator`` (on
the images' device) and returns the random choices: the flips, the crop
offsets, the cutout centres, mixup's ``lam``. An apply takes the images and
those draws, and is deterministic. ``random_flip_horizontal``,
``random_crop``, ``cutout`` and ``mixup`` are the two together. Every op
keeps the input's device, shape and dtype, and works on the whole batch at
once: a per-sample crop is one gather, a cutout one mask.

The draws cannot match ``jax.random``'s for a seed, so the ops agree with
the JAX package's given the same draws (bit for bit on uint8), and by their
properties otherwise. The composition in a train step, as the JAX package
writes it::

    gen = seeded_generator((seed, step), images.device)
    x = random_flip_horizontal(gen, batch["image"])
    x = random_crop(gen, x, padding=4)
    x = cutout(gen, x, size=16)
    x = normalize_images(x)            # ops.image_ops, uint8 -> bf16
    x, y = mixup(gen, x, labels, alpha=0.2, num_classes=classes)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: ``jnp.pad`` modes :func:`apply_crop` implements (as index maps, so
#: ``"symmetric"``, which ``torch.nn.functional.pad`` lacks, comes free).
PAD_MODES = ("constant", "edge", "reflect", "symmetric", "wrap")


def seeded_generator(key, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``, an int or a
    tuple of ints such as ``(seed, step)``, through numpy's
    ``SeedSequence`` (nearby keys give unrelated streams)."""
    key = [int(k) for k in (key if isinstance(key, (tuple, list)) else (key,))]
    seed = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def _check_images(images: torch.Tensor):
    if images.dim() != 4:
        raise ValueError(f"images must be (B, H, W, C), got shape {tuple(images.shape)}")


# ------------------------------------------------------------------- flip
def draw_flips(generator: torch.Generator, batch: int, p: float = 0.5, device=None):
    """(batch,) bool: which samples to flip, each with probability ``p``."""
    return torch.rand(batch, generator=generator, device=device) < p


def apply_flip(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Flip along W the samples of a (B, H, W, C) batch where ``flips``."""
    _check_images(images)
    flips = flips.to(device=images.device, dtype=torch.bool)
    return torch.where(flips[:, None, None, None], images.flip(2), images)


def random_flip_horizontal(generator: torch.Generator, images: torch.Tensor,
                           p: float = 0.5) -> torch.Tensor:
    """Per-sample horizontal flip of a (B, H, W, C) batch."""
    return apply_flip(images, draw_flips(generator, images.shape[0], p, images.device))


# ------------------------------------------------------------------- crop
def draw_crop_offsets(generator: torch.Generator, batch: int, padding: int = 4, device=None):
    """(batch, 2) int64: each sample's crop origin ``(oy, ox)`` in the
    padded image, in ``[0, 2 * padding]``."""
    return torch.randint(0, 2 * padding + 1, (batch, 2), generator=generator, device=device)


def _source_index(i: torch.Tensor, n: int, mode: str):
    """The index of the unpadded axis of length ``n`` that padded position
    ``i`` (in unpadded coordinates) reads under ``jnp.pad``'s ``mode``, and
    whether it lies inside (only ``"constant"`` reads outside: zeros)."""
    inside = (i >= 0) & (i < n)
    if mode in ("constant", "edge"):
        return i.clamp(0, n - 1), inside
    if mode == "wrap":
        return torch.remainder(i, n), inside
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i), inside
        period = 2 * (n - 1)
        j = torch.remainder(i, period)
        return torch.where(j >= n, period - j, j), inside
    period = 2 * n   # symmetric: the edge is repeated
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - 1 - j, j), inside


def apply_crop(images: torch.Tensor, offsets: torch.Tensor, padding: int = 4,
               mode: str = "constant") -> torch.Tensor:
    """Pad H and W by ``padding`` (``jnp.pad`` ``mode``) and cut each sample
    back to (H, W) at its ``offsets`` row ``(oy, ox)``: one gather from the
    unpadded batch, no padded copy."""
    _check_images(images)
    if mode not in PAD_MODES:
        raise ValueError(f"mode must be one of {PAD_MODES}, got {mode!r}")
    if padding < 0:
        raise ValueError(f"padding must be >= 0, got {padding}")
    b, h, w, _ = images.shape
    dev = images.device
    offsets = offsets.to(device=dev, dtype=torch.int64)
    rows, rows_in = _source_index(torch.arange(h, device=dev)[None, :]
                                  + offsets[:, :1] - padding, h, mode)
    cols, cols_in = _source_index(torch.arange(w, device=dev)[None, :]
                                  + offsets[:, 1:] - padding, w, mode)
    out = images[torch.arange(b, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    if mode == "constant":
        inside = rows_in[:, :, None, None] & cols_in[:, None, :, None]
        out = torch.where(inside, out, torch.zeros((), dtype=images.dtype, device=dev))
    return out


def random_crop(generator: torch.Generator, images: torch.Tensor, padding: int = 4,
                mode: str = "constant") -> torch.Tensor:
    """Pad-and-crop (the CIFAR/ImageNet ResNet recipe): output shape ==
    input shape."""
    return apply_crop(images, draw_crop_offsets(generator, images.shape[0], padding,
                                                images.device), padding, mode)


# ----------------------------------------------------------------- cutout
def draw_cutout_centres(generator: torch.Generator, batch: int, height: int, width: int,
                        device=None):
    """(batch, 2) int64: each sample's square centre ``(cy, cx)``, uniform
    over the image."""
    cy = torch.randint(0, height, (batch,), generator=generator, device=device)
    cx = torch.randint(0, width, (batch,), generator=generator, device=device)
    return torch.stack([cy, cx], dim=1)


def apply_cutout(images: torch.Tensor, centres: torch.Tensor, size: int = 8,
                 fill=0) -> torch.Tensor:
    """Set to ``fill`` the ``size`` x ``size`` square (clipped at the edges)
    at each sample's ``centres`` row: rows ``[cy - size//2, cy +
    (size+1)//2)``, the same for columns."""
    _check_images(images)
    _, h, w, _ = images.shape
    dev = images.device
    centres = centres.to(device=dev, dtype=torch.int64)
    ys = torch.arange(h, device=dev)[None, :]
    xs = torch.arange(w, device=dev)[None, :]
    cy, cx = centres[:, :1], centres[:, 1:]
    in_y = (ys >= cy - size // 2) & (ys < cy + (size + 1) // 2)
    in_x = (xs >= cx - size // 2) & (xs < cx + (size + 1) // 2)
    inside = in_y[:, :, None, None] & in_x[:, None, :, None]
    return torch.where(inside, torch.tensor(fill, dtype=images.dtype, device=dev), images)


def cutout(generator: torch.Generator, images: torch.Tensor, size: int = 8,
           fill=0) -> torch.Tensor:
    """Set one random ``size`` x ``size`` square per sample to ``fill``."""
    _check_images(images)
    b, h, w, _ = images.shape
    return apply_cutout(images, draw_cutout_centres(generator, b, h, w, images.device),
                        size, fill)


# ------------------------------------------------------------------ mixup
def draw_mixup_lam(generator: torch.Generator, batch: int, alpha: float = 0.2, device=None):
    """(batch,) float32: ``lam ~ Beta(alpha, alpha)``, folded to
    ``max(lam, 1 - lam)`` so each sample stays closer to itself."""
    conc = torch.full((batch, 2), float(alpha), dtype=torch.float32, device=device)
    lam = torch._sample_dirichlet(conc, generator=generator)[:, 0]
    return torch.maximum(lam, 1.0 - lam)


def apply_mixup(images: torch.Tensor, labels: torch.Tensor, lam: torch.Tensor,
                num_classes: int = 0):
    """Convex-combine each sample (and its label) with the previous one in
    the batch (``roll`` by one): ``lam * x + (1 - lam) * partner``, in the
    images' dtype. Integer ``labels`` are one-hot encoded first
    (``num_classes`` required). Returns ``(images, soft_labels)``."""
    if not images.is_floating_point():
        raise ValueError("mixup needs float images (normalize first)")
    if not labels.is_floating_point():
        if not num_classes:
            raise ValueError("num_classes is required for integer labels")
        labels = F.one_hot(labels.long(), num_classes).to(images.dtype)
    lam = lam.to(images.device)
    li = lam[:, None, None, None].to(images.dtype)
    ll = lam[:, None].to(labels.dtype)
    partner = torch.roll(images, 1, 0)
    partner_labels = torch.roll(labels, 1, 0)
    return li * images + (1 - li) * partner, ll * labels + (1 - ll) * partner_labels


def mixup(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
          alpha: float = 0.2, num_classes: int = 0):
    """Batch mixup (Zhang et al. 2017) -> ``(mixed_images,
    mixed_soft_labels)``."""
    if not images.is_floating_point():
        raise ValueError("mixup needs float images (normalize first)")
    return apply_mixup(images, labels, draw_mixup_lam(generator, images.shape[0], alpha,
                                                      images.device), num_classes)
