"""Whole-column image decode for the reader's workers (reference
petastorm_tpu/utils/decode.py:34-150): one native call per image column
where the field and the host allow it, cell by cell through the codec
otherwise."""
from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.codecs import CompressedImageCodec


def native_image_eligible(field, codec) -> bool:
    """True when ``field``'s column can go through the native batch decoder:
    exactly :class:`CompressedImageCodec` (a subclass may override
    ``decode``), uint8, a fully known shape of (H, W) or (H, W, 3|4) (cv2
    decodes a gray image to 2 dimensions, so (H, W, 1) stays on the codec),
    the library built and cv2 importable (the strict mode's contract is
    ``cv2.IMREAD_UNCHANGED``'s output)."""
    if type(codec) is not CompressedImageCodec:
        return False
    shape = field.shape
    if (field.numpy_dtype != np.uint8 or len(shape) not in (2, 3)
            or any(d is None for d in shape)):
        return False
    if len(shape) == 3 and shape[2] not in (3, 4):
        return False
    from petastorm_tpu_torch.codecs import _native_decode_usable
    return _native_decode_usable()


class NativeImageSkipMemo:
    """Per-column backoff of the native batch decoder.

    After a row group in which EVERY cell failed the strict native decode
    (say, gray JPEGs under an RGB field), the column skips the native call
    for ``base`` row groups, then tries again; each further all-fail group
    doubles the skip, up to ``cap``; a success resets it. A column that
    never fits costs one wasted native call every ``cap`` row groups."""

    def __init__(self, base: int = 8, cap: int = 256):
        self._base = base
        self._cap = cap
        self._skip = {}     # column -> row groups left to skip
        self._streak = {}   # column -> consecutive all-fail batches

    def add(self, name: str) -> None:
        streak = self._streak.get(name, 0) + 1
        self._streak[name] = streak
        self._skip[name] = int(min(self._cap, self._base * 2 ** (streak - 1)))

    def discard(self, name: str) -> None:
        self._streak.pop(name, None)
        self._skip.pop(name, None)

    def should_skip(self, name: str) -> bool:
        """True while ``name`` is backing off; counts one row group down."""
        left = self._skip.get(name)
        if left is None:
            return False
        if left <= 0:
            del self._skip[name]   # the countdown is over: try this group
            return False
        self._skip[name] = left - 1
        return True

    def __contains__(self, name: str) -> bool:
        return name in self._skip


def batch_decode_images(field, codec, blobs, skip_memo=None, n_threads=None):
    """A whole image column in one native call, on ``n_threads`` decode
    threads (default :func:`~petastorm_tpu_torch.native.imgcodec.default_threads`).

    Returns ``(rows, n_native)``: the separately allocated uint8 arrays, and
    how many of them the native call decoded (the cells it rejected in its
    strict mode are decoded again by ``codec.decode``, so the output is the
    cv2 path's cell for cell), or None when the native path does not apply:
    the field is not eligible, a cell is null, fewer than 4 rows, or JPEG
    cells on a host whose libjpeg fails the parity check. When EVERY cell
    fails, ``skip_memo.add(field.name)`` and None."""
    if not native_image_eligible(field, codec):
        return None
    if len(blobs) < 4 or any(b is None for b in blobs):
        return None
    from petastorm_tpu_torch.codecs import _is_jpeg_blob, _native_jpeg_parity_ok
    if any(_is_jpeg_blob(b) for b in blobs) and not _native_jpeg_parity_ok():
        return None
    from petastorm_tpu_torch.native import imgcodec
    rows, statuses = imgcodec.decode_image_batch(blobs, field.shape, n_threads=n_threads,
                                                 strict=True)
    if statuses.all():
        if skip_memo is not None:
            skip_memo.add(field.name)
        return None
    if skip_memo is not None:
        skip_memo.discard(field.name)
    failed = np.flatnonzero(statuses)
    for i in failed:
        rows[i] = codec.decode(field, blobs[i])
    return rows, len(rows) - len(failed)
