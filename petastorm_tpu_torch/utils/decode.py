"""Whole-column decodes for the reader's workers (reference
petastorm_tpu/utils/decode.py): an image column in one native call where the
field and the host allow it, a scalar column in one vectorized cast, an
``NdarrayCodec`` column from one parsed header into one array, anything else
cell by cell through the codec; and one storage row decoded by a schema's
codecs (:func:`decode_row`, for ``spark.spark_utils.dataset_as_rdd``)."""
from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,
                                        NdarrayCodec, ScalarCodec, npy_header_meta)

# The built-in codecs take the memoryview cells of the zero-copy read path.
# Exact types only: a subclass that overrides decode() may rely on the
# documented bytes.
_MEMORYVIEW_SAFE_CODECS = (ScalarCodec, NdarrayCodec, CompressedNdarrayCodec,
                           CompressedImageCodec)


def is_memoryview_safe(codec) -> bool:
    """True when ``codec`` is a built-in that accepts memoryview cells."""
    return type(codec) in _MEMORYVIEW_SAFE_CODECS


def codec_safe_value(codec, value):
    """A memoryview cell as bytes for a codec outside the built-ins (a user
    codec sees the documented bytes), else the cell as it is."""
    if isinstance(value, memoryview) and not is_memoryview_safe(codec):
        return bytes(value)
    return value


def batch_decode_scalars(field, codec, src, indices):
    """A plain numeric :class:`ScalarCodec` column in one vectorized select
    and cast (the same numpy values, cell for cell, as the per-cell decode),
    or None where it does not apply: another codec type (exactly
    ``ScalarCodec``), a non-scalar field, a column that did not arrive as a
    numeric array (nulls, strings), or a non-numeric declared type."""
    if type(codec) is not ScalarCodec or field.shape != ():
        return None
    if not isinstance(src, np.ndarray) or src.dtype.kind not in "biuf":
        return None
    try:
        npdt = np.dtype(field.numpy_dtype)
    except TypeError:
        return None   # str/bytes/Decimal declarations
    if npdt.kind not in "biuf":
        return None
    sel = src[np.asarray(indices, dtype=np.intp)]
    return sel if sel.dtype == npdt else sel.astype(npdt)


def batch_decode_ndarrays(field, codec, src, indices):
    """An :class:`NdarrayCodec` column decoded from one parsed ``.npy``
    header into one ``(n, *shape)`` array, one ``frombuffer`` copy a cell.
    Applies where every selected cell (at least two) is a non-null buffer of
    one length with byte-identical headers, C order and a non-object dtype,
    and the codec is exactly ``NdarrayCodec``; else None (the per-cell decode
    takes the column). The rows are views of one allocation: a row kept
    keeps its group's column."""
    if type(codec) is not NdarrayCodec:
        return None
    n = len(indices)
    if n < 2:
        return None
    try:
        cells = [src[i] for i in indices]
    except (TypeError, IndexError):
        return None
    first = cells[0]
    if first is None or not isinstance(first, (bytes, memoryview)):
        return None
    meta = npy_header_meta(first)
    if meta is None:
        return None
    dtype, fortran, shape, data_off = meta
    if fortran or dtype.hasobject:
        return None
    cell_len = len(first)
    header = bytes(memoryview(first)[:data_off])
    for c in cells[1:]:
        if c is None or len(c) != cell_len or bytes(memoryview(c)[:data_off]) != header:
            return None
    count = 1
    for dim in shape:
        count *= dim
    out = np.empty((n,) + shape, dtype=dtype)
    flat = out.reshape(n, -1) if count else out.reshape(n, 0)
    for j, c in enumerate(cells):
        flat[j] = np.frombuffer(c, dtype=dtype, offset=data_off, count=count)
    return out


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


def decode_row(row: dict, schema) -> dict:
    """One storage row dict decoded into numpy values by ``schema``'s
    codecs. Fields of ``row`` that ``schema`` (a view, say) lacks are left
    out; ``None`` cells stay ``None``; binary cells that arrive as
    memoryviews are decoded from their bytes."""
    decoded = {}
    for name, field, codec in schema.decode_plan:
        if name not in row:
            continue
        value = row[name]
        if isinstance(value, memoryview):
            value = bytes(value)
        decoded[name] = None if value is None else codec.decode(field, value)
    return decoded
