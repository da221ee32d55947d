"""ctypes wrapper of the native batch image decoder (``imgcodec.cpp``).

The native counterpart of the reference's OpenCV decode (reference
petastorm/codecs.py:58-132): one C call, which holds no GIL, decodes a whole
image column into independently allocated uint8 arrays, with a status per
image so that a cell it cannot take (16-bit PNG, CMYK JPEG, a channel count
other than the field's) goes back to the Python codec alone.

It is built with g++ at first use against the system's libjpeg and libpng
(with libdeflate's PNG fast path when that links too), into
``build/torch_native/``. Importing this module never builds and never
fails: :func:`imgcodec_available` builds and reports, and
:func:`imgcodec_error` says why the decoder is missing.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

from petastorm_tpu_torch.native import NATIVE_DIR, NativeBuildError, build_native_library

OK = 0
ERR_FORMAT = -1
ERR_UNSUPPORTED = -2
ERR_DIMS = -3
ERR_CORRUPT = -4
ERR_ARGS = -5

_BUILD_LOCK = threading.Lock()
_LIB = None
_LIB_ERR: Optional[str] = None
#: Whether the loaded library has libdeflate's PNG fast path.
WITH_DEFLATE: Optional[bool] = None


def _build_library() -> str:
    """Link libdeflate when it is there; without it the JPEG path and
    libpng's PNG path still build."""
    global WITH_DEFLATE
    src = NATIVE_DIR / "imgcodec.cpp"
    try:
        path = build_native_library(src, "ptimg",
                                    ["-DPT_HAVE_DEFLATE", "-ljpeg", "-lpng", "-ldeflate"])
        WITH_DEFLATE = True
    except NativeBuildError:
        path = build_native_library(src, "ptimg_nodeflate", ["-ljpeg", "-lpng"])
        WITH_DEFLATE = False
    return path


def _load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is None and _LIB_ERR is None:
            try:
                lib = ctypes.CDLL(_build_library())
                vp, cint, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
                pint = ctypes.POINTER(cint)
                lib.pt_img_probe.restype = cint
                lib.pt_img_probe.argtypes = [vp, u64, pint, pint, pint]
                lib.pt_img_decode.restype = cint
                lib.pt_img_decode.argtypes = [vp, u64, vp, cint, cint, cint, cint]
                lib.pt_img_decode_batch_ptrs.restype = cint
                lib.pt_img_decode_batch_ptrs.argtypes = [
                    ctypes.POINTER(vp), ctypes.POINTER(u64), cint, ctypes.POINTER(vp),
                    cint, cint, cint, cint, cint, pint]
                _LIB = lib
            except (NativeBuildError, OSError) as e:
                _LIB_ERR = str(e)
    return _LIB


def imgcodec_available() -> bool:
    """True when ``imgcodec.cpp`` built and loaded (built on first call)."""
    return _load() is not None


def imgcodec_error() -> Optional[str]:
    """Why the native decoder is unavailable (None when it is available)."""
    _load()
    return _LIB_ERR


def _as_uint8_array(blob) -> np.ndarray:
    """Zero-copy 1-D uint8 view of bytes, a memoryview or an array."""
    if isinstance(blob, np.ndarray):
        return blob.reshape(-1).view(np.uint8)
    return np.frombuffer(blob, dtype=np.uint8)


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native image codec unavailable: {_LIB_ERR}")
    return lib


def probe(blob) -> Optional[tuple]:
    """``(height, width, channels)`` from the encoded header (channels as
    decoded: a palette PNG gives 3), or None when the blob is not a
    decodable 8-bit JPEG or PNG."""
    lib = _require()
    arr = _as_uint8_array(blob)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.pt_img_probe(ctypes.c_void_p(arr.ctypes.data), arr.nbytes,
                          ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    return (h.value, w.value, c.value) if rc == OK else None


def decode_image(blob, shape: tuple, strict: bool = False) -> np.ndarray:
    """One JPEG/PNG blob as a uint8 array of ``shape`` ((H, W) or
    (H, W, C)). ``strict=True`` fails on a source whose own channel count
    differs from the requested one instead of converting it
    (``cv2.IMREAD_UNCHANGED`` parity). Raises ``ValueError`` when the
    decode fails."""
    lib = _require()
    h, w = int(shape[0]), int(shape[1])
    c = int(shape[2]) if len(shape) == 3 else 1
    out = np.empty(tuple(int(d) for d in shape), dtype=np.uint8)
    arr = _as_uint8_array(blob)
    rc = lib.pt_img_decode(ctypes.c_void_p(arr.ctypes.data), arr.nbytes,
                           ctypes.c_void_p(out.ctypes.data), h, w, c, 1 if strict else 0)
    if rc != OK:
        raise ValueError(f"native image decode failed (status {rc})")
    return out


def default_threads() -> int:
    """Decode threads of one batch call: ``min(4, cores)``. Callers that
    already run one decode per core (the reader's workers) pass fewer."""
    return min(4, os.cpu_count() or 1)


def decode_image_batch(blobs: Sequence, shape: tuple, n_threads: Optional[int] = None,
                       strict: bool = False):
    """Decode ``blobs`` into arrays of ``shape`` in one C call on
    ``n_threads`` threads (default :func:`default_threads`).

    Returns ``(images, statuses)``: a list of separately allocated arrays
    (keeping one does not keep the others) and an int32 array with 0 for
    each image decoded; an image with another status holds garbage and must
    be decoded by the caller's fallback."""
    lib = _require()
    n = len(blobs)
    h, w = int(shape[0]), int(shape[1])
    c = int(shape[2]) if len(shape) == 3 else 1
    statuses = np.zeros(n, dtype=np.int32)
    images = [np.empty(tuple(int(d) for d in shape), dtype=np.uint8) for _ in range(n)]
    if n == 0:
        return images, statuses
    arrs = [_as_uint8_array(b) for b in blobs]   # alive for the call
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrs])
    sizes = (ctypes.c_uint64 * n)(*[a.nbytes for a in arrs])
    outs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
    lib.pt_img_decode_batch_ptrs(
        ptrs, sizes, n, outs, h, w, c,
        default_threads() if n_threads is None else int(n_threads), 1 if strict else 0,
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return images, statuses
