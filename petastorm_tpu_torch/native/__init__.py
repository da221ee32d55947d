"""Native (C++) host components, built with g++ at first use and loaded
through ctypes.

``ringbuf.cpp`` is the shared-memory SPSC ring, the process pool's data
plane; ``imgcodec.cpp`` (:mod:`.imgcodec`) is the batch JPEG/PNG decoder.
Both are copies of the JAX package's sources. :func:`build_native_library`
compiles a source into ``build/torch_native/`` beside the package, named by
a hash of the source and the flags, as ``kernels/build.py`` names the CUDA
libraries. Importing this module never builds anything and never fails:
:func:`ring_available` builds on first call and reports whether the native
ring is usable, and :func:`ring_error` says why not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent.parent / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_BUILD_LOCK = threading.Lock()
_LIB = None
_LIB_ERR: Optional[str] = None


class NativeBuildError(RuntimeError):
    """g++ is missing, or it failed on a native source (the message holds
    the tail of its output)."""


def find_cxx() -> Optional[str]:
    """The ``g++`` on ``PATH``, or None."""
    return shutil.which("g++")


def library_path(src: Path, name: str, ldflags: Sequence[str] = ()) -> Path:
    """Where :func:`build_native_library` puts ``src``'s library: named by
    a hash of the source and of every flag, so an edited source or flag
    never loads a stale library."""
    digest = hashlib.sha256(Path(src).read_bytes())
    digest.update(" ".join((*CXX_FLAGS, *ldflags)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_native_library(src, name: str, ldflags: Sequence[str] = ()) -> str:
    """Compile a C++ source into a shared library with
    ``g++ -O2 -shared -fPIC -std=c++17`` (once: the library is named by
    :func:`library_path`) and return its path. Concurrent builders (the
    workers of a pool) each write their own temporary file and rename it
    into place. Raises :class:`NativeBuildError`."""
    out = library_path(src, name, ldflags)
    if out.exists():
        return str(out)
    cxx = find_cxx()
    if cxx is None:
        raise NativeBuildError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp), *ldflags],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-6:]
        raise NativeBuildError(f"g++ failed on {Path(src).name} (exit {proc.returncode}): "
                               + " | ".join(tail))
    os.replace(tmp, out)  # atomic: concurrent builders agree
    return str(out)


def _bind(lib) -> None:
    u64, u32, vp, cint = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int
    sigs = {
        "pt_ring_open": (vp, [ctypes.c_char_p, u64, cint]),
        "pt_ring_capacity": (u64, [vp]),
        "pt_ring_data_ptr": (vp, [vp]),
        "pt_ring_write2": (cint, [vp, ctypes.c_uint8, vp, u32, cint]),
        "pt_ring_peek": (cint, [vp, ctypes.POINTER(u64), ctypes.POINTER(u32), cint]),
        "pt_ring_advance": (None, [vp]),
        "pt_ring_close_producer": (None, [vp]),
        "pt_ring_free": (None, [vp, cint]),
        "pt_ring_unlink": (cint, [ctypes.c_char_p]),
        "pt_ring_head": (u64, [vp]),
        "pt_ring_tail": (u64, [vp]),
        "pt_ring_set_tail": (None, [vp, u64]),
        "pt_ring_closed": (cint, [vp]),
        "pt_ring_waiting": (u64, [vp]),
    }
    for fn, (restype, argtypes) in sigs.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes


def _load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is None and _LIB_ERR is None:
            try:
                lib = ctypes.CDLL(build_native_library(NATIVE_DIR / "ringbuf.cpp", "ptring",
                                                       ["-lrt"]))
                _bind(lib)
                _LIB = lib
            except (NativeBuildError, OSError) as e:
                _LIB_ERR = str(e)
    return _LIB


def ring_available() -> bool:
    """True when ``ringbuf.cpp`` built and loaded (built on first call)."""
    return _load() is not None


def ring_error() -> Optional[str]:
    """Why the native ring is unavailable (None when it is available)."""
    _load()
    return _LIB_ERR


def resolve_ring_impl() -> str:
    """``"native"`` when the C++ ring builds, else ``"py"``."""
    return "native" if ring_available() else "py"


def make_ring(name: str, capacity: int = 64 << 20, create: bool = True, impl: str = "auto"):
    """Ring factory of the process pool's consumer and worker sides:
    ``"native"`` -> :class:`ShmRing` (C++ atomics), ``"py"`` ->
    :class:`~petastorm_tpu_torch.reader_impl.shm_ring.PyShmRing` (pure
    Python, no compiler), ``"auto"`` -> :func:`resolve_ring_impl`. Both
    sides of one ring must use the same implementation: the pool pins it
    at ``start()`` and hands it to its workers."""
    if impl == "auto":
        impl = resolve_ring_impl()
    if impl == "native":
        return ShmRing(name, capacity=capacity, create=create)
    if impl == "py":
        from petastorm_tpu_torch.reader_impl.shm_ring import PyShmRing
        return PyShmRing(name, capacity=capacity, create=create)
    raise ValueError(f"unknown ring impl {impl!r} (expected 'auto', 'native' or 'py')")


class TimeoutError_(Exception):
    """A blocking ring read or write ran past its timeout."""


class RingClosed(Exception):
    """The ring was closed: a write after ``close_producer()``, or a read
    of a closed and drained ring."""


def _byte_view(payload) -> memoryview:
    view = memoryview(payload)
    return view if view.ndim == 1 and view.format == "B" else view.cast("B")


class ShmRing:
    """One SPSC ring over POSIX shared memory, on the C++ library.

    Producer: :meth:`write_tagged`, :meth:`close_producer`. Consumer:
    :meth:`read_tagged_view` (zero copy, does not advance) and
    :meth:`advance`, :meth:`read_tagged` (copying), :meth:`poll`,
    :meth:`discard_unread`; the raw cursors (:meth:`head`, :meth:`tail`,
    :meth:`set_tail`, :meth:`data_view`) serve
    :class:`~petastorm_tpu_torch.reader_impl.shm_ring.RingReader`.
    """

    def __init__(self, name: str, capacity: int = 64 << 20, create: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native ring unavailable: {_LIB_ERR}")
        self._lib = lib
        self.name = name
        self._handle = lib.pt_ring_open(name.encode(), capacity, 1 if create else 0)
        if not self._handle:
            raise OSError(f"could not {'create' if create else 'attach'} ring {name!r}")
        self._owner = create
        #: Bytes of the data region (PyShmRing has the same attribute).
        self.capacity = lib.pt_ring_capacity(self._handle)
        self._data = (ctypes.c_char * self.capacity).from_address(
            lib.pt_ring_data_ptr(self._handle))

    # ------------------------------------------------------------- producer
    def write_tagged(self, kind: int, payload, timeout_ms: int = -1) -> None:
        """One record of a 1-byte ``kind`` and ``payload`` (any buffer),
        written straight from the payload's memory. Blocks while the ring
        is full (at most ``timeout_ms``; -1 = forever)."""
        import numpy as np
        arr = np.frombuffer(_byte_view(payload), dtype=np.uint8)
        rc = self._lib.pt_ring_write2(self._handle, kind, ctypes.c_void_p(arr.ctypes.data),
                                      arr.nbytes, timeout_ms)
        if rc == -1:
            raise TimeoutError_(f"ring {self.name} write timed out")
        if rc == -2:
            raise ValueError(f"payload of {arr.nbytes} bytes exceeds ring capacity "
                             f"{self.capacity}")
        if rc != 0:
            raise RingClosed(f"ring {self.name} is closed")

    def close_producer(self) -> None:
        self._lib.pt_ring_close_producer(self._handle)

    # ------------------------------------------------------------- consumer
    def _peek(self, timeout_ms: int):
        offset, length = ctypes.c_uint64(), ctypes.c_uint32()
        rc = self._lib.pt_ring_peek(self._handle, ctypes.byref(offset), ctypes.byref(length),
                                    timeout_ms)
        if rc == -1:
            raise TimeoutError_(f"ring {self.name} read timed out")
        if rc == -3:
            raise RingClosed(f"ring {self.name} drained")
        return offset.value, length.value

    def read_tagged_view(self, timeout_ms: int = -1):
        """``(kind, zero-copy payload view)`` of the next record WITHOUT
        advancing; call :meth:`advance` once no view of it is left."""
        offset, length = self._peek(timeout_ms)
        mv = memoryview(self._data).cast("B")[offset:offset + length]
        return mv[0], mv[1:]

    def read_tagged(self, timeout_ms: int = -1):
        """``(kind, payload bytes)`` of the next record, copied out."""
        kind, view = self.read_tagged_view(timeout_ms)
        payload = bytes(view)
        view.release()
        self.advance()
        return kind, payload

    def advance(self) -> None:
        """Consume the record :meth:`read_tagged_view` returned."""
        self._lib.pt_ring_advance(self._handle)

    def poll(self, timeout_ms: int = 0) -> bool:
        """True when a record is ready (does not consume)."""
        try:
            self._peek(timeout_ms)
            return True
        except (TimeoutError_, RingClosed):
            return False

    def discard_unread(self) -> int:
        """Drop every unread record (a dead producer's leftovers); returns
        how many."""
        n = 0
        while self.poll(0):
            self.advance()
            n += 1
        return n

    def data_view(self) -> memoryview:
        """Zero-copy view of the whole data region."""
        return memoryview(self._data)

    def head(self) -> int:
        return int(self._lib.pt_ring_head(self._handle))

    def tail(self) -> int:
        return int(self._lib.pt_ring_tail(self._handle))

    def set_tail(self, value: int) -> None:
        self._lib.pt_ring_set_tail(self._handle, value)

    @property
    def producer_closed(self) -> bool:
        return bool(self._lib.pt_ring_closed(self._handle))

    def waiting(self) -> int:
        """Bytes of the record the producer is blocked on for want of
        space (its aligned size with the length word), else 0."""
        return int(self._lib.pt_ring_waiting(self._handle))

    # ------------------------------------------------------------- lifetime
    def close(self, leak_mapping: bool = False) -> None:
        """Unmap the ring; the creator also unlinks its name. With
        ``leak_mapping`` (views of the ring are still alive: unmapping would
        make them read freed memory) only the name goes, and the mapping
        stays for the process's life."""
        if not self._handle:
            return
        if leak_mapping:
            # The mapping is never unmapped: its views keep ``_data`` alive.
            if self._owner:
                self._lib.pt_ring_unlink(self.name.encode())
            self._handle = self._data = None
            return
        self._data = None
        self._lib.pt_ring_free(self._handle, 1 if self._owner else 0)
        self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
