"""Per-field storage codecs: encode at write time, decode in reader workers.

A codec maps between a field's in-memory value (numpy array or scalar) and
its Parquet cell (a primitive scalar or a binary blob). Decoded values are
always numpy; the loader turns batches into tensors. Codecs serialize to
JSON (``codec_to_dict``/``codec_from_dict``) under the same names the JAX
package uses, so dataset metadata is shared between the two packages.

Images decode through the native decoder (``native/imgcodec.cpp``) where a
one-time check allows it, else through OpenCV (Pillow when cv2 is missing),
as the JAX package decodes them, so both packages produce the same pixels.
"""
from __future__ import annotations

import io
from decimal import Decimal

import numpy as np

from petastorm_tpu_torch.errors import SchemaError

__all__ = [
    "DataframeColumnCodec", "ScalarCodec", "NdarrayCodec",
    "CompressedNdarrayCodec", "CompressedImageCodec",
    "codec_to_dict", "codec_from_dict", "register_codec", "npy_header_meta",
]


class DataframeColumnCodec:
    """Base codec interface."""

    def encode(self, unischema_field, value):
        raise NotImplementedError

    def decode(self, unischema_field, encoded):
        raise NotImplementedError

    def arrow_type(self, unischema_field):
        """The Arrow storage type of the encoded cell."""
        raise NotImplementedError

    def spark_type(self, unischema_field):
        """The Spark storage type of the encoded cell (imports pyspark)."""
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"type": type(self).__name__}

    @classmethod
    def from_dict(cls, doc: dict):
        return cls()

    def __repr__(self):
        return type(self).__name__ + "()"

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash(type(self).__name__)


def _check_shape_compliance(unischema_field, value: np.ndarray):
    """Raise unless ``value.shape`` matches the declared shape (None = any)."""
    expected = unischema_field.shape
    if len(expected) != value.ndim:
        raise SchemaError(
            f"Field {unischema_field.name!r}: rank mismatch, declared {expected} "
            f"but value has shape {value.shape}")
    for want, got in zip(expected, value.shape):
        if want is not None and want != got:
            raise SchemaError(
                f"Field {unischema_field.name!r}: shape mismatch, declared {expected} "
                f"but value has shape {value.shape}")


def _check_dtype_compliance(unischema_field, value: np.ndarray):
    declared = np.dtype(unischema_field.numpy_dtype)
    if value.dtype == declared:
        return
    # Zero-width flexible dtypes (|S0 / <U0) declare "bytes/str of any
    # width": compare by kind. Explicit widths stay exact.
    if (declared.kind in ("S", "U") and declared.itemsize == 0
            and value.dtype.kind == declared.kind):
        return
    raise SchemaError(
        f"Field {unischema_field.name!r}: dtype mismatch, declared {declared} "
        f"but value has dtype {value.dtype}")


class ScalarCodec(DataframeColumnCodec):
    """Identity codec for scalar fields; stores the native Parquet scalar
    type. ``storage_dtype`` overrides the column's storage type (a numpy
    dtype, ``str``, ``bytes`` or ``Decimal``)."""

    def __init__(self, storage_dtype=None):
        self.storage_dtype = storage_dtype

    def encode(self, unischema_field, value):
        if not unischema_field.is_scalar:
            raise SchemaError(f"ScalarCodec on non-scalar field {unischema_field.name!r} "
                              f"(shape {unischema_field.shape})")
        dt = self.storage_dtype or unischema_field.numpy_dtype
        if dt in (str, np.str_):
            return str(value)
        if dt in (bytes, np.bytes_):
            return bytes(value)
        if dt is Decimal:
            return Decimal(value) if not isinstance(value, Decimal) else value
        npdt = np.dtype(dt)
        if npdt.kind == "M":  # datetime64 passes through; arrow handles it
            return value
        # Reject silently-lossy casts (e.g. a float into an int field).
        value_dtype = np.asarray(value).dtype
        if np.issubdtype(npdt, np.integer) and not np.issubdtype(value_dtype, np.integer) \
                and not np.issubdtype(value_dtype, np.bool_):
            raise SchemaError(f"Field {unischema_field.name!r}: will not cast "
                              f"{value_dtype} value to integer storage")
        return np.array(value).astype(npdt).item()

    def decode(self, unischema_field, encoded):
        dt = unischema_field.numpy_dtype
        if dt in (bytes, np.bytes_):
            # Zero-copy reads hand binary cells in as memoryviews.
            return bytes(encoded) if isinstance(encoded, memoryview) else encoded
        if dt in (str, np.str_, Decimal):
            return encoded
        npdt = np.dtype(dt)
        if npdt.kind == "M":
            return encoded
        return npdt.type(encoded)

    def arrow_type(self, unischema_field):
        import pyarrow as pa
        dt = self.storage_dtype or unischema_field.numpy_dtype
        if dt in (str, np.str_):
            return pa.string()
        if dt in (bytes, np.bytes_):
            return pa.binary()
        if dt is Decimal:
            return pa.decimal128(38, 18)
        npdt = np.dtype(dt)
        if npdt.kind == "M":
            return pa.timestamp("ns")
        return pa.from_numpy_dtype(npdt)

    def spark_type(self, unischema_field):
        from pyspark.sql import types as T
        dt = self.storage_dtype or unischema_field.numpy_dtype
        if dt in (str, np.str_):
            return T.StringType()
        if dt in (bytes, np.bytes_):
            return T.BinaryType()
        if dt is Decimal:
            return T.DecimalType(38, 18)
        npdt = np.dtype(dt)
        if npdt.kind == "M":
            return T.TimestampType()
        # Spark has no unsigned types: each widens to a signed one that holds it.
        mapping = {np.int8: T.ByteType, np.int16: T.ShortType, np.int32: T.IntegerType,
                   np.int64: T.LongType, np.uint8: T.ShortType, np.uint16: T.IntegerType,
                   np.uint32: T.LongType, np.uint64: T.LongType,
                   np.float32: T.FloatType, np.float64: T.DoubleType, np.bool_: T.BooleanType}
        for k, v in mapping.items():
            if npdt == np.dtype(k):
                return v()
        raise ValueError(f"No Spark type mapping for {dt}")

    def to_dict(self):
        from petastorm_tpu_torch.unischema import _dtype_name
        return {"type": "ScalarCodec",
                "storage_dtype": _dtype_name(self.storage_dtype) if self.storage_dtype is not None else None}

    @classmethod
    def from_dict(cls, doc):
        from petastorm_tpu_torch.unischema import _dtype_from_name
        sd = doc.get("storage_dtype")
        return cls(_dtype_from_name(sd) if sd else None)

    def __repr__(self):
        return f"ScalarCodec({self.storage_dtype!r})" if self.storage_dtype is not None else "ScalarCodec()"


# Parsed ``.npy`` headers: every cell of a field shares its header bytes, so
# the literal_eval parse happens once, not once a row.
_NPY_HEADER_CACHE: dict = {}


def npy_header_meta(encoded):
    """``(dtype, fortran_order, shape, data_offset)`` of one ``.npy`` cell
    (bytes or a memoryview), or None when it is not a well-formed npy
    stream. The per-cell and the whole-column decodes
    (:func:`petastorm_tpu_torch.utils.decode.batch_decode_ndarrays`) parse
    through it."""
    import ast
    if isinstance(encoded, memoryview) and encoded.format != "B":
        # Arrow buffers' memoryviews are signed: compare as unsigned bytes.
        encoded = encoded.cast("B")
    if len(encoded) < 10 or encoded[:6] != b"\x93NUMPY":
        return None
    if encoded[6] == 1:
        hlen, off = int.from_bytes(encoded[8:10], "little"), 10
    else:
        hlen, off = int.from_bytes(encoded[8:12], "little"), 12
    header = bytes(encoded[off:off + hlen])
    meta = _NPY_HEADER_CACHE.get(header)
    if meta is None:
        d = ast.literal_eval(header.decode("latin1"))
        meta = (np.dtype(d["descr"]), d["fortran_order"], tuple(d["shape"]))
        if len(_NPY_HEADER_CACHE) < 4096:
            _NPY_HEADER_CACHE[header] = meta
    dtype, fortran, shape = meta
    return dtype, fortran, shape, off + hlen


def _fast_npy_decode(encoded):
    """``.npy`` bytes decoded through the cached header and one copy; None
    where ``np.load`` must decode (Fortran order, object dtype, a header it
    does not parse), as in the JAX package."""
    meta = npy_header_meta(encoded)
    if meta is None:
        return None
    dtype, fortran, shape, data_off = meta
    if fortran or dtype.hasobject:
        return None
    count = 1
    for dim in shape:
        count *= dim
    # A view of the source bytes, copied so the caller may write into it.
    return np.frombuffer(encoded, dtype=dtype, offset=data_off, count=count).reshape(shape).copy()


def _fast_npz_decode(encoded):
    """The single ``arr.npy`` member of an ``np.savez_compressed`` cell,
    without the zipfile machinery: the zip local header parsed, the deflate
    stream inflated, the member's CRC-32 checked, then
    :func:`_fast_npy_decode`. None for any other layout (another member
    name, a stored or encrypted entry) or a corrupt or truncated stream,
    which ``np.load`` decodes or reports itself."""
    import struct
    import zlib
    mv = memoryview(encoded)
    if mv.format != "B":
        mv = mv.cast("B")
    if len(mv) < 30 or mv[:4] != b"PK\x03\x04":
        return None
    (_, _, flags, method, _, _, header_crc, _, _, nlen, elen) = \
        struct.unpack_from("<IHHHHHIIIHH", mv, 0)
    if flags & 0x1 or method != 8:
        return None
    name_end = 30 + nlen
    if bytes(mv[30:name_end]) != b"arr.npy":
        return None
    d = zlib.decompressobj(-15)
    try:
        npy = d.decompress(mv[name_end + elen:])
    except zlib.error:
        return None
    if not d.eof:
        return None
    # With flag bit 3 the CRC follows the stream (in an optionally signed
    # data descriptor), else it is in the local header.
    if flags & 0x8:
        tail = d.unused_data
        if tail[:4] == b"PK\x07\x08":
            tail = tail[4:]
        if len(tail) < 4:
            return None
        expected_crc = int.from_bytes(tail[:4], "little")
    else:
        expected_crc = header_crc
    if zlib.crc32(npy) != expected_crc:
        return None
    fast = _fast_npy_decode(npy)
    if fast is not None:
        return fast
    return np.load(io.BytesIO(npy), allow_pickle=False)


class NdarrayCodec(DataframeColumnCodec):
    """Stores an ndarray as uncompressed ``.npy`` bytes."""

    def encode(self, unischema_field, value):
        value = np.asarray(value)
        _check_dtype_compliance(unischema_field, value)
        _check_shape_compliance(unischema_field, value)
        buf = io.BytesIO()
        np.save(buf, value, allow_pickle=False)
        return buf.getvalue()

    def decode(self, unischema_field, encoded):
        fast = _fast_npy_decode(encoded)
        if fast is not None:
            return fast
        return np.load(io.BytesIO(encoded), allow_pickle=False)

    def arrow_type(self, unischema_field):
        import pyarrow as pa
        return pa.binary()

    def spark_type(self, unischema_field):
        from pyspark.sql import types as T
        return T.BinaryType()


class CompressedNdarrayCodec(NdarrayCodec):
    """Stores an ndarray as zlib-compressed ``.npz`` bytes."""

    def encode(self, unischema_field, value):
        value = np.asarray(value)
        _check_dtype_compliance(unischema_field, value)
        _check_shape_compliance(unischema_field, value)
        buf = io.BytesIO()
        np.savez_compressed(buf, arr=value)
        return buf.getvalue()

    def decode(self, unischema_field, encoded):
        fast = _fast_npz_decode(encoded)
        if fast is not None:
            return fast
        with np.load(io.BytesIO(encoded), allow_pickle=False) as z:
            return z["arr"]


_NATIVE_DECODE_USABLE = None
_NATIVE_JPEG_OK = None


def _native_decode_usable() -> bool:
    """The native decoder is used only where cv2 imports (its output is
    held to cv2's; a host with Pillow alone keeps Pillow's) and the library
    built (reference petastorm_tpu/codecs.py:363)."""
    global _NATIVE_DECODE_USABLE
    if _NATIVE_DECODE_USABLE is None:
        try:
            import cv2  # noqa: F401
        except ImportError:
            _NATIVE_DECODE_USABLE = False
        else:
            from petastorm_tpu_torch.native import imgcodec
            _NATIVE_DECODE_USABLE = imgcodec.imgcodec_available()
    return _NATIVE_DECODE_USABLE


def _native_jpeg_parity_ok() -> bool:
    """One check per process: may JPEG go through the native decoder?

    PNG decodes exactly by construction, but a JPEG's inverse DCT is the
    implementation's: a system libjpeg other than cv2's could move pixels
    by one step, so the two decode paths would disagree. Three probe
    images (cv2 baseline, cv2 progressive and, where Pillow imports, a
    Pillow 4:2:2 stream) must decode natively to cv2's pixels bit for bit,
    or native JPEG decode stays off in this process; PNG stays on
    (reference petastorm_tpu/codecs.py:378-430)."""
    global _NATIVE_JPEG_OK
    if _NATIVE_JPEG_OK is None:
        try:
            import cv2
            from petastorm_tpu_torch.native import imgcodec
            rng = np.random.default_rng(20260730)
            grad = np.linspace(0, 255, 64, dtype=np.uint8)
            img = np.stack([np.tile(grad, (64, 1)), np.tile(grad[:, None], (1, 64)),
                            rng.integers(0, 256, (64, 64), dtype=np.uint8)], axis=-1)
            blobs = []
            for extra in ([], [int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1]):
                ok, enc = cv2.imencode(".jpg", img[..., ::-1],
                                       [int(cv2.IMWRITE_JPEG_QUALITY), 85, *extra])
                if ok:
                    blobs.append(enc.tobytes())
            try:
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG", quality=92, subsampling=1)
                blobs.append(buf.getvalue())
            except ImportError:
                pass
            ok = len(blobs) >= 2   # baseline and progressive
            for blob in blobs:
                ref = cv2.cvtColor(cv2.imdecode(np.frombuffer(blob, np.uint8),
                                                cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB)
                native = imgcodec.decode_image(blob, (64, 64, 3), strict=True)
                ok = ok and np.array_equal(native, ref)
            _NATIVE_JPEG_OK = bool(ok)
        except Exception:  # noqa: BLE001 - any failure of the check turns it off
            _NATIVE_JPEG_OK = False
    return _NATIVE_JPEG_OK


def decode_verdict():
    """``(native usable, JPEG parity)`` of this process, probed once."""
    usable = _native_decode_usable()
    return usable, usable and _native_jpeg_parity_ok()


def pin_decode_verdict(verdict) -> None:
    """Adopt another process's :func:`decode_verdict` on the same host (the
    reader's, in its spawned workers) instead of probing again: a worker
    neither retries a build that failed nor re-runs the parity check."""
    global _NATIVE_DECODE_USABLE, _NATIVE_JPEG_OK
    _NATIVE_DECODE_USABLE, _NATIVE_JPEG_OK = bool(verdict[0]), bool(verdict[1])


def _is_jpeg_blob(encoded) -> bool:
    return bytes(memoryview(encoded)[:2]) == b"\xff\xd8"


def native_decode_status() -> dict:
    """What decides the image decode path in this process: whether cv2
    imports, whether the native library built (and why not), with or
    without libdeflate, and the JPEG parity check's verdict."""
    from petastorm_tpu_torch.native import imgcodec
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    built = imgcodec.imgcodec_available()
    return {"cv2": has_cv2, "native_built": built, "native_error": imgcodec.imgcodec_error(),
            "libdeflate": imgcodec.WITH_DEFLATE if built else None,
            "native_usable": _native_decode_usable(),
            "jpeg_parity": _native_jpeg_parity_ok() if _native_decode_usable() else False}


class CompressedImageCodec(DataframeColumnCodec):
    """png/jpeg compression for uint8 RGB ``(H, W, 3)`` or grayscale
    ``(H, W)`` images. OpenCV is BGR-native, so channels are swapped on the
    way in and out; Pillow is used when OpenCV is missing."""

    def __init__(self, image_codec: str = "png", quality: int = 80):
        if image_codec not in ("png", "jpeg", "jpg"):
            raise ValueError(f"image_codec must be png or jpeg, got {image_codec!r}")
        self.image_codec = "jpeg" if image_codec == "jpg" else image_codec
        self.quality = quality

    def encode(self, unischema_field, value):
        value = np.asarray(value)
        if value.dtype != np.uint8:
            raise SchemaError(f"Field {unischema_field.name!r}: CompressedImageCodec requires "
                              f"uint8, got {value.dtype}")
        _check_shape_compliance(unischema_field, value)
        try:
            import cv2
        except ImportError:
            from PIL import Image
            buf = io.BytesIO()
            Image.fromarray(value).save(buf, format=self.image_codec.upper(),
                                        quality=self.quality)
            return buf.getvalue()
        bgr = value[..., ::-1] if value.ndim == 3 else value
        ext = ".png" if self.image_codec == "png" else ".jpg"
        params = [] if self.image_codec == "png" else [int(cv2.IMWRITE_JPEG_QUALITY), self.quality]
        ok, enc = cv2.imencode(ext, np.ascontiguousarray(bgr), params)
        if not ok:
            raise SchemaError(f"Field {unischema_field.name!r}: image encode failed")
        return enc.tobytes()

    def decode(self, unischema_field, encoded):
        # The native decoder in strict mode (cv2.IMREAD_UNCHANGED parity): a
        # source it cannot reproduce as cv2 would (alpha, 16 bits, CMYK)
        # fails and cv2 decides what the blob is.
        if _native_decode_usable() and (not _is_jpeg_blob(encoded) or _native_jpeg_parity_ok()):
            from petastorm_tpu_torch.native import imgcodec
            dims = imgcodec.probe(encoded)
            if dims is not None and dims[2] in (1, 3, 4):
                try:
                    return imgcodec.decode_image(
                        encoded, dims[:2] if dims[2] == 1 else dims, strict=True)
                except ValueError:
                    pass
        try:
            import cv2
        except ImportError:
            from PIL import Image
            return np.asarray(Image.open(io.BytesIO(encoded)))
        img = cv2.imdecode(np.frombuffer(encoded, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise SchemaError(f"Field {unischema_field.name!r}: image decode failed")
        if img.ndim == 3:
            code = cv2.COLOR_BGRA2RGBA if img.shape[2] == 4 else cv2.COLOR_BGR2RGB
            img = cv2.cvtColor(img, code)
        return img

    def arrow_type(self, unischema_field):
        import pyarrow as pa
        return pa.binary()

    def spark_type(self, unischema_field):
        from pyspark.sql import types as T
        return T.BinaryType()

    def to_dict(self):
        return {"type": "CompressedImageCodec", "image_codec": self.image_codec,
                "quality": self.quality}

    @classmethod
    def from_dict(cls, doc):
        return cls(doc.get("image_codec", "png"), doc.get("quality", 80))

    def __repr__(self):
        return f"CompressedImageCodec({self.image_codec!r}, quality={self.quality})"


# ----------------------------------------------------------------- registry
_CODEC_REGISTRY = {
    "ScalarCodec": ScalarCodec,
    "NdarrayCodec": NdarrayCodec,
    "CompressedNdarrayCodec": CompressedNdarrayCodec,
    "CompressedImageCodec": CompressedImageCodec,
}


def register_codec(cls):
    """Register a user codec class (a :class:`DataframeColumnCodec` with
    ``to_dict``/``from_dict``) by its class name, so stores that name it in
    their metadata read back. Returns ``cls`` (usable as a decorator)."""
    _CODEC_REGISTRY[cls.__name__] = cls
    return cls


def codec_to_dict(codec) -> dict | None:
    if codec is None:
        return None
    return codec.to_dict()


def codec_from_dict(doc) -> DataframeColumnCodec | None:
    if doc is None:
        return None
    name = doc["type"]
    if name not in _CODEC_REGISTRY:
        raise ValueError(f"Unknown codec type {name!r}; register it with register_codec().")
    return _CODEC_REGISTRY[name].from_dict(doc)
