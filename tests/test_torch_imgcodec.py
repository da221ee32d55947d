"""The port's native image decoder (``petastorm_tpu_torch.native.imgcodec``),
its gate in ``codecs.py`` and ``utils.decode.batch_decode_images``, held
bit for bit to the JAX package's decoder and to cv2 on the same blobs,
following the JAX package's ``tests/test_native_imgcodec.py``: PNG, JPEG at
q85 and q90 (baseline and progressive), gray, RGBA, corrupt cells, shapes
that do not match, the skip memo, the JPEG parity gate on and off, and the
row worker's counts of what each decoder took."""
import io

import numpy as np
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu.native import imgcodec as jax_imgcodec
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu.utils.decode import batch_decode_images as jax_batch_decode_images
from petastorm_tpu_torch import codecs
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.native import NativeBuildError, imgcodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.utils.decode import (NativeImageSkipMemo, batch_decode_images,
                                              native_image_eligible)

cv2 = pytest.importorskip("cv2")


def _field(shape, codec=None, field_cls=UnischemaField):
    return field_cls("image", np.uint8, shape, codec or CompressedImageCodec("png"), False)


def _png(img):
    ok, enc = cv2.imencode(".png", img[..., ::-1] if img.ndim == 3 else img)
    assert ok
    return enc.tobytes()


def _jpeg(img, quality=90, progressive=False):
    params = [int(cv2.IMWRITE_JPEG_QUALITY), quality]
    if progressive:
        params += [int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1]
    ok, enc = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img, params)
    assert ok
    return enc.tobytes()


def _cv2(blob):
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = cv2.cvtColor(ref, cv2.COLOR_BGRA2RGBA if ref.shape[2] == 4 else cv2.COLOR_BGR2RGB)
    return ref


@pytest.fixture(scope="module")
def rgb():
    rng = np.random.default_rng(7)
    return cv2.GaussianBlur(rng.integers(0, 255, (48, 64, 3)).astype(np.uint8), (5, 5), 2)


def _rgba():
    return np.random.default_rng(5).integers(0, 255, (20, 24, 4)).astype(np.uint8)


def _gray():
    return cv2.GaussianBlur(np.random.default_rng(3).integers(0, 255, (32, 40)).astype(np.uint8),
                            (5, 5), 2)


BLOBS = {
    "png rgb": lambda rgb: (_png(rgb), rgb.shape),
    "png gray": lambda rgb: (_png(_gray()), (32, 40)),
    "png rgba": lambda rgb: (cv2.imencode(".png", cv2.cvtColor(_rgba(), cv2.COLOR_RGBA2BGRA))[1]
                             .tobytes(), (20, 24, 4)),
    "jpeg q85": lambda rgb: (_jpeg(rgb, 85), rgb.shape),
    "jpeg q90": lambda rgb: (_jpeg(rgb, 90), rgb.shape),
    "jpeg q85 progressive": lambda rgb: (_jpeg(rgb, 85, True), rgb.shape),
    "jpeg q90 progressive": lambda rgb: (_jpeg(rgb, 90, True), rgb.shape),
    "jpeg gray": lambda rgb: (_jpeg(_gray(), 90), (32, 40)),
}


def test_the_decoder_builds_here_with_libdeflate():
    """The sandbox has g++, libjpeg, libpng and libdeflate."""
    assert imgcodec.imgcodec_available(), imgcodec.imgcodec_error()
    assert imgcodec.imgcodec_error() is None and imgcodec.WITH_DEFLATE is True
    assert codecs.native_decode_status()["native_usable"]


@pytest.mark.parametrize("case", sorted(BLOBS))
def test_decode_equals_the_jax_package_and_cv2(rgb, case):
    blob, shape = BLOBS[case](rgb)
    got = imgcodec.decode_image(blob, shape, strict=True)
    np.testing.assert_array_equal(got, jax_imgcodec.decode_image(blob, shape, strict=True))
    np.testing.assert_array_equal(got, _cv2(blob))
    assert imgcodec.probe(blob) == jax_imgcodec.probe(blob) == (
        shape if len(shape) == 3 else (*shape, 1))
    images, statuses = imgcodec.decode_image_batch([blob, memoryview(blob)] * 3, shape,
                                                   n_threads=2, strict=True)
    assert not statuses.any()
    for im in images:
        np.testing.assert_array_equal(im, got)
        assert im.base is None and im.flags.owndata


def test_probe_rejects_what_the_jax_package_rejects():
    for blob in (b"\xff\xd8\xff\xff\xff\xff\xff\xc0", b"\xff\xd8\xff\xff\xff\xff\xff\xff",
                 b"\xff\xd8\xff\xe0\x00\xff\xff\xff", b"\xff\xd8\xff\xc0\x00\x08\x08\xff",
                 b"definitely not an image"):
        assert imgcodec.probe(blob) is None and jax_imgcodec.probe(blob) is None


def test_corrupt_cells_and_wrong_shapes_fail_per_image(rgb):
    corrupt = bytearray(_jpeg(rgb))
    corrupt[30:] = b"\x00" * (len(corrupt) - 30)
    blobs = [_png(rgb), b"garbage garbage!", bytes(corrupt), _png(rgb), _png(rgb[:8])]
    images, statuses = imgcodec.decode_image_batch(blobs, rgb.shape)
    _, jax_statuses = jax_imgcodec.decode_image_batch(blobs, rgb.shape)
    np.testing.assert_array_equal(statuses, jax_statuses)
    assert list(statuses == 0) == [True, False, False, True, False]
    assert statuses[4] == imgcodec.ERR_DIMS
    np.testing.assert_array_equal(images[0], rgb)
    with pytest.raises(ValueError):
        imgcodec.decode_image(_png(rgb), (8, 8, 3))
    with pytest.raises(ValueError):
        imgcodec.decode_image(bytes(corrupt), rgb.shape)
    # The gray source under an RGB shape: strict refuses, loose converts.
    with pytest.raises(ValueError):
        imgcodec.decode_image(_jpeg(_gray()), (32, 40, 3), strict=True)
    assert imgcodec.decode_image(_jpeg(_gray()), (32, 40, 3)).shape == (32, 40, 3)


def test_threads_give_equal_bits(rgb):
    blobs = [_jpeg(rgb, q) for q in (60, 70, 80, 90)] * 4
    one, s1 = imgcodec.decode_image_batch(blobs, rgb.shape, n_threads=1)
    four, s4 = imgcodec.decode_image_batch(blobs, rgb.shape, n_threads=4)
    assert not s1.any() and not s4.any()
    np.testing.assert_array_equal(np.stack(one), np.stack(four))
    assert 1 <= imgcodec.default_threads() <= 4


# ------------------------------------------------------ the column helper
def _odd_cells():
    """Cells the strict decode rejects under an (8, 8, 3) field: cv2 gives
    them 4 channels (tRNS palette, tRNS RGB, gray + alpha) or 2 (a gray
    JPEG)."""
    from PIL import Image
    pal = Image.new("P", (8, 8), 0)
    pal.putpalette([10, 20, 30] * 85 + [0] * 3)
    buf_pal = io.BytesIO()
    pal.save(buf_pal, format="PNG", transparency=0)
    buf_rgb = io.BytesIO()
    Image.new("RGB", (8, 8), (5, 6, 7)).save(buf_rgb, format="PNG", transparency=(5, 6, 7))
    buf_ga = io.BytesIO()
    Image.fromarray(np.full((8, 8), 100, np.uint8)).convert("LA").save(buf_ga, format="PNG")
    return [buf_pal.getvalue(), buf_rgb.getvalue(), buf_ga.getvalue(),
            _jpeg(np.full((8, 8), 99, np.uint8), 95)]


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_column_helper_equals_the_jax_package_and_cv2_cell_for_cell(fmt):
    codec = CompressedImageCodec(fmt, 90)
    field = _field((8, 8, 3), codec)
    jax_field = _field((8, 8, 3), jax_codecs.CompressedImageCodec(fmt, 90), JaxField)
    rng = np.random.default_rng(9)
    good = [codec.encode(field, rng.integers(0, 255, (8, 8, 3), dtype=np.uint8))
            for _ in range(4)]
    blobs = good[:2] + _odd_cells() + good[2:]
    rows, n_native = batch_decode_images(field, codec, blobs, n_threads=2)
    want = jax_batch_decode_images(jax_field, jax_field.codec, blobs)
    assert n_native == 4 and len(rows) == len(want) == len(blobs)
    for got, w, blob in zip(rows, want, blobs):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, _cv2(blob))
        np.testing.assert_array_equal(got, codec.decode(field, blob))


def test_column_helper_declines_what_it_cannot_take(rgb):
    field = _field((48, 64, 3))
    png = _png(rgb)
    assert batch_decode_images(_field((None, None, 3)), field.codec, [png] * 5) is None
    assert batch_decode_images(field, field.codec, [png, None, png, png]) is None
    assert batch_decode_images(field, field.codec, [png] * 3) is None

    class MyCodec(CompressedImageCodec):
        pass

    assert batch_decode_images(_field((48, 64, 3), MyCodec("png")), MyCodec("png"),
                               [png] * 5) is None
    hw1 = _field((16, 16, 1))
    assert not native_image_eligible(hw1, hw1.codec)
    assert batch_decode_images(hw1, hw1.codec, [_png(np.zeros((16, 16), np.uint8))] * 4) is None


def test_all_fail_column_backs_off_and_regains_the_native_path():
    field = _field((16, 16, 3), CompressedImageCodec("jpeg", 95))
    gray = [_jpeg(np.full((16, 16), v, np.uint8), 95) for v in (10, 60, 110, 160)]
    memo = NativeImageSkipMemo(base=2, cap=8)
    assert batch_decode_images(field, field.codec, gray, skip_memo=memo) is None
    assert "image" in memo
    assert [memo.should_skip("image") for _ in range(3)] == [True, True, False]
    rgbs = [_jpeg(np.full((16, 16, 3), v, np.uint8), 95) for v in (10, 60, 110, 160)]
    rows, n = batch_decode_images(field, field.codec, rgbs, skip_memo=memo)
    assert n == 4 and "image" not in memo
    memo.add("im")
    memo.add("im")
    assert sum(memo.should_skip("im") for _ in range(10)) == 4
    memo.add("im")
    memo.add("im")
    assert sum(memo.should_skip("im") for _ in range(20)) == 8   # capped
    memo.discard("im")
    assert not memo.should_skip("im")


def test_jpeg_parity_gate_on_and_off(monkeypatch, rgb):
    """Here the host's libjpeg reproduces cv2, so the gate opens. Forced
    shut, JPEG columns leave the native path (cv2 decodes them, with the
    same values) while PNG columns keep it."""
    monkeypatch.setattr(codecs, "_NATIVE_JPEG_OK", None)
    assert codecs._native_jpeg_parity_ok() is True
    assert codecs._native_jpeg_parity_ok() == jax_codecs._native_jpeg_parity_ok()
    monkeypatch.setattr(codecs, "_NATIVE_JPEG_OK", False)
    for fmt, native in (("jpeg", False), ("png", True)):
        codec = CompressedImageCodec(fmt, 90)
        field = _field(rgb.shape, codec)
        blobs = [codec.encode(field, rgb)] * 5
        got = batch_decode_images(field, codec, blobs)
        assert (got is not None) == native
        np.testing.assert_array_equal(codec.decode(field, blobs[0]), _cv2(blobs[0]))
    monkeypatch.setattr(codecs, "_NATIVE_DECODE_USABLE", False)
    assert not native_image_eligible(_field(rgb.shape), CompressedImageCodec("png"))


def test_build_goes_on_without_libdeflate(monkeypatch):
    from petastorm_tpu_torch import native
    calls = []
    real = native.build_native_library

    def no_deflate(src, name, ldflags=()):
        calls.append(list(ldflags))
        if "-ldeflate" in ldflags:
            raise NativeBuildError("no libdeflate")
        return real(src, name, ldflags)

    monkeypatch.setattr(imgcodec, "build_native_library", no_deflate)
    monkeypatch.setattr(imgcodec, "WITH_DEFLATE", imgcodec.WITH_DEFLATE)   # restored after
    path = imgcodec._build_library()
    assert "ptimg_nodeflate" in path and "torch_native" in path
    assert calls == [["-DPT_HAVE_DEFLATE", "-ljpeg", "-lpng", "-ldeflate"], ["-ljpeg", "-lpng"]]
    assert imgcodec.WITH_DEFLATE is False


def test_library_is_named_by_source_and_flags(tmp_path):
    from petastorm_tpu_torch.native import BUILD_DIR, library_path
    src = tmp_path / "x.cpp"
    src.write_text("int f() { return 1; }\n")
    a = library_path(src, "x")
    assert a.parent == BUILD_DIR and a == library_path(src, "x")
    assert library_path(src, "x", ["-lm"]) != a
    src.write_text("int f() { return 2; }\n")
    assert library_path(src, "x") != a


@pytest.mark.parametrize("pool", ["dummy", "thread"])
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_reader_counts_what_each_decoder_took(tmp_path, pool, fmt):
    from petastorm_tpu_torch.etl.writer import materialize_dataset_local
    from petastorm_tpu_torch.reader import make_reader
    schema = Unischema("S", [UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
                             UnischemaField("image", np.uint8, (16, 24, 3),
                                            CompressedImageCodec(fmt, 90), False)])
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 255, (16, 24, 3), dtype=np.uint8) for _ in range(22)]
    url = f"file://{tmp_path}/store"
    with materialize_dataset_local(url, schema, rows_per_row_group=8) as w:
        for i, img in enumerate(images):
            w.write_row({"id": i, "image": img})
    with make_reader(url, reader_pool_type=pool, workers_count=2) as reader:
        seen = {int(r.id): r.image for r in reader}
        counters = reader.counters
    assert len(seen) == 22
    # Row groups of 8, 8 and 6: all go through the batch call.
    assert counters == {"images_native": 22, "images_codec": 0}
    codec = schema.fields["image"].codec
    for i, img in enumerate(images):
        np.testing.assert_array_equal(seen[i], _cv2(codec.encode(schema.fields["image"], img)))
