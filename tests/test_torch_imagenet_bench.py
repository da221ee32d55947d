"""The port's image bench, its pieces and the flagship forward against the
JAX package's, on the CPU: the synthetic store, ``run_imagenet_bench``'s
result keys, the analytic FLOP count, ``training_input_stall``,
``DTypePolicy`` and ``entry()``.

``entry()`` bar: the port's bf16 forward against ``__graft_entry__``'s, on
the reference's weights and its first two example images, mean |port -
JAX| over mean |JAX| logit within :data:`ENTRY_BAR` = 1 %: both compute in
bf16 through 53 convolutions and batch norms that round at other places;
measured 0.16 %. (Each framework's bf16 forward is 0.36-0.37 % from its own
float32 forward on these inputs, and the port's float32 forward 1.7e-6 from
the reference's.)
"""
import datetime
import decimal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import __graft_entry__
from petastorm_tpu.benchmark import imagenet_bench as jax_bench
from petastorm_tpu.benchmark import throughput as jax_throughput
from petastorm_tpu.jax import dtypes as jax_dtypes
from petastorm_tpu.models import resnet as jax_resnet
from petastorm_tpu_torch.benchmark import imagenet_bench, throughput
from petastorm_tpu_torch.entry import entry
from petastorm_tpu_torch.loader import DataLoader, DTypePolicy
from petastorm_tpu_torch.loader import dtypes
from petastorm_tpu_torch.models import resnet
from petastorm_tpu_torch.reader import make_reader

SMALL = ((1, 8), (2, 8), (1, 16), (1, 16))
ENTRY_BAR = 0.01


def _rows(url):
    with make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        return [(r.image, int(r.label)) for r in reader]


def test_synthetic_store_has_the_reference_rows(tmp_path):
    kw = dict(rows=40, classes=5, seed=3, rows_per_row_group=16, image_size=32)
    imagenet_bench.write_synthetic_imagenet(f"file://{tmp_path}/port", **kw)
    jax_bench.write_synthetic_imagenet(f"file://{tmp_path}/jax", **kw)
    got, want = _rows(f"file://{tmp_path}/port"), _rows(f"file://{tmp_path}/jax")
    assert len(got) == len(want) == 40
    for (img, label), (want_img, want_label) in zip(got, want):
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, want_img)
        assert label == want_label
    assert imagenet_bench.ImagenetSchema.fields["image"].shape == (224, 224, 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        imagenet_bench.write_synthetic_imagenet(f"file://{tmp_path}/bad", rows=1, image_size=30)


@pytest.fixture
def small_net(monkeypatch):
    monkeypatch.setattr(jax_resnet, "_RESNET50_STAGES", SMALL)
    monkeypatch.setattr(resnet, "_RESNET50_STAGES", SMALL)


@pytest.fixture(scope="module")
def store32(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('imagenet')}/img32"
    imagenet_bench.write_synthetic_imagenet(url, rows=96, classes=4, rows_per_row_group=16,
                                            image_size=32)
    return url


def test_bench_result_keys_are_the_jax_benchs(store32, small_net):
    run = dict(steps=2, per_device_batch=8, workers_count=2, classes=4, resident_steps=1)
    got = imagenet_bench.run_imagenet_bench(store32, device="cpu", **run)
    want = jax_bench.run_imagenet_bench(store32, **run)
    assert set(got) == set(want)
    assert got["global_batch"] == 8 and got["devices"] == 1 and got["device_kind"] == "cpu"
    assert got["samples_per_sec"] > 0 and 0.0 <= got["input_stall_pct"] <= 100.0
    assert np.isfinite(got["loss_first"]) and np.isfinite(got["loss_last"])
    assert got["step_time_ms_resident"] > 0
    # The CPU never gets a peak: FLOP/s without MFU.
    assert "mfu_pct" not in got
    assert got["model_flops_per_step_per_chip"] == resnet.resnet50_flops_per_step(8, 32, 4)


def test_bench_refuses_the_process_pool(store32):
    with pytest.raises(NotImplementedError, match="process pool"):
        imagenet_bench.run_imagenet_bench(store32, pool_type="process", device="cpu")


def test_flops_on_a_hand_counted_net(monkeypatch):
    """Stages ((1, 2), (1, 4)) at 16x16, 10 classes, batch 3. The stem (7x7,
    3 -> 64) at 8x8: 64*49*3*64 = 602112 multiply-adds; the pool gives 4x4.
    Stage 0 at 4x4: conv1 16*64*2 = 2048, conv2 16*9*2*2 = 576, conv3
    16*2*8 = 256, projection 16*64*8 = 8192. Stage 1, stride 2, 4x4 -> 2x2:
    conv1 16*8*4 = 512, conv2 4*9*4*4 = 576, conv3 4*4*16 = 256, projection
    4*8*16 = 512. Head 16*10 = 160. In all 615200, so 3 * 2 * 615200 * 3
    FLOPs a step."""
    monkeypatch.setattr(resnet, "_RESNET50_STAGES", ((1, 2), (1, 4)))
    assert resnet.resnet50_flops_per_step(3, 16, 10) == 3 * 2 * 615200 * 3


def test_flops_of_resnet50_at_224():
    """4,089,184,256 multiply-adds an image, the figure published for
    ResNet-50 (4.09 G), 24.5 GFLOP a training step an image."""
    assert resnet.resnet50_flops_per_step(1, 224, 1000) == 6 * 4_089_184_256
    assert resnet.resnet50_flops_per_step(256, 224, 100) == pytest.approx(6.278e12, rel=1e-3)


class _Batches:
    def __init__(self, n):
        self.batches = [{"x": torch.full((4,), float(i))} for i in range(n)]

    def __iter__(self):
        return iter(self.batches)


def test_training_input_stall_has_the_reference_keys():
    got = throughput.training_input_stall(_Batches(10), lambda b: b["x"] * 2, steps=5)
    want = jax_throughput.training_input_stall(
        [{"x": np.full(4, float(i))} for i in range(10)], lambda b: jnp.asarray(b["x"]) * 2,
        steps=5)
    assert set(got) == set(want)
    assert got["steps"] == 5 and 0.0 <= got["input_stall_percent"] <= 100.0
    assert got["wait_s"] >= 0 and got["compute_s"] >= 0
    short = throughput.training_input_stall(_Batches(3), lambda b: (b["x"], {"y": b["x"]}),
                                            steps=5)
    assert short["steps"] == 2   # the first batch is spin-up; the loader ran dry


def _policy_batch():
    return {
        "f64": np.linspace(-3, 3, 8).reshape(4, 2) * 1.1,
        "f32": np.linspace(-1, 1, 4, dtype=np.float32),
        "f16": np.linspace(-2, 2, 4).astype(np.float16),
        "i32": np.arange(4, dtype=np.int32),
        "u16": np.array([0, 1, 65535, 7], np.uint16),
        "u32": np.array([0, 1, 2**32 - 1, 7], np.uint32),
        "dec": np.array([decimal.Decimal("1.25"), None, decimal.Decimal("-3.5"),
                         decimal.Decimal("2")], object),
        "ts": np.array([datetime.datetime(2020, 1, 1, 0, 0, i) for i in range(4)],
                       "datetime64[us]"),
        "s": np.array(["a", "b", "c", "d"]),
    }


@pytest.mark.parametrize("field,value", [
    (None, None),
    ("decimal_to", "float32"), ("decimal_to", "str"),
    ("datetime_to_int64_ns", False),
    ("float64_to_float32", True),
    ("promote_unsigned", True),
    ("cast_floats_to_bfloat16", True),
    ("float64_to_float32+bf16", True),
])
def test_dtype_policy_matches_the_jax_package(field, value):
    if field is None:
        kw = {}
    elif field == "float64_to_float32+bf16":
        kw = {"float64_to_float32": True, "cast_floats_to_bfloat16": True}
    else:
        kw = {field: value}
    got_dev, got_host = dtypes.sanitize_batch(_policy_batch(), DTypePolicy(**kw))
    want_dev, want_host = jax_dtypes.sanitize_batch(_policy_batch(), jax_dtypes.DTypePolicy(**kw))
    assert set(got_dev) == set(want_dev) and set(got_host) == set(want_host)
    for name, want in want_dev.items():
        got = got_dev[name]
        if want.dtype == ml_dtypes.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
            continue
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        if want.dtype.kind == "u":
            # torch has no uint16/uint32: the port widens whatever
            # promote_unsigned says, to the reference's promoted type.
            assert got.dtype == {np.dtype(np.uint16): np.int32,
                                 np.dtype(np.uint32): np.int64}[want.dtype]
        else:
            assert got.dtype == want.dtype
    for name, want in want_host.items():
        np.testing.assert_array_equal(got_host[name], want)


def test_loader_stages_bfloat16_under_the_policy(store32):
    with make_reader(store32, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
        batch = next(iter(DataLoader(reader, batch_size=4, device="cpu",
                                     dtype_policy=DTypePolicy(cast_floats_to_bfloat16=True))))
    assert batch["image"].dtype == torch.uint8 and batch["label"].dtype == torch.int32
    floats = {"x": np.linspace(0, 1, 6, dtype=np.float64).reshape(2, 3)}
    cols, _ = dtypes.sanitize_batch(floats, DTypePolicy(cast_floats_to_bfloat16=True))
    assert cols["x"].dtype == torch.bfloat16
    assert dtypes.sanitize_batch(floats)[0]["x"].dtype == np.float64   # the default keeps it


def test_entry_matches_the_graft_entry():
    forward, (params, images) = entry(device="cpu")
    jax_forward, (jax_params, jax_images) = __graft_entry__.entry()
    assert tuple(images.shape) == (8, 224, 224, 3) and images.dtype == torch.float32
    np.testing.assert_array_equal(images.numpy(), np.asarray(jax_images))
    assert jax.tree.map(lambda t: t.shape[2:] + t.shape[1::-1] if t.dim() == 4 else t.shape,
                        params) == jax.tree.map(lambda a: a.shape, jax_params)
    # The reference's weights through the port's forward, first two images.
    want = np.asarray(jax.jit(jax_forward)(jax_params, jax_images[:2]))
    got = forward(resnet.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu"),
                  images[:2])
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).mean() / np.abs(want).mean() <= ENTRY_BAR


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
