#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. probe: torch, the device, ``nvidia-smi`` name and power limit, and the
   host libraries the reader needs (pyarrow, cv2 or PIL, fsspec);
2. build every CUDA kernel of the main path from ``petastorm_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, and time both with CUDA events;
4. the main path at full size: a seeded 2048-row store of 224x224x3 JPEG
   images written with the package's writer, read by ``make_reader``
   (8 decode threads), batched by ``DataLoader(batch_size=256,
   device="cuda")`` and normalised on the card by ``normalize_images``, two
   epochs; launch counts are reset just before and read just after. Then
   the staged bytes of a CUDA loader are held against a CPU loader's.

The line before the last is a JSON object listing every kernel with its
launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.kernels.build import build
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.ops.image_ops import (KERNEL_NAME, normalize_images,
                                               normalize_images_plain)
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

#: H100 SXM device-memory rate and float32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

ROWS, ROWS_PER_GROUP, BATCH, EPOCHS, WORKERS = 2048, 64, 256, 2, 8
IMAGE_SHAPE = (224, 224, 3)
TIMING_REPS = 50


def log(msg):
    print(msg, flush=True)


def ordered_bits16(t: torch.Tensor) -> torch.Tensor:
    """16-bit float bit patterns mapped to integers that are consecutive
    for consecutive representable values (sign-magnitude -> two's order)."""
    i = t.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def check_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """f32: max abs <= 1e-6. bf16/f16: within 1 ulp and >= 99.9% of
    elements bit-equal. The kernel rounds x*scale and then the add as the
    plain version does, so it is expected to be bit-equal; the bar leaves
    room for a compiler that contracts the two into one FMA. Returns the
    max abs error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.float32:
        if not err <= 1e-6:
            raise AssertionError(f"{what}: max abs error {err} > 1e-6")
    else:
        ulps = (ordered_bits16(got) - ordered_bits16(want)).abs()
        equal = (ulps == 0).float().mean().item()
        if ulps.max().item() > 1 or equal < 0.999:
            raise AssertionError(f"{what}: max {ulps.max().item()} ulp, "
                                 f"{equal:.6f} bit-equal")
    return err


def median_ms(*fns, reps=TIMING_REPS) -> list:
    """Median CUDA-event time of each of ``fns``, timed in turns (the order
    alternates every repetition) after a warm-up of each."""
    for fn in fns:
        for _ in range(3):
            fn()
    times = [[] for _ in fns]
    for rep in range(reps):
        order = range(len(fns)) if rep % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[i]()
            stop.record()
            stop.synchronize()
            times[i].append(start.elapsed_time(stop))
    return [statistics.median(t) for t in times]


def phase_probe() -> str:
    import fsspec  # noqa: F401
    import pyarrow  # noqa: F401
    try:
        import cv2  # noqa: F401
    except ImportError:
        import PIL  # noqa: F401
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} device {name!r}; "
        f"pyarrow {pyarrow.__version__}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    paths = build(["normalize"])
    log(f"[build] {sorted(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.2f} s")


def phase_kernels() -> dict:
    rng = np.random.default_rng(0)
    imagenet = ((0.485, 0.456, 0.406, 0.5), (0.229, 0.224, 0.225, 0.25))
    # x/255 hits these means exactly (0.4 = 102/255, 0.6 = 153/255), so
    # x*scale + bias cancels to about 0: where an FMA would round otherwise.
    cancelling = ((0.4, 0.5, 0.6, 0.7), (0.2, 0.25, 0.3, 0.35))
    cases = [((BATCH,) + IMAGE_SHAPE, torch.bfloat16, imagenet),
             ((BATCH,) + IMAGE_SHAPE, torch.float32, imagenet),
             ((3, 17, 19, 3), torch.bfloat16, imagenet), ((3, 17, 19, 3), torch.float32, imagenet),
             ((16, 224, 224, 1), torch.bfloat16, imagenet),
             ((16, 64, 64, 4), torch.float16, imagenet),
             ((8,) + IMAGE_SHAPE, torch.bfloat16, cancelling)]
    result = None
    for shape, dtype, (mean, std) in cases:
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        got = normalize_images(x, mean, std, out_dtype=dtype)
        want = normalize_images_plain(x, mean, std, out_dtype=dtype)
        torch.cuda.synchronize()
        err = check_close(got, want, f"{shape} {dtype}")
        line = f"[kernel] {KERNEL_NAME} {shape} {dtype}: max abs err {err:.3g}"
        if shape == (BATCH,) + IMAGE_SHAPE:
            n = x.numel()
            out_bytes = torch.empty((), dtype=dtype).element_size()
            bound_ms = max(n * (1 + out_bytes) / HBM_BYTES_PER_S,
                           2 * n / F32_FLOPS) * 1e3
            ms, plain_ms = median_ms(
                lambda: normalize_images(x, mean, std, out_dtype=dtype),
                lambda: normalize_images_plain(x, mean, std, out_dtype=dtype))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({n * (1 + out_bytes) / 1e6:.1f} MB); no single PyTorch call "
                     f"computes this function (library_ms null)")
            if dtype == torch.bfloat16:  # the main path's output type
                result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms}
        log(line)
    return result


def smooth_image(rng) -> np.ndarray:
    """A seeded natural-ish image: a bilinear blow-up of a coarse random
    grid plus mild noise (pure noise would make JPEG a worst case)."""
    coarse = rng.integers(0, 256, (7, 7, 3)).astype(np.float32)

    def lerp(a, axis, size):
        t = np.linspace(0, a.shape[axis] - 1, size)
        i = np.minimum(t.astype(int), a.shape[axis] - 2)
        f = np.expand_dims(t - i, tuple(range(1, a.ndim - axis)))
        return np.take(a, i, axis) * (1 - f) + np.take(a, i + 1, axis) * f

    img = lerp(lerp(coarse, 0, IMAGE_SHAPE[0]), 1, IMAGE_SHAPE[1])
    img += rng.normal(0, 6, IMAGE_SHAPE)
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_slice(tmp: str) -> int:
    url = f"file://{tmp}/imagenet_like"
    schema = Unischema("ImageNetLike", [
        UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField("image", np.uint8, IMAGE_SHAPE, CompressedImageCodec("jpeg", 90), False)])
    rng = np.random.default_rng(1234)
    t0 = time.perf_counter()
    with materialize_dataset_local(url, schema, rows_per_row_group=ROWS_PER_GROUP) as w:
        for i in range(ROWS):
            w.write_row({"id": i, "image": smooth_image(rng)})
    log(f"[slice] wrote {ROWS} rows in {time.perf_counter() - t0:.2f} s")

    # The main path, counted.
    kernels.reset_launch_counts()
    batches = samples = 0
    last = None
    t0 = time.perf_counter()
    with make_reader(url, reader_pool_type="thread", workers_count=WORKERS, seed=0,
                     num_epochs=EPOCHS) as reader:
        for batch in DataLoader(reader, batch_size=BATCH, device="cuda"):
            if not (batch["image"].is_cuda and batch["id"].is_cuda):
                raise AssertionError("a staged batch is not on the card")
            last = normalize_images(batch["image"])
            batches += 1
            samples += batch["image"].shape[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts.get(KERNEL_NAME, 0)
    if batches != ROWS * EPOCHS // BATCH:
        raise AssertionError(f"{batches} batches, expected {ROWS * EPOCHS // BATCH}")
    if launches != batches:
        raise AssertionError(f"{KERNEL_NAME} launched {launches} times for {batches} batches")
    if last.shape != (BATCH,) + IMAGE_SHAPE or last.dtype != torch.bfloat16 \
            or not torch.isfinite(last.float()).all():
        raise AssertionError(f"bad normalised batch {last.shape} {last.dtype}")
    log(f"[slice] {batches} batches, {samples} samples in {wall:.3f} s: "
        f"{samples / wall:.1f} samples/s; {KERNEL_NAME} launches {launches}")

    # Where the time goes: the same read with the layers above taken away
    # one at a time, then the main path again, warm.
    def rows_per_s(what, consume):
        t0 = time.perf_counter()
        with make_reader(url, reader_pool_type="thread", workers_count=WORKERS, seed=0,
                         num_epochs=EPOCHS) as reader:
            rows = consume(reader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"[slice] {what}: {rows} rows in {wall:.3f} s: {rows / wall:.1f} rows/s")

    rows_per_s(f"reader alone (read + JPEG decode, {WORKERS} threads)",
               lambda r: sum(1 for _ in r))
    rows_per_s("reader + DataLoader(device='cpu') (collate, no staging)",
               lambda r: sum(len(b["id"]) for b in DataLoader(r, batch_size=BATCH, device="cpu")))
    rows_per_s("main path again, warm (staging + normalize)",
               lambda r: sum(normalize_images(b["image"]).shape[0]
                             for b in DataLoader(r, batch_size=BATCH, device="cuda")))

    # Staged bytes: CUDA loader vs CPU loader on the same deterministic read.
    def first_batch(device):
        with make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
            return next(iter(DataLoader(reader, batch_size=BATCH, device=device)))
    on_card, on_host = first_batch("cuda"), first_batch("cpu")
    for name in ("id", "image"):
        if not torch.equal(on_card[name].cpu(), on_host[name]):
            raise AssertionError(f"staged {name!r} bytes differ between cuda and cpu loaders")
    err = check_close(normalize_images(on_card["image"]).cpu(),
                      normalize_images_plain(on_host["image"]), "slice batch")
    log(f"[slice] staged bytes equal to the CPU loader's; normalised batch within "
        f"1 bf16 ulp of the plain CPU version (max abs err {err:.3g})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = phase_probe()
    phase_build()
    k1 = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(tmp)
    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/normalize.cu",
        "replaces": "petastorm_tpu/ops/image_ops.py:27",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
