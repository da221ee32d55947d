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
   the staged bytes of a CUDA loader are held against a CPU loader's;
5. flash attention (K2) against its plain version on the card: the token
   path's shape (2, 8192, 32 heads over 8 kv heads, 128) bf16 causal in
   its "out" and "lse" modes, then ragged, cross-length, non-causal,
   MHA, f32 and f16 cases, each held to an absolute bar and to bars scaled
   to each output row; deliberately wrong attentions made from the plain
   version must fail those bars on the long rows; kernel, plain version
   and PyTorch's ``scaled_dot_product_attention`` (yardstick only) timed
   with CUDA events;
6. the token path at full width: a seeded store of 12 windows of 8192
   tokens written by ``write_token_store``, read as dense NGram windows by
   ``make_reader`` (8 threads, ``num_epochs=None``), batched by
   ``DataLoader(batch_size=2, device="cuda")``, and the next-token loss of
   ``LlamaConfig()`` at full width (4 of its 32 layers, seeded random
   weights, bf16 compute) with ``make_flash_attention(causal=True)``, one
   warm-up and four steps under ``torch.inference_mode()``; launch counts
   are reset just before and read just after. Then the breakdown by layer,
   and one batch's logits held against the same forward on the plain
   attention, with the wrong attentions (and one of zeros) as controls
   that the bar must reject;
7. the flash backward (K3: dq, K4: dk and dv) against the plain backward on
   the card: the token path's shape bf16 causal on the tensor-core route,
   held to bars scaled to each query row (dq) and key row (dk, dv), with
   deliberately wrong backwards made from the plain version
   (``BWD_CONTROLS``) that the bars must reject, and two launches giving
   equal bits; the FMA route forced at the same inputs, held to the same
   bars; then short cases on whichever route they take (logged, and checked
   against the launch counts): ragged, cross-length both ways, non-causal,
   MHA, rep 4, f32, f16, d 32/64/72/128 on tensor cores, d 60 and 256 and
   f32 on FMAs, q/k/v as strided views of one fused tensor, also held to
   absolute bars; K3 and K4 of both routes, the plain backward and the
   backward of PyTorch's ``scaled_dot_product_attention`` (yardstick only)
   timed with CUDA events, in turns;
8. the training path at full width: ``run_llm_bench`` on a seeded
   ``write_token_store`` store (window 8192) with ``LlamaConfig()`` at full
   width cut to 4 layers, batch 2, flash attention, one warm-up step, four
   timed steps and two resident ones; launch counts are reset just before
   and read just after (K2 and the tensor-core K3 and K4 once per layer per
   step; the FMA route and the plain versions never). Then one step with ``remat_layers`` and ``xent_chunk``
   against the plain step, a ``torch.profiler`` split of one resident
   step, and the whole-slice gradient check: every parameter's gradient
   through the kernels against the plain forward and backward, with the
   wrong backwards as controls.

The line before the last is a JSON object listing every kernel with its
launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.benchmark.llm_bench import run_llm_bench, write_token_store
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.kernels.build import build
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops import flash_attn
from petastorm_tpu_torch.ops.flash_attn import (FlashAttentionFunction, flash_attention,
                                                flash_attention_bwd, flash_attention_bwd_plain,
                                                flash_attention_lse, flash_attention_plain,
                                                make_flash_attention)
from petastorm_tpu_torch.ops.image_ops import (KERNEL_NAME, normalize_images,
                                               normalize_images_plain)
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

#: H100 SXM device-memory rate, float32 (non-tensor-core) and bf16
#: tensor-core dense peaks.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

ROWS, ROWS_PER_GROUP, BATCH, EPOCHS, WORKERS = 2048, 64, 256, 2, 8
IMAGE_SHAPE = (224, 224, 3)
TIMING_REPS = 50

# Token path: the JAX package's llm_bench settings at LlamaConfig() width,
# depth cut from 32 layers to 4 to fit the run's time.
WINDOW, TOKEN_WINDOWS, TOKEN_BATCH, TOKEN_STEPS, TOKEN_WORKERS = 8192, 12, 2, 4, 8
LLAMA = llama.LlamaConfig(n_layers=4)
FLASH_REPS = 5   # repetitions at the token path's shape (about 0.1-0.5 s a call)
#: Kernel vs plain version on the card: two bars, both held at every case.
#: Absolute: the JAX package's flash bars (f32 2e-5, bf16 3e-2) and, for
#: f16, whose mantissa has 3 more bits than bf16's, 3e-2 / 8 rounded up; lse
#: (float32 in every mode) 2e-5. They suit rows of a few hundred keys, whose
#: outputs are about 0.1-1.
FLASH_BARS = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 4e-3}
LSE_BAR = 2e-5
#: Scaled to each output row (one query of one head). With q, k, v drawn
#: from N(0, 1) a row that sees n keys has outputs of about sqrt(e / n),
#: 0.018 at n = 8192: under the absolute bf16 bar. So each element must also
#: meet |err| <= eps |want| + worst * rms(row of want), eps being the output
#: type's relative spacing (one rounding step either way), and the root mean
#: square of err / rms(row) over all elements must stay under rms: it sees an
#: error common to many rows (a normaliser 1 % off) that one rounding step
#: hides. (eps, worst, rms) per type; the controls below must fail them.
ROW_BARS = {torch.bfloat16: (2 ** -7, 2 ** -5, 2 ** -7),
            torch.float16: (2 ** -10, 2 ** -8, 2 ** -10),
            torch.float32: (2 ** -23, 2 ** -16, 2 ** -18)}
#: Deliberately wrong attentions, built from the plain version: bugs a
#: kernel could have. The bars must reject the first three at the token
#: path's shape on its long rows alone (rows from WINDOW // 2 on, which see
#: 4097-8192 keys). The last differs from the plain version by less than
#: the output's rounding (the kernel's own p roundings differ from the plain
#: version's, since it rounds exp(s - running max)); it is shown, not judged.
CONTROLS = ("last K/V tile skipped", "1 key in 32 dropped", "normaliser 1 % off",
            "p kept in float32")
MUST_FAIL = CONTROLS[:3]
#: One batch's logits through the kernel vs through the plain attention:
#: mean |difference| over mean |logit|. The compute is bf16, so a last-bit
#: difference in one layer's attention moves later roundings. On an H100
#: the kernel read 1.21 % and the nearest control, "normaliser 1 % off",
#: 2.08 %; the bar lies between them. The other controls and an attention
#: of zeros read 17-133 %.
LOGITS_MEAN_REL_BAR = 0.016
SLICE_MUST_FAIL = ("zero attention",) + MUST_FAIL

# Flash backward (K3, K4) against the plain backward. Absolute bars at the
# short cases: the JAX package's gradient bar in float32 (2e-4) and its flash
# bars in 16 bits (bf16 3e-2, f16 4e-3), each plus one rounding step of the
# value (gradients reach about 10, where one bf16 step is 0.0625). Every case
# is also held to the row-scaled bars of ROW_BARS, a row being one query of
# one head for dq and one key of one kv head for dk and dv. A row's scale is
# at least GRAD_ROW_FLOOR of the whole gradient's rms: a row whose gradient
# cancels to about zero (query 0 of a causal head, whose only key gives
# dp = D) holds rounding noise alone, judged against the tensor's scale.
GRAD_ROW_FLOOR = 2 ** -7
BWD_ABS_BARS = {torch.float32: 2e-4, torch.bfloat16: 3e-2, torch.float16: 4e-3}
#: Deliberately wrong backwards, made by giving the plain backward altered
#: inputs; the bars must reject each at the token path's shape. On an H100
#: the tensor-core kernels read, at that shape, row-scaled worst 0.0073 and
#: rms 0.00038 (dv; the FMA route, whose sums run in the plain version's
#: order, 8.7e-6 and 9.1e-5); the nearest control, "p 1 % low", read worst
#: 0.042 and rms 0.0105, outside the bf16 bars (0.031, 0.0078); the others
#: read rms 0.047-27.
BWD_CONTROLS = ("D left out", "GQA sum over the first head of each group only",
                "last q tile skipped in dK/dV", "lse + ln 1.01 (p 1 % low)")
BWD_MUST_FAIL = BWD_CONTROLS
# Training path: LlamaConfig() at full width, 4 layers, as phase 6.
TRAIN_STEPS, TRAIN_RESIDENT, XENT_CHUNK = 4, 2, 2048
#: Whole-slice gradient check: per parameter leaf, |g - g_plain| / |g_plain|
#: (Euclidean norms) against the gradients through the plain forward and
#: backward, the largest over the leaves. The controls run the plain forward
#: with a wrong backward, so they are held, like for like, against the
#: kernel backward on the plain forward: on an H100 that read 0.89 % (0.83 %
#: on the FMA route) and the nearest control, "p 1 % low", 1.94 %;
#: GRAD_BWD_REL_BAR lies between and every control must exceed it. The
#: whole path on the kernels (K2's bf16 roundings differ from the plain
#: forward's, and the bf16 model carries them into every gradient) read
#: 2.05 % and the nearest control it must reject, "last q tile skipped",
#: 8.07 %; GRAD_REL_BAR lies between. "p 1 % low" moves the gradients by
#: less than K2's roundings do and is shown, not judged, at that bar.
GRAD_REL_BAR = 0.04
GRAD_BWD_REL_BAR = 0.013
GRAD_MUST_FAIL = BWD_CONTROLS[:3]

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


def median_ms(*fns, reps=TIMING_REPS, warmup=3) -> list:
    """Median CUDA-event time of each of ``fns``, timed in turns (the order
    alternates every repetition) after ``warmup`` calls of each."""
    for fn in fns:
        for _ in range(warmup):
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
    paths = build(["normalize", "flash_attn", "flash_attn_bwd"])
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


def flash_flops_bytes(b, sq, sk, h, kv_h, d, causal, itemsize, with_lse):
    """Operations (4*b*h*d per visible (query, key) pair: two products of
    2 operations each) and bytes (q, k, v read once, o and lse written
    once) of one flash call."""
    if causal:   # query i sees keys 0..min(i, sk-1)
        visible = sum(min(i + 1, sk) for i in range(sq)) if sq != sk else sq * (sq + 1) // 2
    else:
        visible = sq * sk
    flops = 4 * b * h * d * visible
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * sk * kv_h * d) + (4 * b * h * sq if with_lse else 0)
    return flops, nbytes


def row_scaled_errors(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0):
    """(worst, rms) of ``got - want`` against each output row's scale:
    max (|err| - eps |want|) / rms(row) and sqrt(mean((err / rms(row))^2)).
    With ``floor`` a row's scale is at least that fraction of the whole
    tensor's rms."""
    w = want.float()
    row = w.square().mean(-1, keepdim=True).sqrt().clamp_min(
        max(1e-30, floor * w.square().mean().sqrt().item()))
    err = (got.float() - w).abs()
    worst = ((err - ROW_BARS[want.dtype][0] * w.abs()) / row).max().item()
    return worst, (err / row).square().mean().sqrt().item()


def flash_verdict(got: torch.Tensor, want: torch.Tensor):
    """-> (max abs err, worst, rms, within every bar)."""
    err = (got.float() - want.float()).abs().max().item()
    worst, rms = row_scaled_errors(got, want)
    _, worst_bar, rms_bar = ROW_BARS[want.dtype]
    return err, worst, rms, err <= FLASH_BARS[want.dtype] and worst <= worst_bar and rms <= rms_bar


def check_flash(gen, b, sq, sk, h, kv_h, d, causal, dtype, what):
    """Kernel ("out" and "lse") against the plain version on the same
    inputs; raises past the stated bars. -> (inputs, plain output, max abs err)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v = randn(b, sq, h, d), randn(b, sk, kv_h, d), randn(b, sk, kv_h, d)
    o_out = flash_attention(q, k, v, causal=causal)
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    want_o, want_lse = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if o.shape != (b, sq, h, d) or o.dtype != dtype or lse.shape != (b, h, sq, 1) \
            or lse.dtype != torch.float32:
        raise AssertionError(f"{what}: o {o.shape} {o.dtype}, lse {lse.shape} {lse.dtype}")
    if not torch.equal(o, o_out):
        raise AssertionError(f"{what}: the 'out' and 'lse' modes give different outputs")
    if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, worst, rms, ok = flash_verdict(o, want_o)
    lse_err = (lse - want_lse).abs().max().item()
    _, worst_bar, rms_bar = ROW_BARS[dtype]
    log(f"[flash] {what}: max abs err o {err:.3g} (bar {FLASH_BARS[dtype]}), row-scaled "
        f"worst {worst:.3g} (bar {worst_bar:.3g}) rms {rms:.3g} (bar {rms_bar:.3g}); "
        f"lse {lse_err:.3g} (bar {LSE_BAR})")
    if not (ok and lse_err <= LSE_BAR):
        raise AssertionError(f"{what}: the kernel's output is outside a bar")
    return (q, k, v), want_o, err


def control_attention(q, k, v, flaw):
    """Causal attention computed as flash_attention_plain computes it, with
    one ``flaw`` of CONTROLS (``None``: none)."""
    b, s, h, d = q.shape
    kv_h = k.shape[2]
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (b, kv_h, 1, s, d)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    o = torch.empty_like(q)
    rows = max(1, flash_attn._PLAIN_SCORE_BYTES // (4 * b * h * s))   # the plain version's blocks
    for q0 in range(0, s, rows):
        q1 = min(s, q0 + rows)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        k_pos = torch.arange(q1, device=q.device)[None, :]
        seen = q_pos >= k_pos
        if flaw == CONTROLS[0]:   # the key loop ends one 64-key tile early
            seen &= (k_pos < q_pos // 64 * 64) | (q_pos < 64)
        elif flaw == CONTROLS[1]:
            seen &= k_pos % 32 != 31
        qc = q[:, q0:q1].float().reshape(b, q1 - q0, kv_h, h // kv_h, d).permute(0, 2, 3, 1, 4)
        sc = torch.matmul(qc, kf[..., :q1, :].transpose(-1, -2)) * flash_attn.softmax_scale(d)
        sc = sc.masked_fill(~seen, float("-inf"))
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        pv = p if flaw == CONTROLS[3] else p.to(v.dtype).float()
        acc = torch.matmul(pv, vf[..., :q1, :]) / p.sum(-1, keepdim=True)
        if flaw == CONTROLS[2]:
            acc = acc * 1.01
        o[:, q0:q1] = acc.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, q1 - q0, h, d)
    return o


def sdpa(q, k, v):
    """PyTorch's fused attention on the same inputs (yardstick only)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=True,
                                          enable_gqa=True).transpose(1, 2)


def phase_flash() -> dict:
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the plain version would not be float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, kv_h, d = TOKEN_BATCH, LLAMA.n_heads, LLAMA.n_kv_heads, LLAMA.head_dim
    (q, k, v), want, err = check_flash(gen, b, WINDOW, WINDOW, h, kv_h, d, True,
                                       torch.bfloat16,
                                       f"token path ({b}, {WINDOW}, {h}/{kv_h}, {d}) bf16 causal")
    # The bars against wrong outputs, on the long rows alone.
    long = WINDOW // 2
    if not torch.equal(control_attention(q, k, v, None), want):
        raise AssertionError("control_attention without a flaw differs from the plain version")
    for flaw in (None,) + CONTROLS:
        got = flash_attention(q, k, v, causal=True) if flaw is None else \
            control_attention(q, k, v, flaw)
        c_err, c_worst, c_rms, ok = flash_verdict(got[:, long:], want[:, long:])
        name = "kernel" if flaw is None else f"control {flaw!r}"
        log(f"[flash] {name}, rows {long}..{WINDOW - 1}: max abs err {c_err:.3g}, row-scaled "
            f"worst {c_worst:.3g} rms {c_rms:.3g}: {'within the bars' if ok else 'rejected'}"
            f"{'' if c_err > FLASH_BARS[torch.bfloat16] else ' (within the absolute bar)'}")
        if (flaw is None and not ok) or (flaw in MUST_FAIL and ok):
            raise AssertionError(f"{name}: the bars do not tell it from the plain "
                                 f"version")
    for case in [(1, 100, 100, 4, 2, 64, True, torch.bfloat16, "ragged 100x100 d64 causal"),
                 (2, 96, 64, 4, 2, 64, True, torch.bfloat16, "causal sq 96 > sk 64"),
                 (2, 77, 130, 4, 1, 64, False, torch.bfloat16, "non-causal sq 77, sk 130"),
                 (2, 200, 200, 4, 4, 128, True, torch.bfloat16, "h == kv_h"),
                 (2, 300, 300, 8, 2, 64, True, torch.float32, "f32 d64 causal"),
                 (2, 150, 150, 8, 4, 128, False, torch.float16, "f16 non-causal"),
                 (1, 70, 70, 2, 1, 256, True, torch.bfloat16, "d256 causal")]:
        check_flash(gen, *case)
    flops, nbytes = flash_flops_bytes(b, WINDOW, WINDOW, h, kv_h, d, True, 2, with_lse=False)
    bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
    ms, lse_ms, plain_ms, library_ms = median_ms(
        lambda: flash_attention(q, k, v, causal=True),
        lambda: flash_attention_lse(q, k, v, causal=True),
        lambda: flash_attention_plain(q, k, v, causal=True),
        lambda: sdpa(q, k, v), reps=FLASH_REPS, warmup=1)
    log(f"[flash] token path shape: kernel {ms:.4f} ms ('lse' mode {lse_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} operations, {nbytes / 1e9:.4g} GB); "
        f"kernel at {flops / ms / 1e9:.4g} TFLOP/s")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


#: Kernel groups of a profiled step: (label, substrings of the kernel name).
FORWARD_GROUPS = (("flash_fwd_kernel (K2)", ("flash_fwd_kernel",)),
                  ("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")))
TRAIN_GROUPS = (("flash_fwd_kernel (K2)", ("flash_fwd_kernel",)),
                ("flash_bwd_dq_*kernel (K3)", ("flash_bwd_dq_",)),
                ("flash_bwd_dkv_*kernel (K4)", ("flash_bwd_dkv_",)),
                ("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
                ("AdamW (multi-tensor kernels)", ("multi_tensor_apply", "adam")))


def profile_step(step, what: str, groups=FORWARD_GROUPS) -> dict:
    """One ``step`` under ``torch.profiler``: device time by kernel (the
    kernels' own events, so nothing is counted twice) against the host
    wall time; the rest of the wall time is the device's idle share.
    Returns ``{group: ms}`` with the wall and busy times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: a user annotation (the optimizer's step range) also
    # carries device time, which would count its kernels twice.
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                 and not getattr(e, "is_user_annotation", False)}
    busy_ms = sum(by_kernel.values())
    if busy_ms <= 0:
        raise AssertionError(f"the profiled {what} shows no device time")
    split = {label: 0.0 for label, _ in groups}
    split["everything else"] = 0.0
    for name, ms in by_kernel.items():
        label = next((label for label, tags in groups
                      if any(tag in name.lower() for tag in tags)), "everything else")
        split[label] += ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %), {len(by_kernel)} kernels; by group: "
        + "; ".join(f"{g} {ms:.1f} ms ({100 * ms / busy_ms:.1f} %)" for g, ms in split.items()))
    log(f"[profile] {what}, top kernels: " + "; ".join(
        f"{name[:60]} {ms:.1f} ms ({100 * ms / busy_ms:.1f} %)" for name, ms in top))
    return dict(split, wall_ms=wall_ms, busy_ms=busy_ms)


def phase_tokens(tmp: str) -> int:
    url = f"file://{tmp}/tokens"
    t0 = time.perf_counter()
    write_token_store(url, windows=TOKEN_WINDOWS, window=WINDOW, vocab=LLAMA.vocab, seed=0)
    log(f"[tokens] wrote {TOKEN_WINDOWS} x {WINDOW} tokens in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), LLAMA, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for layer in params["layers"] for t in layer.values()) + sum(
        params[k].numel() for k in ("embed", "norm_out", "lm_head"))
    log(f"[tokens] LlamaConfig(n_layers={LLAMA.n_layers}) at full width: {n_params / 1e9:.3f} B "
        f"float32 params in {time.perf_counter() - t0:.2f} s")
    attn_fn = make_flash_attention(causal=True)

    def reader(**kw):
        ngram = NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                      timestamp_field="ts", timestamp_overlap=False, dense=True)
        return make_reader(url, schema_fields=ngram, shuffle_row_groups=True, seed=0,
                           workers_count=TOKEN_WORKERS, num_epochs=None, **kw)

    def loss_of(tokens):
        return llama.loss_fn(params, {"tokens": tokens}, LLAMA, attn_fn=attn_fn,
                             compute_dtype=torch.bfloat16, shift="roll")

    def check_batch(batch):
        tok = batch["token"]
        if tok.shape != (TOKEN_BATCH, WINDOW) or tok.dtype != torch.int32 or not tok.is_cuda:
            raise AssertionError(f"staged token batch {tuple(tok.shape)} {tok.dtype} {tok.device}")
        return tok

    # The main path, counted: one warm-up forward, then the timed steps.
    kernels.reset_launch_counts()
    with torch.inference_mode(), reader() as r:
        it = iter(DataLoader(r, batch_size=TOKEN_BATCH, device="cuda"))
        warm = loss_of(check_batch(next(it))).item()
        t0 = time.perf_counter()
        losses = [loss_of(check_batch(next(it))) for _ in range(TOKEN_STEPS)]
        losses = [x.item() for x in losses]
        wall = time.perf_counter() - t0
        it.close()
    launches = kernels.launch_counts.get(flash_attn.KERNEL_NAME, 0)
    if launches != LLAMA.n_layers * (1 + TOKEN_STEPS):
        raise AssertionError(f"{flash_attn.KERNEL_NAME} launched {launches} times for "
                             f"{1 + TOKEN_STEPS} forwards of {LLAMA.n_layers} layers")
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f"non-finite loss: {warm}, {losses}")
    tokens_per_step = TOKEN_BATCH * WINDOW
    log(f"[tokens] {TOKEN_STEPS} steps in {wall:.3f} s: {tokens_per_step * TOKEN_STEPS / wall:.1f} "
        f"tokens/s, step {wall / TOKEN_STEPS * 1e3:.1f} ms; loss warm-up {warm:.4f}, "
        f"steps {[round(x, 4) for x in losses]}; {flash_attn.KERNEL_NAME} launches {launches}")

    # Where the time goes: the reader alone, the reader + the CPU loader,
    # and the forward alone on a resident batch.
    n_windows = 2 * TOKEN_WINDOWS
    t0 = time.perf_counter()
    with reader() as r:
        for _ in range(n_windows):
            next(r)
    wall = time.perf_counter() - t0
    log(f"[tokens] reader alone ({TOKEN_WORKERS} threads, dense NGram): {n_windows} windows in "
        f"{wall:.3f} s: {n_windows / wall:.1f} windows/s")
    t0 = time.perf_counter()
    with reader() as r:
        it = iter(DataLoader(r, batch_size=TOKEN_BATCH, device="cpu"))
        for _ in range(n_windows // TOKEN_BATCH):
            next(it)
        it.close()
    wall = time.perf_counter() - t0
    log(f"[tokens] reader + DataLoader(device='cpu'): {n_windows} windows in {wall:.3f} s: "
        f"{n_windows / wall:.1f} windows/s")
    with reader() as r:
        it = iter(DataLoader(r, batch_size=TOKEN_BATCH, device="cuda"))
        tokens = check_batch(next(it)).clone()
        it.close()
    with torch.inference_mode():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_of(tokens).item()
            times.append(time.perf_counter() - t0)
        fwd = statistics.median(times)
        log(f"[tokens] forward alone on a resident batch (median of 3): {fwd * 1e3:.1f} ms, "
            f"{tokens_per_step / fwd:.1f} tokens/s")
        profile_step(lambda: loss_of(tokens).item(), "resident forward")

        # The slice against itself on plain attention: one batch's logits,
        # and the same forward on wrong attentions to show the bar rejects them.
        def attention(fn):
            fn.supports_gqa = True
            return fn
        want = llama.apply(params, tokens, LLAMA, attn_fn=attention(
            lambda q, k, v: flash_attention_plain(q, k, v, causal=True)[0]))
        scale = want.abs().mean().item()
        controls = {"zero attention": attention(lambda q, k, v: torch.zeros_like(q))}
        controls.update((flaw, attention(lambda q, k, v, flaw=flaw: control_attention(q, k, v, flaw)))
                        for flaw in CONTROLS)
        for name, fn in [("kernel", attn_fn)] + list(controls.items()):
            got = llama.apply(params, tokens, LLAMA, attn_fn=fn)
            if not (torch.isfinite(got).all() and got.shape == (TOKEN_BATCH, WINDOW, LLAMA.vocab)):
                raise AssertionError(f"{name}: bad logits {tuple(got.shape)}")
            rel = (got - want).abs().mean().item() / scale
            ok = rel <= LOGITS_MEAN_REL_BAR
            log(f"[tokens] logits, {name} vs plain attention: mean abs difference {rel:.4%} of "
                f"the mean |logit| {scale:.4g} (bar {LOGITS_MEAN_REL_BAR:.2%}): "
                f"{'within the bar' if ok else 'rejected'}")
            if (name == "kernel" and not ok) or (name in SLICE_MUST_FAIL and ok):
                raise AssertionError(f"logits of {name}: the bar does not hold")
            del got
    return launches


def grad_verdict(got: torch.Tensor, want: torch.Tensor, absolute: bool):
    """-> (max abs err, worst, rms, within every bar) of one gradient; the
    absolute bar (plus one rounding step of the value) only where
    ``absolute``."""
    err = (got.float() - want.float()).abs()
    worst, rms = row_scaled_errors(got, want, GRAD_ROW_FLOOR)
    eps, worst_bar, rms_bar = ROW_BARS[want.dtype]
    ok = worst <= worst_bar and rms <= rms_bar
    if absolute:
        ok = ok and bool((err <= BWD_ABS_BARS[want.dtype] + eps * want.float().abs()).all())
    return err.max().item(), worst, rms, ok


def judge_grads(got, want, absolute: bool, what: str):
    """Log each of (dq, dk, dv) against the plain backward's; -> (max abs
    err of each, within every bar)."""
    readings = [grad_verdict(g, w, absolute) for g, w in zip(got, want)]
    log(f"[bwd] {what}: " + "; ".join(
        f"d{n} max abs {e:.3g} worst {wo:.3g} rms {r:.3g}{'' if ok else ' OUTSIDE'}"
        for n, (e, wo, r, ok) in zip("qkv", readings)))
    return [r[0] for r in readings], all(r[3] for r in readings)


def control_backward(q, k, v, o, lse, do, causal, flaw):
    """The plain backward with one ``flaw`` of BWD_CONTROLS, made by giving
    it altered inputs: o = 0 makes D = rowsum(dO . o) = 0; dO zero on all but
    the first query head of each group leaves dk and dv that head's alone;
    q and dO zero on the last 64 rows take that q tile out of dk and dv;
    lse + ln 1.01 divides every p by 1.01."""
    if flaw == BWD_CONTROLS[0]:
        return flash_attention_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, causal)
    if flaw == BWD_CONTROLS[3]:
        return flash_attention_bwd_plain(q, k, v, o, lse + float(np.log(1.01)), do, causal)
    dq = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)[0]
    if flaw == BWD_CONTROLS[1]:
        rep = q.shape[2] // k.shape[2]
        keep = (torch.arange(q.shape[2], device=q.device) % rep == 0).view(1, 1, -1, 1)
        _, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do * keep, causal)
    else:
        sq = q.shape[1]
        keep = (torch.arange(sq, device=q.device) < (sq - 1) // 64 * 64).view(1, -1, 1, 1)
        _, dk, dv = flash_attention_bwd_plain(q * keep, k, v, o, lse, do * keep, causal)
    return dq, dk, dv


def bwd_flops_bytes(b, sq, sk, h, kv_h, d, causal, itemsize, products, kv_outputs):
    """Operations (2*b*h*d per visible (query, key) pair for each of
    ``products`` products) and bytes (q, dO, k, v, lse and D read once, dq
    or dk and dv written once) of one backward kernel."""
    flops = flash_flops_bytes(b, sq, sk, h, kv_h, d, causal, itemsize, False)[0] // 2 * products
    q_side = b * sq * h * d * itemsize
    kv_side = b * sk * kv_h * d * itemsize
    nbytes = 2 * q_side + 2 * kv_side + 8 * b * h * sq + (2 * kv_side if kv_outputs else q_side)
    return flops, nbytes


#: Launch-count names of each backward route: (K3, K4).
BWD_ROUTES = {flash_attn.TENSOR_CORES: (flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME),
              flash_attn.FMA: (flash_attn.BWD_DQ_FMA_KERNEL_NAME, flash_attn.BWD_DKV_FMA_KERNEL_NAME)}
#: Short backward cases: (b, sq, sk, h, kv_h, d, causal, dtype, what, q/k/v
#: as strided views of one fused (b, s, h + 2 kv_h, d) tensor). The route
#: each takes follows from its dtype and d (flash_attn.bwd_route).
BWD_CASES = [(1, 100, 100, 4, 2, 64, True, torch.bfloat16, "ragged 100x100 d64 causal", False),
             (1, 70, 70, 4, 1, 200, True, torch.float32, "ragged d200 causal, rep 4", False),
             (2, 96, 64, 4, 2, 64, True, torch.bfloat16, "causal sq 96 > sk 64", False),
             (2, 40, 130, 4, 1, 64, True, torch.float32, "causal sq 40 < sk 130, rep 4", False),
             (2, 77, 130, 4, 1, 64, False, torch.bfloat16, "non-causal sq 77, sk 130", False),
             (2, 200, 200, 4, 4, 128, True, torch.bfloat16, "MHA (h == kv_h)", False),
             (2, 300, 300, 8, 2, 64, True, torch.float32, "f32 d64 causal, rep 4", False),
             (2, 150, 150, 8, 4, 128, False, torch.float16, "f16 non-causal", False),
             (1, 70, 90, 2, 1, 256, True, torch.bfloat16, "d256 causal", False),
             (1, WINDOW - 37, WINDOW - 37, 8, 2, 128, True, torch.bfloat16,
              f"ragged {WINDOW - 37} causal (not a multiple of 64)", False),
             (2, 300, 200, 8, 2, 128, True, torch.bfloat16, "causal sq 300 > sk 200, d128", False),
             (2, 200, 300, 8, 2, 128, True, torch.bfloat16, "causal sq 200 < sk 300, d128", False),
             (2, 500, 500, 8, 8, 128, True, torch.bfloat16, "MHA d128 causal", False),
             (2, 1000, 1000, 8, 2, 128, True, torch.float16, "f16 d128 causal", False),
             (2, 1000, 1000, 8, 2, 64, True, torch.bfloat16, "bf16 d64 causal", False),
             (1, 300, 300, 4, 2, 72, True, torch.bfloat16, "bf16 d72 causal", False),
             (1, 300, 300, 4, 2, 32, False, torch.float16, "f16 d32 non-causal", False),
             (1, 130, 130, 4, 2, 60, True, torch.bfloat16, "bf16 d60 causal", False),
             (2, 256, 256, 8, 2, 128, True, torch.bfloat16, "q, k, v strided views of fused qkv", True)]


def bwd_launches():
    """Backward launches since the last reset, by route: {route: (K3, K4)}."""
    return {route: tuple(kernels.launch_counts.get(n, 0) for n in names)
            for route, names in BWD_ROUTES.items()}


def phase_flash_bwd():
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, kv_h, d = TOKEN_BATCH, LLAMA.n_heads, LLAMA.n_kv_heads, LLAMA.head_dim

    def inputs(b, sq, sk, h, kv_h, d, causal, dtype, strided=False):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if strided:
            qkv = randn(b, sq, h + 2 * kv_h, d)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv_h], qkv[:, :, h + kv_h:]
        else:
            q, k, v = randn(b, sq, h, d), randn(b, sk, kv_h, d), randn(b, sk, kv_h, d)
        do = randn(b, sq, h, d)
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        return q, k, v, o, lse, do

    def routed(route):
        """The launch counts one flash_attention_bwd call on ``route`` gives."""
        return {r: (1, 1) if r == route else (0, 0) for r in BWD_ROUTES}

    failures = []
    # The token path's shape: row-scaled bars, equal bits, the controls.
    q, k, v, o, lse, do = inputs(b, WINDOW, WINDOW, h, kv_h, d, True, torch.bfloat16)
    route = flash_attn.bwd_route(q.dtype, d)
    kernels.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    counts = bwd_launches()
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    if route != flash_attn.TENSOR_CORES or counts != routed(route):
        failures.append(f"token path's shape took route {route!r}, launches {counts}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        failures.append("two launches of K3/K4 gave different bits")
    if not all(torch.isfinite(g.float()).all() for g in got):
        failures.append("non-finite gradients at the token path's shape")
    token_errs, ok = judge_grads(got, want, False,
                                 f"kernel ({route}), token path ({b}, {WINDOW}, {h}/{kv_h}, {d}) "
                                 f"bf16 causal; launches {counts}")
    log(f"[bwd] two launches give equal bits: {all(torch.equal(x, y) for x, y in zip(got, again))}")
    if not ok:
        failures.append("the kernels at the token path's shape")
    del got, again
    # The FMA route forced at the same inputs: the same bars.
    fma_in = flash_attn._bwd_inputs(flash_attn.FMA, q, k, v, o, lse, do)
    fma_got = (flash_attn._flash_bwd_dq(flash_attn.FMA, *fma_in, True),
               *flash_attn._flash_bwd_dkv(flash_attn.FMA, *fma_in, True))
    fma_errs, fma_ok = judge_grads(fma_got, want, False, "FMA route forced, token path's shape")
    if not fma_ok:
        failures.append("the FMA route at the token path's shape")
    del fma_got
    for flaw in BWD_CONTROLS:
        _, c_ok = judge_grads(control_backward(q, k, v, o, lse, do, True, flaw), want, False,
                              f"control {flaw!r}")
        log(f"[bwd] control {flaw!r}: {'within the bars' if c_ok else 'rejected'}")
        if c_ok and flaw in BWD_MUST_FAIL:
            failures.append(f"control {flaw!r} within the bars")
    del want
    # Short cases, on whichever route they take: absolute bars as well.
    for *shape, causal, dtype, what, strided in BWD_CASES:
        c_q, c_k, c_v, c_o, c_lse, c_do = inputs(*shape, causal, dtype, strided)
        c_route = flash_attn.bwd_route(dtype, shape[5])
        kernels.reset_launch_counts()
        c_got = flash_attention_bwd(c_q, c_k, c_v, c_o, c_lse, c_do, causal)
        c_counts = bwd_launches()
        _, c_ok = judge_grads(c_got, flash_attention_bwd_plain(c_q, c_k, c_v, c_o, c_lse, c_do, causal),
                              True, f"{what} [{c_route}; launches {c_counts}]")
        if not c_ok or c_counts != routed(c_route):
            failures.append(what)

    # Times at the token path's shape, in turns: K3 and K4 of both routes
    # alone (D and the layouts made once), the whole tensor-core backward,
    # the plain backward, and SDPA's backward without its forward.
    tc_in = flash_attn._bwd_inputs(flash_attn.TENSOR_CORES, q, k, v, o, lse, do)
    qq, kk, vv = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, enable_gqa=True)
    g = do.transpose(1, 2)
    dq_ms, dkv_ms, dq_fma_ms, dkv_fma_ms, bwd_ms, plain_ms, library_ms = median_ms(
        lambda: flash_attn._flash_bwd_dq(flash_attn.TENSOR_CORES, *tc_in, True),
        lambda: flash_attn._flash_bwd_dkv(flash_attn.TENSOR_CORES, *tc_in, True),
        lambda: flash_attn._flash_bwd_dq(flash_attn.FMA, *fma_in, True),
        lambda: flash_attn._flash_bwd_dkv(flash_attn.FMA, *fma_in, True),
        lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
        lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
        lambda: torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True),
        reps=FLASH_REPS, warmup=1)
    rows = {}
    for name, ms, products, kv_outputs, err in (
            ("K3", dq_ms, 3, False, token_errs[0]), ("K4", dkv_ms, 4, True, max(token_errs[1:])),
            ("K3 fma", dq_fma_ms, 3, False, fma_errs[0]),
            ("K4 fma", dkv_fma_ms, 4, True, max(fma_errs[1:]))):
        flops, nbytes = bwd_flops_bytes(b, WINDOW, WINDOW, h, kv_h, d, True, 2, products, kv_outputs)
        bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        log(f"[bwd] {name} at the token path's shape: {ms:.4f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by} ({flops:.4g} operations, {nbytes / 1e9:.4g} GB), {flops / ms / 1e9:.4g} "
            f"TFLOP/s")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}
    log(f"[bwd] flash_attention_bwd (D + K3 + K4, tensor cores) {bwd_ms:.4f} ms; plain backward "
        f"(dq, dk, dv together) {plain_ms:.4f} ms; scaled_dot_product_attention backward "
        f"{library_ms:.4f} ms; FMA route K3 + K4 {dq_fma_ms + dkv_fma_ms:.4f} ms against tensor "
        f"cores {dq_ms + dkv_ms:.4f} ms")
    if failures:
        raise AssertionError("flash backward: " + "; ".join(failures))
    return rows


class CountingPlainVersions:
    """While active, counts the calls of the plain flash forward and
    backward (the module functions the wrappers call on CPU tensors)."""

    def __enter__(self):
        self.calls = {"flash_attention_plain": 0, "flash_attention_bwd_plain": 0}
        self.saved = {name: getattr(flash_attn, name) for name in self.calls}
        for name, fn in self.saved.items():
            def counted(*a, _name=name, _fn=fn, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(flash_attn, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(flash_attn, name, fn)
        return False


def attention(fn):
    """``fn(q, k, v)`` as a GQA-native ``attn_fn``."""
    fn.supports_gqa = True
    return fn


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(tmp: str) -> dict:
    url = f"file://{tmp}/tokens"
    write_token_store(url, windows=TOKEN_WINDOWS, window=WINDOW, vocab=LLAMA.vocab, seed=0)
    model_kwargs = {f.name: getattr(LLAMA, f.name) for f in dataclasses.fields(LLAMA)}
    names = (flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME)
    fma_names = BWD_ROUTES[flash_attn.FMA]   # never launched on this path
    failures = []

    # The main path, counted: one warm-up, the timed steps, the resident ones.
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with CountingPlainVersions() as plain:
        result = run_llm_bench(url, steps=TRAIN_STEPS, batch_size=TOKEN_BATCH, window=WINDOW,
                               workers_count=TOKEN_WORKERS, resident_steps=TRAIN_RESIDENT,
                               flash=True, model_kwargs=model_kwargs, device="cuda")
    launches = {n: kernels.launch_counts.get(n, 0) for n in names + fma_names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for key, value in result.items():
        log(f"[train] {key}: {value}")
    steps = 1 + TRAIN_STEPS + TRAIN_RESIDENT
    log(f"[train] launches {launches} for {steps} steps of {LLAMA.n_layers} layers; plain "
        f"versions called {plain.calls}; peak memory {peak_gb:.2f} GB")
    if any(launches[n] != LLAMA.n_layers * steps for n in names) or any(plain.calls.values()) \
            or any(launches[n] for n in fma_names):
        failures.append(f"launches {launches}, plain calls {plain.calls}")
    if not (np.isfinite(result["loss_first"]) and np.isfinite(result["loss_last"])):
        failures.append(f"non-finite loss {result['loss_first']}, {result['loss_last']}")

    ngram = NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    with make_reader(url, schema_fields=ngram, shuffle_row_groups=True, seed=0,
                     workers_count=TOKEN_WORKERS, num_epochs=None) as r:
        it = iter(DataLoader(r, batch_size=TOKEN_BATCH, device="cuda"))
        batch = {"tokens": next(it)["token"].clone()}
        it.close()

    def fresh_params():
        return llama.init_params(torch.Generator(device="cuda").manual_seed(0), LLAMA, device="cuda")

    # One step as the bench takes it, then one with remat_layers and xent_chunk.
    losses = {}
    remat = f"remat_layers, xent_chunk={XENT_CHUNK}"
    for label, kw in (("plain step", {}), (remat, {"remat_layers": True,
                                                  "xent_chunk": XENT_CHUNK})):
        free_cuda()
        params = fresh_params()
        init_opt, step = llama.make_train_step(LLAMA, attn_fn=make_flash_attention(causal=True),
                                               shift="roll", **kw)
        opt = init_opt(params)

        def watched():   # a few leaves, to see that the step moves them
            return {"embed": params["embed"], "layers.0.wq": params["layers"][0]["wq"],
                    "last layer's w2": params["layers"][-1]["w2"], "lm_head": params["lm_head"]}
        before = {n: t.detach().clone() for n, t in watched().items()}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        _, opt, loss = step(params, opt, batch)
        losses[label] = loss.item()
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = {n: kernels.launch_counts.get(n, 0) for n in names + fma_names}
        moved = {n: not torch.equal(before[n], t.detach()) for n, t in watched().items()}
        log(f"[train] {label}: loss {losses[label]:.6f}, launches {counts}, peak memory "
            f"{peak:.2f} GB, parameters moved {moved}")
        want_k2 = LLAMA.n_layers * (2 if kw else 1)
        if counts != {names[0]: want_k2, names[1]: LLAMA.n_layers, names[2]: LLAMA.n_layers,
                      fma_names[0]: 0, fma_names[1]: 0}:
            failures.append(f"{label}: launches {counts}")
        if not all(moved.values()):
            failures.append(f"{label}: parameters did not move {moved}")
        if not kw:
            profile_step(lambda: step(params, opt, batch)[2].item(), "resident train step",
                         TRAIN_GROUPS)
        del params, opt, init_opt, step, before
    if abs(losses["plain step"] - losses[remat]) > 5e-3:
        failures.append(f"remat/xent_chunk loss {losses}")

    # Whole-slice gradient check against the plain forward and backward.
    free_cuda()
    params = fresh_params()
    leaves = llama.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    leaf_names = []   # in llama.param_leaves' order
    for key in sorted(params):
        if key == "layers":
            leaf_names += [f"layers.{i}.{k}" for i, layer in enumerate(params["layers"])
                           for k in sorted(layer)]
        else:
            leaf_names.append(key)

    def grads(fwd, bwd):
        attn_fn = attention(lambda q, k, v: FlashAttentionFunction.apply(q, k, v, True, fwd, bwd))
        loss = llama.loss_fn(params, batch, LLAMA, attn_fn=attn_fn, shift="roll")
        return torch.autograd.grad(loss, leaves)

    ref = grads(flash_attention_plain, flash_attention_bwd_plain)
    readings = {}
    runs = [("kernels (K2, K3, K4)", flash_attention_lse, flash_attention_bwd),
            ("plain forward, kernel backward (K3, K4)", flash_attention_plain, flash_attention_bwd)]
    runs += [(f"control {flaw!r}", flash_attention_plain,
              lambda *a, flaw=flaw: control_backward(*a, flaw=flaw)) for flaw in BWD_CONTROLS]
    n = LLAMA.n_layers
    want_launches = [{names[0]: n, names[1]: n, names[2]: n}, {names[1]: n, names[2]: n}]
    for (label, fwd, bwd), want in zip(runs, want_launches + [{}] * len(BWD_CONTROLS)):
        kernels.reset_launch_counts()
        got = grads(fwd, bwd)
        if kernels.launch_counts != want:
            failures.append(f"{label}: launches {dict(kernels.launch_counts)}, expected {want}")
        rel = [((g - r).norm() / r.norm()).item() for g, r in zip(got, ref)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        readings[label] = rel[worst]
        attn_leaves = {n: round(x, 5) for n, x in zip(leaf_names, rel) if n.startswith("layers.0.w")}
        log(f"[grad] {label}: largest |g - g_plain| / |g_plain| {rel[worst]:.5f} at "
            f"{leaf_names[worst]}; layer 0: {attn_leaves}; launches {dict(kernels.launch_counts)}")
        del got
    for (label, value), bar in zip(readings.items(), (GRAD_REL_BAR, GRAD_BWD_REL_BAR)):
        if value > bar:
            failures.append(f"{label}: gradient {value:.5f} > {bar}")
    for flaw in BWD_CONTROLS:
        value = readings[f"control {flaw!r}"]
        within = [bar for bar in (GRAD_BWD_REL_BAR, GRAD_REL_BAR) if value <= bar]
        log(f"[grad] control {flaw!r}: {value:.5f}, " + (
            f"within {within}" if within else "rejected by both bars"))
        if GRAD_BWD_REL_BAR in within or (flaw in GRAD_MUST_FAIL and within):
            failures.append(f"control {flaw!r}: gradient {value:.5f} within {within}")
    del ref, params, leaves
    free_cuda()
    if failures:
        raise AssertionError("training path: " + "; ".join(failures))
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
    k2 = phase_flash()
    with tempfile.TemporaryDirectory() as tmp:
        k2_launches = phase_tokens(tmp)
    bwd = phase_flash_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_train(tmp)
    source = "petastorm_tpu_torch/csrc/flash_attn_bwd.cu"
    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/normalize.cu",
        "replaces": "petastorm_tpu/ops/image_ops.py:27",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        "name": flash_attn.KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        # The token forward's launches ("out") and the training path's ("lse").
        "launches": k2_launches + counts[flash_attn.KERNEL_NAME], **k2}, {
        "name": flash_attn.BWD_DQ_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:272",
        "launches": counts[flash_attn.BWD_DQ_KERNEL_NAME], **bwd["K3"]}, {
        "name": flash_attn.BWD_DKV_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:305",
        "launches": counts[flash_attn.BWD_DKV_KERNEL_NAME], **bwd["K4"]}, {
        # The FMA route (f32, 16-bit d > 128 or d % 8 != 0): timed forced at
        # the token path's bf16 shape; the main path never launches it.
        "name": flash_attn.BWD_DQ_FMA_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:272",
        "launches": counts[flash_attn.BWD_DQ_FMA_KERNEL_NAME], **bwd["K3 fma"]}, {
        "name": flash_attn.BWD_DKV_FMA_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:305",
        "launches": counts[flash_attn.BWD_DKV_FMA_KERNEL_NAME], **bwd["K4 fma"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
