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
   that the bar must reject.

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
import torch.nn.functional as F

from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.kernels.build import build
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops import flash_attn
from petastorm_tpu_torch.ops.flash_attn import (flash_attention, flash_attention_lse,
                                                flash_attention_plain, make_flash_attention)
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
    paths = build(["normalize", "flash_attn"])
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


def row_scaled_errors(got: torch.Tensor, want: torch.Tensor):
    """(worst, rms) of ``got - want`` against each output row's scale:
    max (|err| - eps |want|) / rms(row) and sqrt(mean((err / rms(row))^2))."""
    w = want.float()
    row = w.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
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


def profile_forward(step) -> None:
    """One ``step`` under ``torch.profiler``: device time by kernel (the
    kernels' own events, so nothing is counted twice) against the host
    wall time; the rest of the wall time is the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    busy_ms = sum(by_kernel.values())
    if busy_ms <= 0:
        raise AssertionError("the profiled forward shows no device time")
    groups = {"flash_fwd_kernel (K2)": 0.0, "matmuls (cuBLAS)": 0.0, "everything else": 0.0}
    for name, ms in by_kernel.items():
        if "flash_fwd_kernel" in name:
            groups["flash_fwd_kernel (K2)"] += ms
        elif any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass")):
            groups["matmuls (cuBLAS)"] += ms
        else:
            groups["everything else"] += ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    log(f"[tokens] profiled forward: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %), {len(by_kernel)} kernels; by group: "
        + "; ".join(f"{g} {ms:.1f} ms ({100 * ms / busy_ms:.1f} %)" for g, ms in groups.items()))
    log("[tokens] top kernels: " + "; ".join(
        f"{name[:60]} {ms:.1f} ms ({100 * ms / busy_ms:.1f} %)" for name, ms in top))


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
        profile_forward(lambda: loss_of(tokens).item())

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
        "launches": k2_launches, **k2}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
