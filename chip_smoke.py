#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. probe: torch, the device, ``nvidia-smi`` name and power limit, and the
   host libraries the reader needs (pyarrow, cv2 or PIL, fsspec);
2. build every CUDA kernel of the main path from ``petastorm_tpu_torch/csrc``;
3. hold K1 against its plain PyTorch version on the card, bit for bit, at
   the main path's shapes, at ragged ones and on contiguous views that are
   not 16-byte aligned, and time both with CUDA events (every timing starts
   behind a device sleep, so the host's preparation of a call is not
   counted); then K1's general route (``normalize_u8_strided``) on crops,
   transposes, an NCHW tensor seen as NHWC, 1 and 5 channels and a
   zero-size crop, bit for bit with the launch name checked, and timed on
   the main path's batch cropped to 208x208;
4. the main path at full size: a seeded 2048-row store of 224x224x3 JPEG
   images written with the package's writer, read by ``make_reader``
   (8 decode threads), batched by ``DataLoader(batch_size=256,
   device="cuda")`` and normalised on the card by ``normalize_images``, two
   epochs; launch counts are reset just before and read just after. Then
   the staged bytes of a CUDA loader are held against a CPU loader's;
5. flash attention (K2) against its plain version on the card: the token
   path's shape (2, 8192, 32 heads over 8 kv heads, 128) bf16 causal in
   its "out" and "lse" modes on the tensor-core route, then ragged,
   cross-length, non-causal, MHA, f32, f16 and head-dim cases on whichever
   route ``ops.flash_attn.fwd_route`` gives them (logged, launch counts
   checked), q/k/v as views of one fused tensor (read in place), each held
   to an absolute bar and to bars scaled to each output row; deliberately
   wrong attentions made from the plain version must fail those bars on
   the long rows; the FMA route forced at the token path's shape, held to
   the same bars; equal bits over two launches; both routes in both modes,
   the plain version and PyTorch's ``scaled_dot_product_attention``
   (yardstick only) timed with CUDA events, in turns;
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
   and read just after (the tensor-core K2, K3 and K4 once per layer per
   step; the FMA routes and the plain versions never). Then one step with ``remat_layers`` and ``xent_chunk``
   against the plain step, a ``torch.profiler`` split of one resident
   step, and the whole-slice gradient check: every parameter's gradient
   through the kernels against the plain forward and backward, with the
   wrong backwards as controls;
9. the image path's end to end: ``run_imagenet_bench`` (ResNet-50 at
   224x224, SGD, batch 256, 8 decode threads, 20 pipelined steps and 5
   resident ones) on a 2048-row ``write_synthetic_imagenet`` store, fed by
   ``make_reader`` -> ``DataLoader(device="cuda")``; its result keys must be
   the JAX bench's, its losses finite, and none of the port's kernels run
   (the bench preprocesses with ``/ 255`` as the reference does). Then a
   ``torch.profiler`` split of one resident step, the peak memory of one
   step with and without ``remat``, and the flagship forward of
   ``petastorm_tpu_torch.entry`` (bf16) against the same forward in float32
   with TF32 off, timed;
10. sequence-parallel Llama training. First K2's "stats" mode (the ring's
   local step: the unnormalised float32 output, the row max m and the
   normaliser l) against its plain version on the card at the ring's block
   (1, 4096, 32 heads over 8 kv heads, 128) bf16, causal (the diagonal
   block) and not (a past block), on the tensor-core route and with the FMA
   route forced, then a ragged and a GQA case on whichever route they take;
   o held to the row-scaled bars, m and l to float32 bars, and wrong stats
   (``STATS_CONTROLS``) must fail them; K3 and K4 as the ring's backward
   launches them (a diagonal and a past block against the global lse of
   the two merged) held to the plain backward with phase 7's bars, which
   ``BWD_CONTROLS`` must fail; both routes, the plain version and
   ``scaled_dot_product_attention`` timed. Then the path:
   ``run_seq_parallel_train`` spawns 2 ranks on ``cuda:0`` (gloo), each
   reading the same windows of 8192 tokens from a ``write_token_store``
   store through the NGram reader and a ``DataLoader`` and training
   ``LlamaConfig()`` at full width (2 of its 32 layers, bf16, AdamW) on its
   4096-token block, 3 steps with ring attention (``local_attn="flash"``:
   K2 "stats", K3, K4), then 3 with Ulysses (K2 "lse", K3, K4); launch
   counts are reset just before and read just after, on every rank. The
   first step's loss and summed gradients are held against one process
   training on the whole window with ``make_flash_attention``, and the two
   strategies against each other.

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
from petastorm_tpu_torch.benchmark.imagenet_bench import (run_imagenet_bench,
                                                          write_synthetic_imagenet)
from petastorm_tpu_torch.benchmark.llm_bench import run_llm_bench, write_token_store
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.kernels.build import build
from petastorm_tpu_torch.entry import entry
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.models import llama, resnet
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops import flash_attn
from petastorm_tpu_torch.ops.flash_attn import (FlashAttentionFunction, flash_attention,
                                                flash_attention_bwd, flash_attention_bwd_plain,
                                                flash_attention_lse, flash_attention_plain,
                                                make_flash_attention)
from petastorm_tpu_torch.ops.image_ops import (KERNEL_NAME, STRIDED_KERNEL_NAME,
                                               normalize_images, normalize_images_plain)
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
#: Device clock cycles of the sleep each timing starts behind (about 2 ms
#: at the H100's 1.98 GHz boost clock).
SLEEP_CYCLES = 4_000_000

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

# Image path: the JAX package's ImageNet bench at ResNet-50's full width
# (224x224, 1000 -> 100 classes as the bench's default), batch 256; the
# store is cut to 2048 rows so it is written inside the run.
IMAGENET_ROWS, IMAGENET_CLASSES, IMAGENET_BATCH = 2048, 100, 256
IMAGENET_STEPS, IMAGENET_RESIDENT, IMAGENET_WORKERS = 20, 5, 8
#: The JAX bench's result keys on a device with a known peak.
IMAGENET_KEYS = {"samples_per_sec", "samples_per_sec_per_chip", "input_stall_pct", "devices",
                 "global_batch", "echo", "loss_first", "loss_last", "step_time_ms",
                 "device_kind", "step_time_ms_resident", "samples_per_sec_resident",
                 "samples_per_sec_per_chip_resident", "model_flops_per_step_per_chip",
                 "achieved_tflops_per_chip", "mfu_pct", "peak_flops_source",
                 "achieved_tflops_per_chip_resident", "mfu_pct_resident"}
#: The flagship forward in bf16 against itself in float32 (TF32 off): mean
#: |difference| over mean |logit|. On the CPU the port read 0.36 % on the
#: reference's weights and 0.49 % on its own (the JAX package's own bf16
#: forward 0.37 %); tests/test_torch_imagenet_bench.py.
ENTRY_F32_BAR = 0.01

# Sequence parallelism (phase 10): LlamaConfig() at full width, 2 of its 32
# layers, the token path's window over 2 ranks on one card.
SEQ_RANKS, SEQ_STEPS = 2, 3
SEQ_LLAMA = llama.LlamaConfig(n_layers=2)
SEQ_BLOCK = WINDOW // SEQ_RANKS
SEQ_WATCH = ("layers.0.wq", "layers.0.wk", "layers.0.wo", "embed")
#: K2 "stats" against its plain version: o by ROW_BARS of its inputs' type
#: (o is float32, but p is rounded to bf16 before p v), m absolute and l
#: relative. On an H100 the kernels read m 2.4e-6 and l 2.4e-6 at the ring's
#: block (the FMA route 0 and 5.5e-7); every control reads 1e-2 or more.
STATS_M_BAR, STATS_L_REL_BAR = 2e-5, 2e-5
STATS_CONTROLS = ("m left in units of log2", "normaliser l 1 % off", "last K/V tile skipped",
                  "1 key in 32 dropped", "o divided by l")
#: The sequence-parallel step's first loss against one process on the whole
#: window: |difference| / loss, both in bf16 compute (the ring merges its
#: blocks' partials in float32, one process takes the whole row at once).
SEQ_LOSS_REL_BAR = 2e-3


def log(msg):
    print(msg, flush=True)


def ordered_bits16(t: torch.Tensor) -> torch.Tensor:
    """16-bit float bit patterns mapped to integers that are consecutive
    for consecutive representable values (sign-magnitude -> two's order)."""
    i = t.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def check_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Bit-equal in every dtype: the kernel rounds x*scale and then the add
    one at a time, as the plain version does (no contracted FMA). Returns
    the max abs error (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    if not torch.equal(got.view(bits), want.view(bits)):
        ulps = (ordered_bits16(got) - ordered_bits16(want)).abs().max().item() \
            if bits == torch.int16 else None
        raise AssertionError(f"{what}: not bit-equal (max abs error {err}, max {ulps} ulp)")
    return err


def median_ms(*fns, reps=TIMING_REPS, warmup=3) -> list:
    """Median CUDA-event time of each of ``fns``, timed in turns (the order
    alternates every repetition) after ``warmup`` calls of each. Each
    timing starts behind a device sleep of about 2 ms (``SLEEP_CYCLES``),
    during which the host prepares the call, so the time is the device's
    from the call's first kernel on: without it, a call whose host side
    takes longer than its kernels (K1: about 0.2 ms of Python around a
    kernel of tens of microseconds) would be timed by its host side."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for rep in range(reps):
        order = range(len(fns)) if rep % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
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
    # (shape, dtype, factors, offset): a non-zero offset makes the input a
    # contiguous view that many bytes into its allocation, so not 16-byte
    # aligned (the kernel's scalar loop); odd lengths leave a tail that is
    # not a whole 16-byte vector.
    cases = [((BATCH,) + IMAGE_SHAPE, torch.bfloat16, imagenet, 0),
             ((BATCH,) + IMAGE_SHAPE, torch.float32, imagenet, 0),
             ((3, 17, 19, 3), torch.bfloat16, imagenet, 0), ((3, 17, 19, 3), torch.float32, imagenet, 0),
             ((16, 224, 224, 1), torch.bfloat16, imagenet, 0),
             ((16, 64, 64, 4), torch.float16, imagenet, 0),
             ((8,) + IMAGE_SHAPE, torch.bfloat16, cancelling, 0),
             ((5, 33, 31, 3), torch.bfloat16, imagenet, 1),
             ((5, 33, 31, 3), torch.float32, cancelling, 7),
             ((7, 13, 11, 2), torch.float16, imagenet, 0),
             ((8,) + IMAGE_SHAPE, torch.bfloat16, imagenet, 5)]
    result = None
    for shape, dtype, (mean, std), offset in cases:
        flat = rng.integers(0, 256, int(np.prod(shape)) + offset, dtype=np.uint8)
        x = torch.from_numpy(flat).cuda()[offset:].view(shape)
        kernels.reset_launch_counts()
        got = normalize_images(x, mean, std, out_dtype=dtype)
        if kernels.launch_counts != {KERNEL_NAME: 1}:
            raise AssertionError(f"{shape} {dtype}: launches {kernels.launch_counts}")
        want = normalize_images_plain(x, mean, std, out_dtype=dtype)
        torch.cuda.synchronize()
        err = check_close(got, want, f"{shape} {dtype} offset {offset}")
        line = (f"[kernel] {KERNEL_NAME} {shape} {dtype} (data_ptr % 16 = {x.data_ptr() % 16}): "
                f"bit-equal, max abs err {err:.3g}")
        if shape == (BATCH,) + IMAGE_SHAPE and offset == 0:
            n = x.numel()
            out_bytes = torch.empty((), dtype=dtype).element_size()
            bound_ms = max(n * (1 + out_bytes) / HBM_BYTES_PER_S,
                           2 * n / F32_FLOPS) * 1e3
            ms, plain_ms = median_ms(
                lambda: normalize_images(x, mean, std, out_dtype=dtype),
                lambda: normalize_images_plain(x, mean, std, out_dtype=dtype))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({n * (1 + out_bytes) / 1e6:.1f} MB), kernel at {bound_ms / ms:.1%} of "
                     f"the bound; no single PyTorch call "
                     f"computes this function (library_ms null)")
            if dtype == torch.bfloat16:  # the main path's output type
                result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms}
        log(line)
    return result, phase_strided()


#: K1's general route: (what, view of a contiguous uint8 batch on the card,
#: channels, out dtype). The batch is (8, 256, 256, 3) unless a view says
#: otherwise.
STRIDED_CASES = [
    ("crop [:, 16:240, 16:240]", lambda x: x[:, 16:240, 16:240], 3, torch.bfloat16),
    ("crop [:, 16:240, 16:240]", lambda x: x[:, 16:240, 16:240], 3, torch.float32),
    ("crop [:, 16:240, 16:240]", lambda x: x[:, 16:240, 16:240], 3, torch.float16),
    ("transpose(1, 2)", lambda x: x.transpose(1, 2), 3, torch.bfloat16),
    ("NCHW and back through a view",
     lambda x: x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), 3, torch.float32),
    ("every other image, odd crop", lambda x: x[::2, 3:250, 5:254], 3, torch.bfloat16),
    ("C = 1, cropped", lambda x: x[..., :1].contiguous()[:, 8:216, 8:216], 1, torch.bfloat16),
    ("C = 5, contiguous", lambda x: x.reshape(-1)[:8 * 100 * 100 * 5].view(8, 100, 100, 5), 5,
     torch.float16),
    ("C = 5, cropped", lambda x: x.reshape(-1)[:8 * 100 * 100 * 5].view(8, 100, 100, 5)[:, 1:99],
     5, torch.bfloat16),
    ("zero-size crop", lambda x: x[:, 5:5], 3, torch.bfloat16),
]
STRIDED_FACTORS = ((0.4, 0.5, 0.6, 0.7, 0.45), (0.2, 0.25, 0.3, 0.35, 0.3))
#: The timed case: the main path's batch cropped to 208x208.
CROP = 208


def phase_strided() -> dict:
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)).cuda()
    for what, view, channels, dtype in STRIDED_CASES:
        x = view(base)
        mean, std = (f[:channels] for f in STRIDED_FACTORS)
        kernels.reset_launch_counts()
        got = normalize_images(x, mean, std, out_dtype=dtype)
        counts = dict(kernels.launch_counts)
        want = normalize_images_plain(x, mean, std, out_dtype=dtype).contiguous()
        torch.cuda.synchronize()
        if counts != ({STRIDED_KERNEL_NAME: 1} if x.numel() else {}):
            raise AssertionError(f"{what} {dtype}: launches {counts}")
        if not got.is_contiguous() or got.shape != x.shape:
            raise AssertionError(f"{what} {dtype}: output {tuple(got.shape)} "
                                 f"{got.stride()}, not contiguous of the input's shape")
        err = check_close(got, want, f"{what} {dtype}") if x.numel() else 0.0
        log(f"[kernel] {STRIDED_KERNEL_NAME} {what} {tuple(x.shape)} strides {x.stride()} "
            f"{dtype}: bit-equal, max abs err {err:.3g}, launches {counts}")
    del base
    # The main path's batch, cropped: the general route against the plain
    # version, and the vector route on the uncropped batch beside it.
    full = torch.from_numpy(rng.integers(0, 256, (BATCH,) + IMAGE_SHAPE, dtype=np.uint8)).cuda()
    off = (IMAGE_SHAPE[0] - CROP) // 2
    x = full[:, off:off + CROP, off:off + CROP]
    kernels.reset_launch_counts()
    got = normalize_images(x)
    if kernels.launch_counts != {STRIDED_KERNEL_NAME: 1}:
        raise AssertionError(f"cropped batch: launches {kernels.launch_counts}")
    err = check_close(got, normalize_images_plain(x).contiguous(), "cropped batch")
    ms, plain_ms, contiguous_ms = median_ms(lambda: normalize_images(x),
                                            lambda: normalize_images_plain(x),
                                            lambda: normalize_images(full))
    n = x.numel()
    bound_ms = max(n * 3 / HBM_BYTES_PER_S, 2 * n / F32_FLOPS) * 1e3
    full_bound_ms = full.numel() * 3 / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] {STRIDED_KERNEL_NAME} main path's batch cropped to {tuple(x.shape)} bf16: "
        f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({n * 3 / 1e6:.1f} MB), kernel at {bound_ms / ms:.1%} of the bound; the vector "
        f"route on the uncropped batch {contiguous_ms:.4f} ms against its bound "
        f"{full_bound_ms:.4f} ms ({bound_ms / ms:.1%} against {full_bound_ms / contiguous_ms:.1%})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


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
    if set(kernels.launch_counts) != {KERNEL_NAME}:
        raise AssertionError(f"the image path launched {kernels.launch_counts}")
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


def row_scaled_errors(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0, dtype=None):
    """(worst, rms) of ``got - want`` against each output row's scale:
    max (|err| - eps |want|) / rms(row) and sqrt(mean((err / rms(row))^2)).
    With ``floor`` a row's scale is at least that fraction of the whole
    tensor's rms. eps is that of ``dtype`` (default want's)."""
    w = want.float()
    row = w.square().mean(-1, keepdim=True).sqrt().clamp_min(
        max(1e-30, floor * w.square().mean().sqrt().item()))
    err = (got.float() - w).abs()
    worst = ((err - ROW_BARS[dtype or want.dtype][0] * w.abs()) / row).max().item()
    return worst, (err / row).square().mean().sqrt().item()


def flash_verdict(got: torch.Tensor, want: torch.Tensor):
    """-> (max abs err, worst, rms, within every bar)."""
    err = (got.float() - want.float()).abs().max().item()
    worst, rms = row_scaled_errors(got, want)
    _, worst_bar, rms_bar = ROW_BARS[want.dtype]
    return err, worst, rms, err <= FLASH_BARS[want.dtype] and worst <= worst_bar and rms <= rms_bar


def check_flash(gen, b, sq, sk, h, kv_h, d, causal, dtype, what):
    """Kernel ("out" and "lse") against the plain version on the same
    inputs; raises past the stated bars. -> (inputs, plain output, plain
    lse, max abs err)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v = randn(b, sq, h, d), randn(b, sk, kv_h, d), randn(b, sk, kv_h, d)
    route = flash_attn.fwd_route(dtype, d)
    kernels.reset_launch_counts()
    o_out = flash_attention(q, k, v, causal=causal)
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    counts = dict(kernels.launch_counts)
    want_o, want_lse = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if counts != {flash_attn._FWD_KERNELS[route]: 2}:
        raise AssertionError(f"{what}: route {route!r}, launches {counts}")
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
    log(f"[flash] {what} [{route}; launches {counts}]: max abs err o {err:.3g} "
        f"(bar {FLASH_BARS[dtype]}), row-scaled worst {worst:.3g} (bar {worst_bar:.3g}) "
        f"rms {rms:.3g} (bar {rms_bar:.3g}); "
        f"lse {lse_err:.3g} (bar {LSE_BAR})")
    if not (ok and lse_err <= LSE_BAR):
        raise AssertionError(f"{what}: the kernel's output is outside a bar")
    return (q, k, v), want_o, want_lse, err


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
    (q, k, v), want, want_lse, err = check_flash(
        gen, b, WINDOW, WINDOW, h, kv_h, d, True, torch.bfloat16,
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
                 (1, 70, 70, 2, 1, 256, True, torch.bfloat16, "d256 causal"),
                 (2, 40, 130, 4, 1, 128, True, torch.bfloat16, "causal sq 40 < sk 130, rep 4"),
                 (1, WINDOW - 37, WINDOW - 37, 8, 2, 128, True, torch.bfloat16,
                  f"ragged {WINDOW - 37} causal (not a multiple of 64)"),
                 (1, 300, 300, 4, 2, 72, True, torch.bfloat16, "bf16 d72 causal"),
                 (1, 300, 300, 4, 2, 32, False, torch.float16, "f16 d32 non-causal"),
                 (1, 130, 130, 4, 2, 60, True, torch.bfloat16, "bf16 d60 causal")]:
        check_flash(gen, *case)
    # Fused qkv views: TMA reads them in place, without a copy.
    qkv = torch.randn(2, 256, 8 + 2 * 2, 128, generator=gen, device="cuda").bfloat16()
    views = (qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:])
    if not all(a is b for a, b in zip(flash_attn._fwd_inputs(flash_attn.TENSOR_CORES, *views), views)):
        raise AssertionError("a fused qkv view was copied on the tensor-core route")
    kernels.reset_launch_counts()
    f_o, f_lse = flash_attention_lse(*views, causal=True)
    f_want, f_want_lse = flash_attention_plain(*views, causal=True)
    f_err, f_worst, f_rms, f_ok = flash_verdict(f_o, f_want)
    f_lse_err = (f_lse - f_want_lse).abs().max().item()
    log(f"[flash] q, k, v strided views of fused qkv [launches {dict(kernels.launch_counts)}]: max "
        f"abs err o {f_err:.3g}, row-scaled worst {f_worst:.3g} rms {f_rms:.3g}; lse {f_lse_err:.3g}")
    if not (f_ok and f_lse_err <= LSE_BAR) or kernels.launch_counts != {flash_attn.KERNEL_NAME: 1}:
        raise AssertionError("fused qkv views: outside a bar or not on the tensor-core route")
    # The FMA route forced at the token path's shape: the same bars.
    fma_o, fma_lse = flash_attn._flash_fwd(flash_attn.FMA, q, k, v, True, True)
    fma_err, fma_worst, fma_rms, fma_ok = flash_verdict(fma_o, want)
    fma_lse_err = (fma_lse - want_lse).abs().max().item()
    log(f"[flash] FMA route forced, token path's shape: max abs err o {fma_err:.3g}, row-scaled "
        f"worst {fma_worst:.3g} rms {fma_rms:.3g}; lse {fma_lse_err:.3g}")
    if not (fma_ok and fma_lse_err <= LSE_BAR):
        raise AssertionError("the FMA route forced at the token path's shape: outside a bar")
    again = flash_attention_lse(q, k, v, causal=True)
    first = flash_attention_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    equal = torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    log(f"[flash] two launches give equal bits: {equal}")
    if not equal:
        raise AssertionError("two launches of K2 gave different bits")
    del again, first, fma_o, fma_lse

    # Times at the token path's shape, in turns: both routes in both modes,
    # the plain version and SDPA.
    flops, nbytes = flash_flops_bytes(b, WINDOW, WINDOW, h, kv_h, d, True, 2, with_lse=False)
    bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
    ms, lse_ms, fma_ms, fma_lse_ms, plain_ms, library_ms = median_ms(
        lambda: flash_attention(q, k, v, causal=True),
        lambda: flash_attention_lse(q, k, v, causal=True),
        lambda: flash_attn._flash_fwd(flash_attn.FMA, q, k, v, True, False),
        lambda: flash_attn._flash_fwd(flash_attn.FMA, q, k, v, True, True),
        lambda: flash_attention_plain(q, k, v, causal=True),
        lambda: sdpa(q, k, v), reps=FLASH_REPS, warmup=1)
    log(f"[flash] token path shape: tensor cores {ms:.4f} ms ('lse' mode {lse_ms:.4f} ms), "
        f"{flops / ms / 1e9:.4g} TFLOP/s; FMA route {fma_ms:.4f} ms ('lse' mode {fma_lse_ms:.4f} "
        f"ms), {flops / fma_ms / 1e9:.4g} TFLOP/s; plain {plain_ms:.4f} ms; "
        f"scaled_dot_product_attention {library_ms:.4f} ms; bound {bound_ms:.4f} ms by "
        f"{bound_by} ({flops:.4g} operations, {nbytes / 1e9:.4g} GB)")
    row = {"plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    return {"K2": {"max_abs_err": err, "ms": ms, **row},
            "K2 fma": {"max_abs_err": fma_err, "ms": fma_ms, **row}}


#: Kernel groups of a profiled step: (label, substrings of the kernel name).
#: K2's group matches both routes' kernels (flash_fwd_tc_kernel, flash_fwd_kernel).
FORWARD_GROUPS = (("flash_fwd_*kernel (K2)", ("flash_fwd_",)),
                  ("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")))
TRAIN_GROUPS = (("flash_fwd_*kernel (K2)", ("flash_fwd_",)),
                ("flash_bwd_dq_*kernel (K3)", ("flash_bwd_dq_",)),
                ("flash_bwd_dkv_*kernel (K4)", ("flash_bwd_dkv_",)),
                ("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
                ("AdamW (multi-tensor kernels)", ("multi_tensor_apply", "adam")))


def profile_step(step, what: str, groups=FORWARD_GROUPS, top: int = 6) -> dict:
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
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    log(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %), {len(by_kernel)} kernels; by group: "
        + "; ".join(f"{g} {ms:.1f} ms ({100 * ms / busy_ms:.1f} %)" for g, ms in split.items()))
    log(f"[profile] {what}, top kernels: " + "; ".join(
        f"{name[:90]} {ms:.1f} ms ({100 * ms / busy_ms:.1f} %)" for name, ms in top_kernels))
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
    if kernels.launch_counts != {flash_attn.KERNEL_NAME: LLAMA.n_layers * (1 + TOKEN_STEPS)}:
        raise AssertionError(f"launches {kernels.launch_counts} for {1 + TOKEN_STEPS} forwards "
                             f"of {LLAMA.n_layers} layers: expected the tensor-core K2 alone")
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
    fma_names = (flash_attn.FMA_KERNEL_NAME,) + BWD_ROUTES[flash_attn.FMA]   # never launched here
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
                      **{n: 0 for n in fma_names}}:
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


#: Kernel groups of a profiled ResNet-50 step, matched in this order. The
#: convolutions' kernels carry GEMM names too (cuDNN runs them as implicit
#: GEMMs); the head's matmul, 0.3 GFLOP of the step's 6.3 TFLOP, falls in
#: the same group.
IMAGE_GROUPS = (("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
                ("SGD (multi-tensor kernels)", ("multi_tensor_apply", "sgd")),
                ("convolutions (cuDNN) and the head's matmul, forward and backward",
                 ("conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn", "winograd", "nhwc",
                  "nchw", "gemm", "nvjet", "xmma", "cutlass")))


def phase_imagenet(tmp: str) -> dict:
    url = f"file://{tmp}/imagenet"
    t0 = time.perf_counter()
    write_synthetic_imagenet(url, rows=IMAGENET_ROWS, classes=IMAGENET_CLASSES,
                             rows_per_row_group=ROWS_PER_GROUP)
    log(f"[imagenet] wrote {IMAGENET_ROWS} rows of 224x224x3 JPEG q85 in "
        f"{time.perf_counter() - t0:.2f} s")
    failures = []

    # The main path, counted: one warm-up, the pipelined steps, the resident ones.
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    result = run_imagenet_bench(url, steps=IMAGENET_STEPS, per_device_batch=IMAGENET_BATCH,
                                workers_count=IMAGENET_WORKERS, classes=IMAGENET_CLASSES,
                                resident_steps=IMAGENET_RESIDENT, device="cuda")
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for key, value in sorted(result.items()):
        log(f"[imagenet] {key}: {value}")
    log(f"[imagenet] launches {launches} (the bench preprocesses with / 255: none expected); "
        f"peak memory {peak_gb:.2f} GB")
    if set(result) != IMAGENET_KEYS:
        failures.append(f"result keys {sorted(set(result) ^ IMAGENET_KEYS)} differ from the "
                        f"JAX bench's")
    if launches:
        failures.append(f"launches {launches}")
    if not (np.isfinite(result["loss_first"]) and np.isfinite(result["loss_last"])):
        failures.append(f"non-finite loss {result['loss_first']}, {result['loss_last']}")

    with make_reader(url, reader_pool_type="thread", workers_count=IMAGENET_WORKERS, seed=0,
                     num_epochs=None) as r:
        it = iter(DataLoader(r, batch_size=IMAGENET_BATCH, device="cuda"))
        staged = next(it)
        batch = {"image": staged["image"].float() / 255.0, "label": staged["label"].clone()}
        it.close()
        del staged

    # One step from fresh parameters, with and without remat; the first is
    # profiled once warm.
    losses = {}
    for remat in (False, True):
        free_cuda()
        params = resnet.init_params(torch.Generator(device="cuda").manual_seed(0),
                                    IMAGENET_CLASSES, device="cuda")
        init_opt, step = resnet.make_train_step(learning_rate=0.05, remat=remat)
        opt = init_opt(params)
        torch.cuda.reset_peak_memory_stats()
        params, opt, loss, _ = step(params, opt, batch)
        losses[remat] = loss.item()
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"[imagenet] one step{' with remat' if remat else ''}: loss {losses[remat]:.6f}, "
            f"peak memory {peak:.2f} GB")
        if not remat:
            def resident():
                nonlocal params, opt
                params, opt, loss, _ = step(params, opt, batch)
                loss.item()
            profile_step(resident, "resident ResNet-50 train step", IMAGE_GROUPS, top=12)
        del params, opt, init_opt, step
    if abs(losses[True] - losses[False]) > 1e-3 * abs(losses[False]):
        failures.append(f"remat changed the loss {losses}")

    # The flagship forward: bf16 against float32 with TF32 off.
    free_cuda()
    forward, (params, images) = entry(device="cuda")
    with torch.inference_mode():
        got = forward(params, images)
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            want = resnet.apply(params, images, compute_dtype=torch.float32)[0]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        rel = ((got - want).abs().mean() / want.abs().mean()).item()
        (fwd_ms,) = median_ms(lambda: forward(params, images), reps=10)
        profile_step(lambda: forward(params, images).sum().item(), "entry() forward, batch 8",
                     IMAGE_GROUPS)
    ok = bool(torch.isfinite(got).all()) and got.shape == (8, 1000) and rel <= ENTRY_F32_BAR
    log(f"[imagenet] entry() forward, 8 x 224x224, bf16 against float32 (TF32 off): mean abs "
        f"difference {rel:.4%} of the mean |logit| {want.abs().mean().item():.4g} (bar "
        f"{ENTRY_F32_BAR:.0%}): {'within the bar' if ok else 'OUTSIDE'}; forward {fwd_ms:.3f} ms")
    if not ok:
        failures.append(f"entry() forward {rel:.4%} from float32")
    del params, images, got, want
    free_cuda()
    if failures:
        raise AssertionError("image path: " + "; ".join(failures))
    return result


def control_stats(q, k, v, causal, flaw):
    """K2 "stats" (kernel layout: m, l (b, h, sq)) computed as its plain
    version computes them, with one ``flaw`` of STATS_CONTROLS."""
    o, m, l = flash_attn._stats_plain(q, k, v, causal)
    if flaw == STATS_CONTROLS[0]:
        return o, m / float(np.log(2.0)), l
    if flaw == STATS_CONTROLS[1]:
        return o, m, l * 1.01
    if flaw == STATS_CONTROLS[4]:
        return o / l.transpose(1, 2)[..., None], m, l
    # Keys dropped: the plain block math over the keys the flaw keeps.
    from petastorm_tpu_torch.parallel.ring_attention import _block_attention_chunked
    sq, sk = q.shape[1], k.shape[1]
    q_pos, k_pos = torch.arange(sq, device="cuda"), torch.arange(sk, device="cuda")
    if flaw == STATS_CONTROLS[2]:   # the key loop ends one 64-key tile early
        keep = k_pos < (sk - 1) // 64 * 64
    else:
        keep = k_pos % 32 != 31
    return _block_attention_chunked(q, k[:, keep], v[:, keep], k_pos[keep], q_pos, causal, 1024)


def stats_verdict(got, want, dtype):
    """-> (o worst, o rms, m max abs err, l max rel err, within every bar)."""
    worst, rms = row_scaled_errors(got[0], want[0], dtype=dtype)
    m_err = (got[1] - want[1]).abs().max().item()
    l_err = ((got[2] - want[2]).abs() / want[2]).max().item()
    _, worst_bar, rms_bar = ROW_BARS[dtype]
    ok = worst <= worst_bar and rms <= rms_bar and m_err <= STATS_M_BAR and l_err <= STATS_L_REL_BAR
    return worst, rms, m_err, l_err, ok


def phase_stats() -> dict:
    """K2 "stats" against its plain version at the ring's block."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, kv_h, d = SEQ_LLAMA.n_heads, SEQ_LLAMA.n_kv_heads, SEQ_LLAMA.head_dim

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v = randn(1, SEQ_BLOCK, h, d), randn(1, SEQ_BLOCK, kv_h, d), randn(1, SEQ_BLOCK, kv_h, d)
    failures, errs = [], {}
    bars = (f"bars: o row-scaled worst {ROW_BARS[torch.bfloat16][1]:.3g} rms "
            f"{ROW_BARS[torch.bfloat16][2]:.3g}, m {STATS_M_BAR}, l relative {STATS_L_REL_BAR}")
    for causal in (True, False):
        want = flash_attn._stats_plain(q, k, v, causal)
        for route in (flash_attn.TENSOR_CORES, flash_attn.FMA):
            kernels.reset_launch_counts()
            if route == flash_attn.TENSOR_CORES:   # the public entry point takes this route
                o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=causal)
                got = (o, m.transpose(1, 2), l.transpose(1, 2))
            else:
                got = flash_attn._flash_stats_fwd(route, q, k, v, causal)
            counts = dict(kernels.launch_counts)
            torch.cuda.synchronize()
            worst, rms, m_err, l_err, ok = stats_verdict(got, want, torch.bfloat16)
            err = max((got[0] - want[0]).abs().max().item(), m_err)
            errs[route, causal] = err
            log(f"[stats] (1, {SEQ_BLOCK}, {h}/{kv_h}, {d}) bf16 "
                f"{'causal' if causal else 'non-causal'} [{route}; launches {counts}]: o row-scaled worst {worst:.3g} rms {rms:.3g}, "
                f"max abs {(got[0] - want[0]).abs().max().item():.3g}; m {m_err:.3g}; l relative "
                f"{l_err:.3g} ({bars})")
            if not ok or counts != {flash_attn._STATS_KERNELS[route]: 1} \
                    or got[0].dtype != torch.float32 or got[0].shape != q.shape:
                failures.append(f"{route} causal={causal}")
            del got
        if causal:
            for flaw in STATS_CONTROLS:
                worst, rms, m_err, l_err, ok = stats_verdict(control_stats(q, k, v, True, flaw),
                                                             want, torch.bfloat16)
                log(f"[stats] control {flaw!r}: o worst {worst:.3g} rms {rms:.3g}; m {m_err:.3g}; "
                    f"l relative {l_err:.3g}: {'within the bars' if ok else 'rejected'}")
                if ok:
                    failures.append(f"control {flaw!r} within the bars")
        del want
    # Ragged, GQA rep 8 and other types, on whichever route they take.
    for b, sq, sk, hh, kk, dd, causal, dtype, what in (
            (1, SEQ_BLOCK - 37, SEQ_BLOCK - 37, h, kv_h, d, True, torch.bfloat16, "ragged causal"),
            (2, 777, 1500, 32, 4, 128, False, torch.bfloat16, "GQA rep 8, sq 777 < sk 1500"),
            (1, 300, 300, 8, 2, 64, True, torch.float16, "f16 d64 causal"),
            (2, 150, 150, 8, 2, 64, True, torch.float32, "f32 causal")):
        cq, ck, cv = randn(b, sq, hh, dd, dtype=dtype), randn(b, sk, kk, dd, dtype=dtype), \
            randn(b, sk, kk, dd, dtype=dtype)
        route = flash_attn.fwd_route(dtype, dd)
        kernels.reset_launch_counts()
        o, m, l = flash_attn.flash_attention_stats(cq, ck, cv, causal=causal)
        counts = dict(kernels.launch_counts)
        worst, rms, m_err, l_err, ok = stats_verdict(
            (o, m.transpose(1, 2), l.transpose(1, 2)), flash_attn._stats_plain(cq, ck, cv, causal),
            dtype)
        log(f"[stats] {what} [{route}; launches {counts}]: o worst {worst:.3g} rms {rms:.3g}; "
            f"m {m_err:.3g}; l relative {l_err:.3g}")
        if not ok or counts != {flash_attn._STATS_KERNELS[route]: 1}:
            failures.append(what)

    failures += ring_backward_check(q, k, v, randn)

    # Times at the ring's block, in turns: both routes, the plain version and
    # SDPA (whose (O, lse, 1) is an equivalent triple for the ring's merge).
    def sdpa_block(causal):
        return lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                      v.transpose(1, 2), is_causal=causal,
                                                      enable_gqa=True)
    rows = {}
    for causal in (False, True):
        ms, fma_ms, plain_ms, library_ms = median_ms(
            lambda: flash_attn._flash_stats_fwd(flash_attn.TENSOR_CORES, q, k, v, causal),
            lambda: flash_attn._flash_stats_fwd(flash_attn.FMA, q, k, v, causal),
            lambda: flash_attn._stats_plain(q, k, v, causal), sdpa_block(causal),
            reps=FLASH_REPS, warmup=1)
        flops, nbytes = flash_flops_bytes(1, SEQ_BLOCK, SEQ_BLOCK, h, kv_h, d, causal, 2, False)
        nbytes += 2 * SEQ_BLOCK * h * d + 2 * 4 * SEQ_BLOCK * h   # o in float32; m and l
        bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        log(f"[stats] ring block {'causal (diagonal)' if causal else 'non-causal (past block)'}: "
            f"tensor cores {ms:.4f} ms ({flops / ms / 1e9:.4g} TFLOP/s), FMA route {fma_ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} operations, "
            f"{nbytes / 1e6:.4g} MB)")
        row = {"plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        if not causal:   # the kernels line: a strictly-past block, the ring's common step
            rows = {"stats": {"max_abs_err": errs[flash_attn.TENSOR_CORES, False], "ms": ms, **row},
                    "stats fma": {"max_abs_err": errs[flash_attn.FMA, False], "ms": fma_ms, **row}}
    if failures:
        raise AssertionError("K2 stats: " + "; ".join(failures))
    return rows


def ring_backward_check(q, k, v, randn) -> list:
    """K3 and K4 as the ring's backward launches them on rank 1 of 2: q
    against the diagonal block (k, v; causal) and a strictly-past block
    (non-causal), each given the output and the global lse of the two
    blocks merged, so a block's p rows do not sum to 1 and D comes from the
    merged output. Each block's (dq, dk, dv) is held against the plain
    backward on the same inputs with the row-scaled bars, and BWD_CONTROLS
    must fail them. -> failures."""
    from petastorm_tpu_torch.parallel.ring_attention import _merge
    k_past, v_past, do = randn(*k.shape), randn(*v.shape), randn(*q.shape)
    o, m, l = _merge(flash_attn._stats_plain(q, k_past, v_past, False),
                     flash_attn._stats_plain(q, k, v, True))
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    lse = (m + torch.log(l))[..., None]
    del o, m, l
    failures = []
    for kb, vb, causal, what in ((k, v, True, "diagonal block, causal"),
                                 (k_past, v_past, False, "past block, non-causal")):
        kernels.reset_launch_counts()
        got = flash_attention_bwd(q, kb, vb, out, lse, do, causal)
        counts = bwd_launches()
        want = flash_attention_bwd_plain(q, kb, vb, out, lse, do, causal)
        _, ok = judge_grads(got, want, False,
                            f"ring backward on rank 1 of 2, {what}, global lse "
                            f"({tuple(q.shape)}, kv {kb.shape[2]}) bf16; launches {counts}")
        if not ok or counts != {flash_attn.TENSOR_CORES: (1, 1), flash_attn.FMA: (0, 0)}:
            failures.append(f"ring backward, {what}")
        del got
        for flaw in BWD_CONTROLS:
            _, c_ok = judge_grads(control_backward(q, kb, vb, out, lse, do, causal, flaw), want,
                                  False, f"ring backward, {what}: control {flaw!r}")
            log(f"[bwd] ring backward, {what}: control {flaw!r}: "
                f"{'within the bars' if c_ok else 'rejected'}")
            if c_ok:
                failures.append(f"ring backward, {what}: control {flaw!r} within the bars")
        del want
    return failures


def phase_seq_parallel(tmp: str) -> dict:
    """The sequence-parallel training path (see the module docstring, phase
    10). Returns the kernels' launch counts summed over the ranks and both
    strategies."""
    from petastorm_tpu_torch.benchmark.seq_parallel_bench import (leaf, run_seq_parallel_train,
                                                                  token_windows)
    url = f"file://{tmp}/seq_tokens"
    write_token_store(url, windows=4, window=WINDOW, vocab=SEQ_LLAMA.vocab, seed=0)
    model_kwargs = {f.name: getattr(SEQ_LLAMA, f.name) for f in dataclasses.fields(SEQ_LLAMA)}
    failures = []

    # One process on the whole window: the first step's loss and gradients.
    free_cuda()
    with DataLoader(token_windows(url, WINDOW), batch_size=1, device="cuda") as loader:
        it = iter(loader)
        batch = {"tokens": next(it)["token"]}
        it.close()
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), SEQ_LLAMA,
                               device="cuda")
    for t in llama.param_leaves(params):
        t.requires_grad_(True)
    loss = llama.loss_fn(params, batch, SEQ_LLAMA, attn_fn=make_flash_attention(causal=True),
                         shift="roll")
    loss.backward()
    ref_loss = loss.item()
    ref_grads = {n: leaf(params, n).grad.cpu() for n in SEQ_WATCH}
    del params, loss, batch
    free_cuda()
    log(f"[seq] one process, window {WINDOW}: first loss {ref_loss:.6f}")

    t0 = time.perf_counter()
    results = run_seq_parallel_train(url, world_size=SEQ_RANKS, steps=SEQ_STEPS, window=WINDOW,
                                     model_kwargs=model_kwargs, watch=SEQ_WATCH, device="cuda")
    log(f"[seq] {SEQ_RANKS} ranks, both strategies: {time.perf_counter() - t0:.1f} s with the "
        f"spawn")
    names = (flash_attn.STATS_KERNEL_NAME, flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME,
             flash_attn.BWD_DKV_KERNEL_NAME, flash_attn.STATS_FMA_KERNEL_NAME,
             flash_attn.FMA_KERNEL_NAME) + BWD_ROUTES[flash_attn.FMA]
    n, steps = SEQ_LLAMA.n_layers, SEQ_STEPS
    # Per rank r of P, per layer and step: the ring runs r + 1 blocks (K2
    # "stats", then K3 and K4 each); Ulysses one K2 "lse", K3 and K4.
    blocks = sum(r + 1 for r in range(SEQ_RANKS))
    want = {"ring": {names[0]: blocks * n * steps, names[2]: blocks * n * steps,
                     names[3]: blocks * n * steps},
            "ulysses": {names[1]: SEQ_RANKS * n * steps, names[2]: SEQ_RANKS * n * steps,
                        names[3]: SEQ_RANKS * n * steps}}
    totals = {name: 0 for name in names}
    first = {}
    for strategy, ranks in results.items():
        counts = {name: sum(r["launches"].get(name, 0) for r in ranks) for name in names}
        for name in names:
            totals[name] += counts[name]
        r0 = ranks[0]
        ms = statistics.median(r0["step_ms"])
        transfers = {op: f"{v['calls']} calls, {v['bytes'] / 1e9:.3f} GB, {v['seconds']:.3f} s"
                     for op, v in r0["transfers"].items()}
        log(f"[seq] {strategy}: losses {r0['losses']}; step ms "
            f"{[round(x, 1) for x in r0['step_ms']]} (median {ms:.1f}, {r0['tokens_per_sec']:.1f} tokens/s); peak memory by rank "
            f"{[round(r['peak_memory_gb'], 2) for r in ranks]} GB; rank 0's transfers over "
            f"{steps} steps: {transfers}; launches over the ranks {counts}")
        if any(r["losses"] != r0["losses"] for r in ranks):
            failures.append(f"{strategy}: the ranks' losses differ")
        if {k: v for k, v in counts.items() if v} != want[strategy]:
            failures.append(f"{strategy}: launches {counts}, expected {want[strategy]}")
        if not np.isfinite(r0["losses"]).all():
            failures.append(f"{strategy}: non-finite loss {r0['losses']}")
        loss_rel = abs(r0["losses"][0] - ref_loss) / abs(ref_loss)
        rel = {name: ((g - ref_grads[name]).norm() / ref_grads[name].norm()).item()
               for name, g in r0["grads"].items()}
        log(f"[seq] {strategy} against one process: first loss {loss_rel:.3g} relative (bar "
            f"{SEQ_LOSS_REL_BAR}); gradients |g - g_one| / |g_one| "
            f"{ {k: round(x, 5) for k, x in rel.items()} } (bar {GRAD_REL_BAR})")
        if loss_rel > SEQ_LOSS_REL_BAR or set(rel) != set(SEQ_WATCH) \
                or max(rel.values()) > GRAD_REL_BAR:
            failures.append(f"{strategy}: loss {loss_rel:.3g}, gradients {rel}")
        first[strategy] = r0
    ring, uly = first["ring"], first["ulysses"]
    loss_rel = abs(ring["losses"][0] - uly["losses"][0]) / abs(uly["losses"][0])
    rel = max(((ring["grads"][n_] - uly["grads"][n_]).norm() / uly["grads"][n_].norm()).item()
              for n_ in SEQ_WATCH)
    log(f"[seq] ring against Ulysses: first loss {loss_rel:.3g} relative, gradients {rel:.5f}")
    if loss_rel > SEQ_LOSS_REL_BAR or rel > GRAD_REL_BAR:
        failures.append(f"ring against Ulysses: loss {loss_rel:.3g}, gradients {rel:.5f}")
    if failures:
        raise AssertionError("sequence-parallel path: " + "; ".join(failures))
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = phase_probe()
    phase_build()
    k1, k1_strided = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(tmp)
    k2_rows = phase_flash()
    with tempfile.TemporaryDirectory() as tmp:
        k2_launches = phase_tokens(tmp)
    bwd = phase_flash_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_train(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_imagenet(tmp)
    stats = phase_stats()
    with tempfile.TemporaryDirectory() as tmp:
        seq = phase_seq_parallel(tmp)
    source = "petastorm_tpu_torch/csrc/flash_attn_bwd.cu"
    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/normalize.cu",
        "replaces": "petastorm_tpu/ops/image_ops.py:27",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        # K1's general route (any strides, any channel count): timed on the
        # main path's batch cropped to 208x208; no main path launches it.
        "name": STRIDED_KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/normalize.cu",
        "replaces": "petastorm_tpu/ops/image_ops.py:27", "launches": 0, **k1_strided,
        "bound_by": "bytes", "library_ms": None}, {
        "name": flash_attn.KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        # The token forward's launches ("out"), the training path's and
        # Ulysses' ("lse").
        "launches": k2_launches + counts[flash_attn.KERNEL_NAME] + seq[flash_attn.KERNEL_NAME],
        **k2_rows["K2"]}, {
        # The FMA route (f32, 16-bit d > 128 or d % 8 != 0): timed forced at
        # the token path's bf16 shape; the main paths never launch it.
        "name": flash_attn.FMA_KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        "launches": counts[flash_attn.FMA_KERNEL_NAME] + seq[flash_attn.FMA_KERNEL_NAME],
        **k2_rows["K2 fma"]}, {
        # K2 "stats": the ring's local step; timed at a strictly-past block.
        "name": flash_attn.STATS_KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        "launches": seq[flash_attn.STATS_KERNEL_NAME], **stats["stats"]}, {
        "name": flash_attn.STATS_FMA_KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        "launches": seq[flash_attn.STATS_FMA_KERNEL_NAME], **stats["stats fma"]}, {
        "name": flash_attn.BWD_DQ_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:272",
        "launches": counts[flash_attn.BWD_DQ_KERNEL_NAME] + seq[flash_attn.BWD_DQ_KERNEL_NAME],
        **bwd["K3"]}, {
        "name": flash_attn.BWD_DKV_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:305",
        "launches": counts[flash_attn.BWD_DKV_KERNEL_NAME] + seq[flash_attn.BWD_DKV_KERNEL_NAME],
        **bwd["K4"]}, {
        # The FMA route (f32, 16-bit d > 128 or d % 8 != 0): timed forced at
        # the token path's bf16 shape; the main path never launches it.
        "name": flash_attn.BWD_DQ_FMA_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:272",
        "launches": (counts[flash_attn.BWD_DQ_FMA_KERNEL_NAME]
                     + seq[flash_attn.BWD_DQ_FMA_KERNEL_NAME]),
        **bwd["K3 fma"]}, {
        "name": flash_attn.BWD_DKV_FMA_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:305",
        "launches": (counts[flash_attn.BWD_DKV_FMA_KERNEL_NAME]
                     + seq[flash_attn.BWD_DKV_FMA_KERNEL_NAME]),
        **bwd["K4 fma"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
