"""ImageNet-style benchmark: a JPEG-decode-bound reader feeding a real
ResNet-50 SGD train step on the card, and the measurement harness the
training benchmarks share (the pipelined timing window, the readback sync,
the analytic FLOP counts and the utilization block), with the JAX
package's result keys.

The store is synthetic but class-separable (the loss goes down), with real
JPEG encode and decode through :class:`~petastorm_tpu_torch.codecs.CompressedImageCodec`,
so the host does the work of a real ImageNet ingest: Parquet row-group read
-> JPEG decode -> batch assembly -> pinned staging onto the card.
:func:`write_synthetic_imagenet` writes the rows the JAX package's writer
writes from the same seed. :func:`..llm_bench.run_llm_bench` shares the
harness.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

#: Environment override of the device's peak FLOP/s (any device but the CPU).
PEAK_FLOPS_ENV = "PETASTORM_TPU_TORCH_PEAK_FLOPS"

# Published dense bf16 tensor-core peaks (NVIDIA data sheets, SXM parts at
# their full power limit). Used only when PEAK_FLOPS_ENV is unset; unknown
# devices report FLOP/s without MFU.
_KNOWN_PEAK_BF16_FLOPS = (
    ("h100", 989e12),
    ("h200", 989e12),
)


def make_imagenet_schema(image_size: int = 224) -> Unischema:
    return Unischema("ImagenetSchema", [
        UnischemaField("image", np.uint8, (image_size, image_size, 3),
                       CompressedImageCodec("jpeg", 85), False),
        UnischemaField("label", np.int32, (), ScalarCodec(np.int32), False),
    ])


ImagenetSchema = make_imagenet_schema()


def write_synthetic_imagenet(url: str, rows: int, classes: int = 100, seed: int = 0,
                             rows_per_row_group: int = 64, image_size: int = 224):
    """Class-separable synthetic images: a per-class 8x8 proto upsampled to
    ``image_size`` plus uniform noise, which compresses like a photo and
    trains like a toy. ``image_size`` must be a multiple of 8; smaller sizes
    make the ResNet step feasible on a CPU (ResNet is fully convolutional)."""
    if image_size % 8:
        raise ValueError("image_size must be a multiple of 8")
    rng = np.random.default_rng(seed)
    protos = rng.integers(60, 195, (classes, 8, 8, 3)).astype(np.uint8)
    up = image_size // 8
    with materialize_dataset_local(url, make_imagenet_schema(image_size),
                                   rows_per_row_group=rows_per_row_group) as w:
        for _ in range(rows):
            label = int(rng.integers(0, classes))
            base = np.kron(protos[label], np.ones((up, up, 1), np.uint8))
            noise = rng.integers(0, 60, (image_size, image_size, 3)).astype(np.uint8)
            w.write_row({"image": np.clip(base + noise, 0, 255).astype(np.uint8),
                         "label": np.int32(label)})


def hard_sync(x: torch.Tensor) -> float:
    """Wait for ``x`` (and everything it depends on) by reading one
    element back to the host; returns it as a float. A value cannot reach
    the host before the work that made it is done."""
    return float(x.reshape(-1)[0].item())


def _peak_flops(device_kind: str):
    """(peak_flops, source) for this device: the :data:`PEAK_FLOPS_ENV`
    environment variable first, then a lookup of the bf16 dense peak by
    device name, else ``(None, None)``. The CPU never gets a peak, so a CPU
    run cannot record a meaningless MFU under an accelerator's peak."""
    kind = (device_kind or "").lower().replace(" ", "")
    if kind in ("", "cpu"):
        return None, None
    env = os.environ.get(PEAK_FLOPS_ENV)
    if env:
        try:
            peak = float(env)
        except ValueError:
            peak = 0.0
        return (peak, "env") if peak > 0 else (None, None)
    for marker, peak in _KNOWN_PEAK_BF16_FLOPS:
        if marker in kind:
            return peak, f"device_kind:{device_kind}"
    return None, None


def llama_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one Llama train step on ``batch`` sequences of
    ``seq`` tokens, counted from the config (there is no compiler cost
    model to ask). Only model FLOPs: recompute (checkpointing, the flash
    backward's score recompute) is not counted.

    With ``T = batch * seq`` tokens, ``hd = dim / n_heads`` and ``M`` the
    multiply-adds per token of the weight matmuls,

    * per dense layer ``dim*(n_heads + 2*n_kv_heads)*hd`` (q, k, v)
      ``+ n_heads*hd*dim`` (wo) ``+ 3*dim*hidden`` (SwiGLU);
    * per soft-MoE layer the same attention terms ``+ dim*E`` (router)
      ``+ 3*E*dim*hidden`` (every expert on every token) ``+ E*dim``
      (the combine);
    * ``+ dim*vocab`` (lm_head; the embedding gather does no FLOPs);

    the matmuls cost ``2*T*M`` forward and twice that backward, ``6*T*M``
    in all. Causal attention does two products (``q.k`` and ``p.v``) of
    ``2*hd`` FLOPs per head per visible (query, key) pair, of which there
    are ``batch * seq*(seq+1)/2``, and its backward four (``dp``, ``dq``,
    ``dk``, ``dv``): ``3 * 4*n_heads*hd * batch*seq*(seq+1)/2`` in all.

    ``6*T*M + 6*n_heads*hd*batch*seq*(seq+1)``
    """
    hd = cfg.dim // cfg.n_heads
    attn_proj = cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * cfg.dim
    macs = cfg.dim * cfg.vocab
    for li in range(cfg.n_layers):
        moe = cfg.n_experts > 0 and li % cfg.moe_every == cfg.moe_every - 1
        if moe:
            e = cfg.n_experts
            macs += attn_proj + cfg.dim * e + 3 * e * cfg.dim * cfg.hidden + e * cfg.dim
        else:
            macs += attn_proj + 3 * cfg.dim * cfg.hidden
    tokens = batch * seq
    attention = 6 * cfg.n_heads * hd * batch * seq * (seq + 1) * cfg.n_layers
    return float(6 * tokens * macs + attention)


def pipelined_window(run_step, next_batch, steps: int, resident_steps: int, warm_loss):
    """Shared measurement harness for the training benchmarks.

    The measured window is wall-clock over ``steps`` step dispatches,
    closed by ONE :func:`hard_sync` readback: PyTorch returns before the
    card finishes, and syncing every step would serialise the input
    pipeline against the compute, a regime no real training loop runs in.
    Stall is attributed per step: ``next_batch()`` waits are host-side and
    need no device sync. Caveat: device work queued by earlier steps can
    run during a loader wait, so ``wall - wait`` is an UPPER bound of the
    stall and a LOWER bound of the step time; the resident phase
    (re-running the step on the last staged batch, no input pipeline in
    the loop) is the overlap-free step-time measurement.

    ``run_step(batch) -> loss`` threads the caller's train state via
    closure; ``next_batch()`` returns a staged batch. Returns
    ``(loss_first, loss_last, wait_s, total_wall_s, resident_s)``
    (``resident_s`` is None when ``resident_steps`` is 0)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    loss_first = hard_sync(warm_loss)  # the warm-up's loss; syncs before the window
    wait_s = 0.0
    batch = None
    t_start = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        batch = next_batch()
        wait_s += time.perf_counter() - t0
        loss = run_step(batch)
    loss_last = hard_sync(loss)  # closes the window
    total_wall = time.perf_counter() - t_start

    resident_s = None
    if resident_steps:
        t0 = time.perf_counter()
        for _ in range(resident_steps):
            loss = run_step(batch)
        hard_sync(loss)
        resident_s = (time.perf_counter() - t0) / resident_steps
    return loss_first, loss_last, wait_s, total_wall, resident_s


def utilization_metrics(result: dict, flops_per_step, step_time_s: float, resident_s,
                        device_kind: str) -> None:
    """Fill the shared FLOPs/MFU block (pipelined and resident variants,
    with a physical-plausibility guard) into ``result`` in place. One
    device runs the step, so the per-chip FLOPs are the step's."""
    if flops_per_step is None:
        return
    result["model_flops_per_step_per_chip"] = flops_per_step
    achieved = flops_per_step / step_time_s
    result["achieved_tflops_per_chip"] = achieved / 1e12
    peak, peak_source = _peak_flops(device_kind)
    if peak:
        result["mfu_pct"] = 100.0 * achieved / peak
        result["peak_flops_source"] = peak_source
        if achieved > peak:
            # wall - wait underestimates the step time when device work
            # overlaps a loader wait (see pipelined_window): a rate above
            # the peak means that regime was hit, not a measurement.
            del result["mfu_pct"]
            del result["achieved_tflops_per_chip"]
            result["mfu_pipelined_dropped"] = (
                "achieved exceeded chip peak: loader-bound window, "
                "wait/compute overlap; "
                + ("use the resident metrics" if resident_s is not None
                   else "re-run with resident_steps>0 for valid MFU"))
    if resident_s is not None:
        r_achieved = flops_per_step / resident_s
        result["achieved_tflops_per_chip_resident"] = r_achieved / 1e12
        if peak:
            result["mfu_pct_resident"] = 100.0 * r_achieved / peak
            if r_achieved > peak:
                # A resident rate above the peak means the sync returned
                # early, not that the card did the work.
                del result["mfu_pct_resident"]
                del result["achieved_tflops_per_chip_resident"]
                result["mfu_resident_dropped"] = (
                    "resident achieved exceeded chip peak: timing/sync "
                    "artifact; no valid MFU for this run")
                if "mfu_pipelined_dropped" in result:
                    result["mfu_pipelined_dropped"] = (
                        "achieved exceeded chip peak: loader-bound window, "
                        "wait/compute overlap; resident metrics were also "
                        "dropped — no valid MFU for this run")


def run_imagenet_bench(url: str, steps: int = 30, per_device_batch: int = 32,
                       workers_count: int = 4, pool_type: str = "thread",
                       classes: int = 100, prefetch: int = 2, remat: bool = False,
                       resident_steps: int = 0, echo: int = 1, device="cuda") -> dict:
    """One training run of ResNet-50 on ``device`` fed by the reader stack;
    returns ``{samples_per_sec, samples_per_sec_per_chip, input_stall_pct,
    step_time_ms, model_flops_per_step_per_chip, achieved_tflops_per_chip
    [, mfu_pct], ...}``, the JAX bench's keys.

    ``make_reader(num_epochs=None, shuffle_row_groups=True, seed=0)`` ->
    ``DataLoader(prefetch, dtype_policy=DTypePolicy(), echo)`` -> the step
    of :func:`~petastorm_tpu_torch.models.resnet.make_train_step` at lr
    0.05, with parameters drawn from a ``torch.Generator`` seeded 0. The
    step preprocesses as the reference does, ``image.float() / 255`` (the
    labels become int64 for the loss). One warm-up step runs before the
    timed window; timing is :func:`pipelined_window`'s. FLOPs are
    :func:`~petastorm_tpu_torch.models.resnet.resnet50_flops_per_step`'s
    analytic count (the reference asks XLA's cost model, which PyTorch does
    not have); ``mfu_pct`` is against the device's bf16 peak."""
    from petastorm_tpu_torch.loader import DataLoader, DTypePolicy
    from petastorm_tpu_torch.loader.loader import resolve_device
    from petastorm_tpu_torch.models import resnet
    from petastorm_tpu_torch.reader import make_reader

    if pool_type == "process":
        raise NotImplementedError("the process pool is not ported yet: use pool_type='thread'")
    dev = resolve_device(device)
    batch_size = per_device_batch
    params = resnet.init_params(torch.Generator(device=dev).manual_seed(0), classes, device=dev)
    init_opt, raw_step = resnet.make_train_step(learning_rate=0.05, remat=remat)
    opt = init_opt(params)

    def step(batch):
        nonlocal params, opt
        images = batch["image"].float() / 255.0
        params, opt, loss, _ = raw_step(params, opt, {"image": images, "label": batch["label"]})
        return loss

    reader = make_reader(url, num_epochs=None, shuffle_row_groups=True, seed=0,
                         reader_pool_type=pool_type, workers_count=workers_count)
    try:
        loader = DataLoader(reader, batch_size=batch_size, prefetch=prefetch,
                            dtype_policy=DTypePolicy(), echo=echo, device=dev)
    except BaseException:
        # The loader owns reader shutdown only once constructed.
        reader.stop()
        reader.join()
        raise
    with loader:  # stops and joins the reader on exit
        it = iter(loader)
        try:
            batch = next(it)
            flops_per_step = resnet.resnet50_flops_per_step(batch_size, batch["image"].shape[1],
                                                            classes)
            loss = step(batch)
            loss_first, loss_last, wait_s, total_wall, resident_s = pipelined_window(
                step, lambda: next(it), steps, resident_steps, warm_loss=loss)
        finally:
            it.close()

    sps = steps * batch_size / total_wall
    step_time_s = (total_wall - wait_s) / steps
    device_kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {
        "samples_per_sec": sps,
        "samples_per_sec_per_chip": sps,
        "input_stall_pct": 100.0 * wait_s / total_wall,
        "devices": 1,
        "global_batch": batch_size,
        "echo": echo,
        "loss_first": loss_first,
        "loss_last": loss_last,
        "step_time_ms": 1000.0 * step_time_s,
        "device_kind": device_kind,
    }
    if resident_s is not None:
        result["step_time_ms_resident"] = 1000.0 * resident_s
        result["samples_per_sec_resident"] = batch_size / resident_s
        result["samples_per_sec_per_chip_resident"] = batch_size / resident_s
    utilization_metrics(result, flops_per_step, step_time_s, resident_s, device_kind)
    return result
