"""Shared measurement harness of the training benchmarks: the pipelined
timing window, the readback sync, the analytic FLOP count and the
utilization block, with the JAX package's result keys.

:func:`..llm_bench.run_llm_bench` uses it now; the image bench itself
(``run_imagenet_bench``, ResNet-50) comes with its slice.
"""
from __future__ import annotations

import os
import time

import torch

#: Environment override of the device's peak FLOP/s (any device but the CPU).
PEAK_FLOPS_ENV = "PETASTORM_TPU_TORCH_PEAK_FLOPS"

# Published dense bf16 tensor-core peaks (NVIDIA data sheets, SXM parts at
# their full power limit). Used only when PEAK_FLOPS_ENV is unset; unknown
# devices report FLOP/s without MFU.
_KNOWN_PEAK_BF16_FLOPS = (
    ("h100", 989e12),
    ("h200", 989e12),
)


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
