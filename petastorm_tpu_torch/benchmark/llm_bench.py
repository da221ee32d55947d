"""LLM-pretrain pipeline benchmark: token store -> NGram windows ->
DataLoader -> Llama AdamW train step on the card.

:func:`write_token_store` writes the store the JAX package's
``benchmark/llm_bench.py`` writes, row for row and row group for row group,
from the same seed. :func:`run_llm_bench` runs the whole chain: rows decode
in reader workers, NGram assembles timestamp-ordered windows per row group,
the loader stacks windows into a dense ``(batch, window)`` int32 tensor
staged onto the card, and a real AdamW Llama step consumes it. It returns
the JAX bench's result keys, measured by the shared harness of
:mod:`.imagenet_bench` (pipelined wall-clock window closed by one
readback, per-step host-side stall attribution, a resident-batch phase
that isolates the device's step time).

``echo=k`` re-yields each staged batch ``k`` times as copies on the card
(the loader's data echoing): the stall of echo=1 against echo>1 is that
feature's measurement.

    python -m petastorm_tpu_torch.benchmark.llm_bench --ctx 8192 --flash
"""
from __future__ import annotations

import numpy as np
import torch

from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

TOKEN_SCHEMA = Unischema("TokSchema", [
    UnischemaField("ts", np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField("token", np.int32, (), ScalarCodec(np.int32), False),
])


def write_token_store(url: str, windows: int, window: int,
                      vocab: int = 32000, seed: int = 0) -> None:
    """Timestamped token store, one NGram window per row group (windows
    never cross row groups): row ``i`` holds ``ts = i`` and a token drawn
    from ``np.random.default_rng(seed)``. The tokens are drawn in one call;
    numpy's generator gives the same values as one draw per row."""
    n = windows * window
    tokens = np.random.default_rng(seed).integers(0, vocab, size=n).astype(np.int32)
    with materialize_dataset_local(url, TOKEN_SCHEMA, rows_per_row_group=window) as w:
        for i in range(n):
            w.write_row({"ts": np.int64(i), "token": tokens[i]})


def run_llm_bench(url: str, steps: int = 20, batch_size: int = 8, window: int = 512,
                  workers_count: int = 8, pool_type: str = "thread", echo: int = 1,
                  resident_steps: int = 0, dense: bool = True, flash: bool = False,
                  xent_chunk: int | None = None, remat_layers: bool = False,
                  model_kwargs: dict | None = None, device="cuda") -> dict:
    """Token windows through the full reader stack into a real Llama
    AdamW train step on ``device``; returns ``{tokens_per_sec,
    input_stall_pct, step_time_ms, loss_first, loss_last[, *_resident],
    ...}`` with the JAX bench's keys.

    The model is the JAX bench's default (vocab 32000, dim 1024, 8 layers,
    8 heads over 4 kv heads, hidden 2816), updated by ``model_kwargs``,
    with parameters drawn from a ``torch.Generator`` seeded 0; the step is
    :func:`~petastorm_tpu_torch.models.llama.make_train_step` with
    ``shift="roll"``. ``flash=True`` uses
    :func:`~petastorm_tpu_torch.ops.flash_attn.make_flash_attention`
    (the flash kernels on the card) instead of dense attention. One warm-up
    step runs before the timed window. Timing is
    :func:`.imagenet_bench.pipelined_window`'s."""
    from petastorm_tpu_torch.benchmark.imagenet_bench import (llama_flops_per_step,
                                                            pipelined_window,
                                                            utilization_metrics)
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.loader.loader import resolve_device
    from petastorm_tpu_torch.models import llama
    from petastorm_tpu_torch.ngram import NGram
    from petastorm_tpu_torch.reader import make_reader

    dev = resolve_device(device)
    kw = dict(vocab=32000, dim=1024, n_layers=8, n_heads=8, n_kv_heads=4, hidden=2816)
    kw.update(model_kwargs or {})
    cfg = llama.LlamaConfig(**kw)
    params = llama.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    attn_fn = None
    if flash:
        from petastorm_tpu_torch.ops.flash_attn import make_flash_attention
        attn_fn = make_flash_attention(causal=True)
    init_opt, step = llama.make_train_step(cfg, shift="roll", attn_fn=attn_fn,
                                           xent_chunk=xent_chunk, remat_layers=remat_layers)
    opt = init_opt(params)

    # dense=True is the column-major window assembly in the worker (no
    # per-row namedtuples); dense=False measures the row path.
    ngram = NGram({o: ["ts", "token"] for o in range(window)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=dense)
    reader = make_reader(url, schema_fields=ngram, num_epochs=None, shuffle_row_groups=True,
                         seed=0, reader_pool_type=pool_type, workers_count=workers_count)
    try:
        loader = DataLoader(reader, batch_size=batch_size, echo=echo, device=dev)
    except BaseException:
        # The loader owns reader shutdown only once constructed.
        reader.stop()
        reader.join()
        raise
    with loader:  # stops and joins the reader on exit
        it = iter(loader)
        try:
            tokens = next(it)["token"]
            if tuple(tokens.shape) != (batch_size, window):
                raise RuntimeError(f"staged token batch {tuple(tokens.shape)}, expected "
                                   f"{(batch_size, window)}")
            flops_per_step = llama_flops_per_step(cfg, batch_size, window)
            params, opt, loss = step(params, opt, {"tokens": tokens})

            def run_step(toks):
                nonlocal params, opt
                params, opt, loss = step(params, opt, {"tokens": toks})
                return loss

            loss_first, loss_last, wait_s, total_wall, resident_s = pipelined_window(
                run_step, lambda: next(it)["token"], steps, resident_steps, warm_loss=loss)
        finally:
            it.close()

    tokens_per_step = batch_size * window
    step_time_s = (total_wall - wait_s) / steps
    device_kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {
        "tokens_per_sec": tokens_per_step * steps / total_wall,
        "input_stall_pct": 100.0 * wait_s / total_wall,
        "step_time_ms": 1000.0 * step_time_s,
        "tokens_per_step": tokens_per_step,
        "echo": echo,
        "dense": dense,
        "flash": flash,
        "xent_chunk": xent_chunk,
        "remat_layers": remat_layers,
        "window": window,
        "devices": 1,
        "loss_first": loss_first,
        "loss_last": loss_last,
        "device_kind": device_kind,
    }
    if resident_s is not None:
        result["step_time_ms_resident"] = 1000.0 * resident_s
        result["tokens_per_sec_resident"] = tokens_per_step / resident_s
        result["tokens_per_sec_per_chip_resident"] = tokens_per_step / resident_s
    utilization_metrics(result, flops_per_step, step_time_s, resident_s, device_kind)
    return result


def _ctx_label(window: int) -> str:
    """32768 -> "32k"."""
    return f"{window // 1024}k" if window % 1024 == 0 else str(window)


def main(argv=None) -> int:
    """Long-context Llama train-step bench on one device::

        python -m petastorm_tpu_torch.benchmark.llm_bench --ctx 8192 --flash \\
            --xent-chunk 2048 --out result.json

    Writes the token store under ``--data-dir`` once (default: a folder in
    the temporary directory) and prints one JSON object of
    ``ctx<N>k_``-prefixed result keys; ``--out`` also writes it with the
    wrapper keys ``n_devices``/``rc``/``ok``/``device_kind``/``tail``."""
    import argparse
    import json
    import os
    import sys
    import tempfile

    parser = argparse.ArgumentParser(description="Llama train-step pipeline benchmark")
    parser.add_argument("--ctx", type=int, default=32768,
                        help="context window (tokens per row group)")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--windows", type=int, default=None,
                        help="windows in the token store (default: enough for "
                             "warmup+steps at the chosen batch)")
    parser.add_argument("--flash", action="store_true",
                        help="flash attention (the hand-written kernels on the card)")
    parser.add_argument("--xent-chunk", type=int, default=None)
    parser.add_argument("--remat-layers", action="store_true")
    parser.add_argument("--tiny-model", action="store_true",
                        help="4-layer dim-256 config for dry runs; the bench's "
                             "default model otherwise")
    parser.add_argument("--device", default="cuda", help='"cuda" (default), "cuda:N" or "cpu"')
    parser.add_argument("--data-dir", default=os.environ.get(
        "BENCH_DATA_DIR", os.path.join(tempfile.gettempdir(), "petastorm_torch_bench")))
    parser.add_argument("--out", default=None, help="also write the result JSON here")
    args = parser.parse_args(argv)

    batch = args.batch_size
    label = _ctx_label(args.ctx)
    windows = args.windows or max(4 * batch, batch * (args.steps + 2))
    store = os.path.join(args.data_dir, f"tokens_ctx{label}_w{windows}")
    url = f"file://{store}"
    if not os.path.exists(os.path.join(store, "_common_metadata")):
        write_token_store(url, windows=windows, window=args.ctx)

    model_kwargs = ({"dim": 256, "n_layers": 4, "n_heads": 4, "n_kv_heads": 2, "hidden": 704}
                    if args.tiny_model else None)
    result = run_llm_bench(url, steps=args.steps, batch_size=batch, window=args.ctx,
                           flash=args.flash, xent_chunk=args.xent_chunk,
                           remat_layers=args.remat_layers, model_kwargs=model_kwargs,
                           device=args.device)
    parsed = {f"ctx{label}_{k}": v for k, v in result.items()}
    tail = (f"llm ctx{label} on {result['device_kind']}: "
            f"{result['tokens_per_sec']:.1f} tok/s, input stall "
            f"{result['input_stall_pct']:.2f}%, step {result['step_time_ms']:.1f} ms, loss "
            f"{result['loss_first']:.4f} -> {result['loss_last']:.4f}")
    print(tail)
    print(json.dumps(parsed))
    if args.out:
        evidence = {"n_devices": result["devices"], "rc": 0, "ok": True,
                    "device_kind": result["device_kind"], "parsed": parsed, "tail": tail + "\n"}
        with open(args.out, "w") as f:
            json.dump(evidence, f, indent=1)
        print(f"result -> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    import sys as _sys
    _sys.exit(main())
