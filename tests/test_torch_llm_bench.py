"""The port's ``run_llm_bench`` and its harness against the JAX package's,
on the CPU: the result keys, flash against dense attention, data echoing in
the loader, and the analytic FLOP count."""
import dataclasses

import numpy as np
import pytest
import torch

from petastorm_tpu.benchmark.llm_bench import run_llm_bench as jax_run_llm_bench
from petastorm_tpu_torch.benchmark import imagenet_bench
from petastorm_tpu_torch.benchmark.llm_bench import _ctx_label, run_llm_bench, write_token_store
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.models import llama
from petastorm_tpu_torch.reader import make_reader

# The JAX package's test_llm_bench_runs_on_cpu settings.
TINY = dict(vocab=128, dim=32, n_layers=2, n_heads=2, n_kv_heads=1, hidden=64)
RUN = dict(steps=2, batch_size=8, window=16, workers_count=2)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('llm_bench')}/tok"
    write_token_store(url, windows=16, window=16, vocab=128)
    return url


def test_result_keys_hold_every_key_of_the_jax_run(store):
    got = run_llm_bench(store, echo=2, resident_steps=2, model_kwargs=TINY, device="cpu", **RUN)
    want = jax_run_llm_bench(store, echo=2, resident_steps=2, model_kwargs=TINY, **RUN)
    assert set(want) <= set(got), set(want) - set(got)
    assert got["tokens_per_step"] == want["tokens_per_step"] == 128
    assert got["echo"] == 2 and got["devices"] == 1 and got["device_kind"] == "cpu"
    assert got["tokens_per_sec"] > 0 and 0.0 <= got["input_stall_pct"] <= 100.0
    assert np.isfinite(got["loss_first"]) and np.isfinite(got["loss_last"])
    assert got["step_time_ms_resident"] > 0
    # The CPU never gets a peak: FLOP/s without MFU.
    assert "mfu_pct" not in got and got["model_flops_per_step_per_chip"] > 0


def test_flash_and_dense_losses_agree(store):
    """As the JAX package's wiring test: the losses of the flash run
    (with a chunked loss) and the dense run within 2e-2."""
    rf = run_llm_bench(store, flash=True, xent_chunk=32, model_kwargs=dict(TINY, n_layers=1),
                       device="cpu", **RUN)
    rd = run_llm_bench(store, flash=False, model_kwargs=dict(TINY, n_layers=1), device="cpu", **RUN)
    assert rf["flash"] is True and rd["flash"] is False and rf["xent_chunk"] == 32
    assert abs(rf["loss_first"] - rd["loss_first"]) < 2e-2
    assert abs(rf["loss_last"] - rd["loss_last"]) < 2e-2


def test_echo_yields_clones_not_aliases(store):
    from petastorm_tpu_torch.ngram import NGram
    ngram = NGram({o: ["ts", "token"] for o in range(16)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    with make_reader(store, schema_fields=ngram, reader_pool_type="dummy",
                     shuffle_row_groups=False) as reader:
        batches = list(DataLoader(reader, batch_size=4, echo=2, device="cpu"))
    assert len(batches) == 8
    for first, repeat in zip(batches[::2], batches[1::2]):
        for name in first:
            assert torch.equal(first[name], repeat[name])
            assert first[name].data_ptr() != repeat[name].data_ptr()
    assert not torch.equal(batches[0]["token"], batches[2]["token"])
    with pytest.raises(ValueError, match="echo"):
        DataLoader(reader, batch_size=4, echo=0, device="cpu")


def test_flops_formula_on_a_hand_computed_case():
    """dim 8, 2 heads (hd 4) over 1 kv head, hidden 16, vocab 10, 2 layers
    (the second a 2-expert soft MoE), batch 2, seq 3, T = 6 tokens.
    Attention projections 8*(2+2)*4 + 2*4*8 = 192 multiply-adds a token;
    dense MLP 3*8*16 = 384; MoE 8*2 + 3*2*8*16 + 2*8 = 800; lm_head 80:
    M = 192 + 384 + 192 + 800 + 80 = 1648, so matmuls 6*6*1648 = 59328.
    Attention 6*2*4*2*3*4 = 1152 a layer, 2304 in all."""
    cfg = dataclasses.replace(llama.TINY, vocab=10, dim=8, n_layers=2, n_heads=2, n_kv_heads=1,
                              hidden=16, n_experts=2, moe_every=2)
    assert imagenet_bench.llama_flops_per_step(cfg, batch=2, seq=3) == 59328 + 2304


def test_peak_flops_lookup(monkeypatch):
    monkeypatch.delenv(imagenet_bench.PEAK_FLOPS_ENV, raising=False)
    assert imagenet_bench._peak_flops("NVIDIA H100 80GB HBM3") == (
        989e12, "device_kind:NVIDIA H100 80GB HBM3")
    assert imagenet_bench._peak_flops("cpu") == (None, None)
    assert imagenet_bench._peak_flops("Some Other GPU") == (None, None)
    monkeypatch.setenv(imagenet_bench.PEAK_FLOPS_ENV, "1.5e14")
    assert imagenet_bench._peak_flops("Some Other GPU") == (1.5e14, "env")
    assert imagenet_bench._peak_flops("cpu") == (None, None)   # never on the CPU
    monkeypatch.setenv(imagenet_bench.PEAK_FLOPS_ENV, "garbage")
    assert imagenet_bench._peak_flops("NVIDIA H100 80GB HBM3") == (None, None)


def test_utilization_drops_rates_above_the_peak():
    result = {}
    imagenet_bench.utilization_metrics(result, 989e12, 0.5, 2.0, "NVIDIA H100 80GB HBM3")
    assert "mfu_pct" not in result and "mfu_pipelined_dropped" in result
    assert result["mfu_pct_resident"] == pytest.approx(50.0)


def test_hard_sync_reads_one_element_and_ctx_label():
    assert imagenet_bench.hard_sync(torch.tensor([[2.5, 1.0]])) == 2.5
    assert _ctx_label(32768) == "32k" and _ctx_label(1000) == "1000"
