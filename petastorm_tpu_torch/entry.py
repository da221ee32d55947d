"""The port's top-level entry points: the flagship forward, ResNet-50 on
ImageNet-sized images, and the multi-rank dry run of every parallelism
mode, the counterparts of the JAX package's ``__graft_entry__.entry()`` and
``__graft_entry__.dryrun_multichip()``."""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.benchmark.llm_bench import write_token_store
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.loader.loader import resolve_device
from petastorm_tpu_torch.models import resnet
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.parallel.launch import run_ranks
from petastorm_tpu_torch.reader import make_reader


def entry(device="cuda"):
    """-> ``(forward, (params, example_images))``: ``forward(params,
    images)`` gives the logits of ResNet-50 with 1000 classes in inference
    mode (bf16 compute), parameters drawn from a ``torch.Generator`` seeded
    0, and the reference's 8 example images,
    ``np.random.default_rng(0).random((8, 224, 224, 3))`` as float32."""
    dev = resolve_device(device)
    params = resnet.init_params(torch.Generator(device=dev).manual_seed(0), num_classes=1000,
                                device=dev)

    def forward(params, images):
        logits, _ = resnet.apply(params, images, train=False)
        return logits

    example_images = torch.from_numpy(
        np.random.default_rng(0).random((8, 224, 224, 3)).astype(np.float32)).to(dev)
    return forward, (params, example_images)


# ------------------------------------------------------------ the dry run
# The port of ``__graft_entry__.dryrun_multichip``: every parallelism mode's
# training step on ``n`` ranks at tiny shapes, each held to its bar. Ranks
# are processes (``run_ranks``) where the JAX package uses virtual devices.

#: The dry run's bars: sequence-parallel strategies and FSDP against the
#: ring's loss, the switch MoE against a replicated run of the same config,
#: the pipeline against the sequential layer loop in float32 and in bf16.
DRYRUN_BARS = {"strategies": 1e-2, "fsdp": 1e-2, "switch": 5e-3, "pp_f32": 1e-5,
               "pp_bf16": 5e-3}


def dryrun_plan(n_devices: int) -> dict:
    """The dry run's layout for ``n_devices`` ranks, by the JAX package's
    guards (``__graft_entry__.py:179-238, 327-330``): the ``(data, seq,
    model)`` sizes, an incompatible model factor folded into data, the
    sequence-parallel strategies and the SKIPPED lines, and the pipeline's
    ``(pipe, data)`` sizes (``pp == 1``: skipped)."""
    n = n_devices
    if n % 8 == 0:
        dp, sp, tp = 2, 2, n // 4
    elif n % 2 == 0:
        dp, sp, tp = 1, 2, n // 2
    else:
        dp, sp, tp = 1, 1, n
    # The model axis must divide the 8 query and the 4 kv heads.
    if tp > 1 and (8 % tp or 4 % tp):
        g = math.gcd(tp, 4)
        dp, tp = dp * (tp // g), g
    heads, kv_heads = 8 // tp, 4 // tp
    strategies, skipped = ["ring", "ring-flash"], []
    if sp > 1 and heads % sp == 0 and kv_heads % sp == 0:
        strategies.append("ulysses")
    elif sp <= 1:
        skipped.append(f"dryrun_multichip({n}): ulysses SKIPPED (sp={sp}: no sequence axis "
                       f"to all-to-all over)")
    else:
        skipped.append(f"dryrun_multichip({n}): ulysses SKIPPED (local head counts "
                       f"q={heads} kv={kv_heads} not divisible by sp={sp})")
    pp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return {"mesh": (dp, sp, tp), "strategies": strategies, "skipped": skipped,
            "pipe": (pp, n // pp)}


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def _dryrun_rank(rank: int, world: int, url: str, batch_size: int, seq_len: int, device: str,
                 bars: dict) -> tuple:
    """The dry run on one of ``world`` ranks -> (the lines it reports, the
    same on every rank; its kernel launches by name)."""
    from petastorm_tpu_torch.models import llama
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.parallel.pipeline import make_pipeline, stack_stage_params
    from petastorm_tpu_torch.parallel.ring_attention import make_ring_attention
    from petastorm_tpu_torch.parallel.ulysses_attention import make_ulysses_attention

    if device == "cpu":
        torch.set_num_threads(1)
    dev = resolve_device(device)
    kernels.reset_launch_counts()
    n, plan = world, dryrun_plan(world)
    dp, sp, tp = plan["mesh"]
    mesh = make_mesh((dp, sp, tp), ("data", "seq", "model"))
    groups = dict(seq_group=mesh.group("seq"), data_group=mesh.group("data"),
                  model_group=mesh.group("model"))
    cfg = llama.LlamaConfig(vocab=128, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden=128,
                            n_experts=2 * max(tp, 1), moe_every=2)
    lines = []

    # The store's windows through make_reader + NGram(dense) + the loader;
    # each rank keeps its rows (the data axis); loss_fn takes its block of
    # the window (the seq axis).
    ngram = NGram({o: ["ts", "token"] for o in range(seq_len)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    with DataLoader(make_reader(url, schema_fields=ngram, shuffle_row_groups=False,
                                reader_pool_type="dummy"),
                    batch_size=batch_size, device=dev) as loader:
        tokens = next(iter(loader))["token"]
    _require(tuple(tokens.shape) == (batch_size, seq_len), f"token batch {tuple(tokens.shape)}")
    rows = batch_size // dp
    d_idx = dist.get_rank(mesh.group("data"))
    mine = {"tokens": tokens[d_idx * rows:(d_idx + 1) * rows]}
    lines.append(f"dryrun_multichip: fed from petastorm store: {batch_size} windows of "
                 f"{seq_len} tokens (store -> make_reader+NGram -> DataLoader -> ('data','seq') "
                 f"rank blocks)")
    lines += plan["skipped"]

    def init(c):
        return llama.init_params(torch.Generator(device=dev).manual_seed(0), c, device=dev)

    def step_loss(c, shardings, attn, **kw):
        params = llama.shard_params(init(c), shardings, mesh)
        # onehot: the table is vocab-sharded over the model axis.
        init_opt, step = llama.make_train_step(c, attn_fn=attn, embed_lookup="onehot",
                                               shift="roll", **dict(groups, **kw))
        return step(params, init_opt(params), mine)[2].item()

    # ---- check 1: dp x sp x tp(+ep) on each sequence-parallel strategy
    makers = {"ring": make_ring_attention,
              "ring-flash": functools.partial(make_ring_attention, local_attn="flash"),
              "ulysses": make_ulysses_attention}
    details = {"ring": f"dp{dp} x sp{sp} x tp{tp} (+ep={cfg.n_experts} experts on model axis)",
               "ring-flash": f"sp{sp} flash kernel local step", "ulysses": f"sp{sp} all-to-all"}
    losses = {}
    for name in plan["strategies"]:
        attn = makers[name](mesh, seq_axis="seq", data_axis="data", head_axis="model",
                            causal=True)
        losses[name] = step_loss(cfg, llama.param_shardings(mesh, cfg), attn)
        _require(np.isfinite(losses[name]), f"non-finite {name} loss {losses[name]}")
        lines.append(f"dryrun_multichip({n}): {name} {details[name]} "
                     f"loss={losses[name]:.4f} OK")
    _require(all(abs(v - losses["ring"]) < bars["strategies"] for v in losses.values()),
             f"SP strategies disagree: {losses}")

    def ring():
        return make_ring_attention(mesh, seq_axis="seq", data_axis="data", head_axis="model",
                                   causal=True)

    # ---- check 2: FSDP (ZeRO-3) over the data axis, composed with tp
    loss = step_loss(cfg, llama.param_shardings_fsdp(mesh, cfg), ring(),
                     fsdp_group=mesh.group("data"))
    _require(abs(loss - losses["ring"]) < bars["fsdp"],
             f"FSDP loss {loss} != dense-layout loss {losses['ring']}")
    lines.append(f"dryrun_multichip({n}): fsdp(zero-3) dp{dp} x tp{tp} params+opt sharded "
                 f"loss={loss:.4f} OK")

    # ---- check 2b: switch-MoE sparse dispatch against a replicated run
    sw_cfg = dataclasses.replace(cfg, moe_dispatch="switch", moe_top_k=2,
                                 moe_capacity_factor=2.0)
    loss = step_loss(sw_cfg, llama.param_shardings(mesh, sw_cfg), ring())
    _require(np.isfinite(loss), f"non-finite switch-moe loss {loss}")
    with torch.no_grad():
        rep_loss = llama.loss_fn(init(sw_cfg), {"tokens": tokens}, sw_cfg, shift="roll").item()
    _require(abs(loss - rep_loss) < bars["switch"],
             f"switch-moe sharded loss {loss} != replicated {rep_loss}")
    lines.append(f"dryrun_multichip({n}): switch-moe top2 ep{sw_cfg.n_experts} capacity-dispatch "
                 f"loss={loss:.4f} == unsharded {rep_loss:.4f} OK")

    # ---- check 3: pp (GPipe) x dp, one block per stage
    pp, pdp = plan["pipe"]
    if pp == 1:
        lines.append(f"dryrun_multichip({n}): pp SKIPPED (n_devices={n} has no factor of 2 for "
                     f"a pipe axis)")
        return lines, dict(kernels.launch_counts)
    pmesh = make_mesh((pp, pdp), ("pipe", "data"))
    # Dense (no MoE): every stage's tree has the same keys; n_layers = pp.
    pcfg = llama.LlamaConfig(vocab=cfg.vocab, dim=cfg.dim, n_layers=pp, n_heads=cfg.n_heads,
                             n_kv_heads=cfg.n_kv_heads, hidden=cfg.hidden, n_experts=0)
    ptokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, pcfg.vocab, (4 * pdp, 33)).astype(np.int32)).to(dev)
    pd_idx = dist.get_rank(pmesh.group("data"))
    pmine = {"tokens": ptokens[4 * pd_idx:4 * (pd_idx + 1)]}

    def stage_fn(layer, x):
        return llama.apply_block(layer, x, pcfg)[0]

    pipe = make_pipeline(pmesh, stage_fn, n_microbatches=4, data_axis="data")

    def layers_fn(stage, x):
        return pipe(stage, x), torch.zeros((), dtype=torch.float32, device=x.device)

    for dt_name, dt, tol in (("f32", torch.float32, bars["pp_f32"]),
                             ("bf16", torch.bfloat16, bars["pp_bf16"])):
        params = init(pcfg)
        with torch.no_grad():   # the sequential layer loop on the whole batch
            ref = llama.loss_fn(params, {"tokens": ptokens}, pcfg, compute_dtype=dt).item()
        params["layers"] = stack_stage_params(params["layers"], pmesh)
        init_opt, step = llama.make_train_step(pcfg, layers_fn=layers_fn, compute_dtype=dt,
                                               data_group=pmesh.group("data"))
        pl = step(params, init_opt(params), pmine)[2].item()
        _require(np.isfinite(pl), f"non-finite pipeline loss {pl}")
        _require(abs(pl - ref) < tol,
                 f"pipelined llama {dt_name} loss {pl} != sequential {ref} (tol {tol})")
        lines.append(f"dryrun_multichip({n}): pp{pp} x dp{pdp} llama {dt_name} (1 block/stage, "
                     f"AdamW, tol {tol}) loss={pl:.6f} == sequential {ref:.6f} OK")
    return lines, dict(kernels.launch_counts)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The full training step under every parallelism mode on ``n_devices``
    ranks (:func:`~petastorm_tpu_torch.parallel.launch.run_ranks`, gloo; on
    ``device="cuda"`` all of them share ``cuda:0``), at the JAX dry run's
    tiny shapes, printing one ``OK`` line a check and a ``SKIPPED`` line
    where a divisibility guard drops a strategy (:func:`dryrun_plan`):

    1. Llama + AdamW over a ``(data, seq, model)`` mesh: data, sequence
       (ring, ring with the flash kernels as its local step, and Ulysses),
       tensor and expert parallelism, each within ``DRYRUN_BARS`` of the
       ring's loss. The tokens are a store written here, read back through
       ``make_reader`` + ``NGram`` + ``DataLoader``;
    2. FSDP composed with the model axis, within the bar of the ring's loss;
       the switch MoE (top-2, capacity factor 2) against a replicated run of
       the same config;
    3. a GPipe pipeline of the same Llama (one block a stage, 4
       microbatches) over a ``(pipe, data)`` mesh, against the sequential
       layer loop in float32 and in bf16.

    A failed bar raises (on the rank, and so here). -> ``{"lines": the
    printed lines, "launches": the kernels' launches by name, summed over
    the ranks}`` (on the card, ring-flash launches K2 "stats", K3 and K4)."""
    plan = dryrun_plan(n_devices)
    dp, sp, _ = plan["mesh"]
    batch_size, seq_len = 2 * dp, 32 * sp
    with tempfile.TemporaryDirectory(prefix="dryrun_tokens_") as tmp:
        url = f"file://{tmp}/tokens"
        write_token_store(url, windows=batch_size, window=seq_len, vocab=128, seed=0)
        ranks = run_ranks(_dryrun_rank, n_devices, args=(url, batch_size, seq_len, device,
                                                         dict(DRYRUN_BARS)),
                          device=device)
    lines, launches = ranks[0][0], collections.Counter()
    for _, counts in ranks:
        launches.update(counts)
    for line in lines:
        print(line, flush=True)
    return {"lines": lines, "launches": dict(launches)}
