"""How far the port's float32 ResNet-50 forward moves with torch's CPU thread
count, stage by stage.

The inputs are ``tests/test_torch_resnet.py::test_full_width_forward_f32_matches``'s:
the JAX package's ``init_params(PRNGKey(0), 1000)`` (JAX is imported only to
make them, on the CPU), 2 images of 64x64 from ``default_rng(1)``, training
mode. The port's forward runs at 1 thread, then at each other count, and
every stage's output (the stem, stages 0-3, the logits) and the new batch
statistics are held to the 1-thread run by the test's measure,
``max |a - b| / max |b|``. The JAX package's forward runs too, in one
process for each XLA CPU thread setting (``XLA_FLAGS`` is read when JAX
starts): one thread (``--xla_cpu_multi_thread_eigen=false
intra_op_parallelism_threads=1``) and XLA's default, every core. Its logits
at the default are held to its logits at one thread, and the port's logits
at every torch thread count to both, as the test holds them (its bar is
1e-4). Last, the stem's convolution and its batch statistics
(``torch.native_batch_norm``) alone, on the channels-last tensor the port
gives them and on a contiguous copy, each held to its own 1-thread result.

    JAX_PLATFORMS=cpu python tools/torch_resnet_threads_probe.py [--threads 1,2,4,8]

Prints one JSON object.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


#: XLA CPU thread setting -> XLA_FLAGS
XLA_THREADS = {
    "xla_1_thread": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
    "xla_default": "",
}


def _inputs():
    """The test's inputs: the JAX package's parameters and the images."""
    import jax
    from petastorm_tpu.models import resnet as jax_resnet
    jax_params = jax.tree.map(np.asarray, jax_resnet.init_params(jax.random.PRNGKey(0), 1000))
    images = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    return jax_params, images


def _jax_logits(out_path: str) -> None:
    """The JAX package's forward under this process's ``XLA_FLAGS``, its
    logits saved to ``out_path``."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from petastorm_tpu.models import resnet as jax_resnet
    jax_params, images = _inputs()
    logits, _ = jax.jit(partial(jax_resnet.apply, train=True, compute_dtype=jnp.float32))(
        jax_params, jnp.asarray(images))
    np.save(out_path, np.asarray(logits))


def _jax_runs() -> dict:
    """``{setting: logits}``, one process for each of :data:`XLA_THREADS`."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in XLA_THREADS.items():
            path = os.path.join(tmp, f"{name}.npy")
            env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
            subprocess.run([sys.executable, os.path.abspath(__file__), "--jax-logits", path],
                           env=env, check=True)
            out[name] = np.load(path)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _staged_forward(resnet, params, images):
    """The port's ``apply(train=True, compute_dtype=float32)``, keeping each
    stage's output: ``({stage: array}, logits, statistics leaves)``."""
    import torch
    import torch.nn.functional as F
    out = {}
    x = images.to(torch.float32).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    norm = resnet._norm(True, None, torch.float32)
    x, stem_stats = norm(resnet._conv(x, params["stem"]["conv"], 2), params["stem"]["bn"])
    x = resnet._max_pool(F.relu(x))
    out["stem"] = x.detach().numpy().copy()
    stats = [stem_stats]
    for stage_idx, (blocks, _) in enumerate(resnet._RESNET50_STAGES):
        for block_idx in range(blocks):
            stride = 2 if (block_idx == 0 and stage_idx > 0) else 1
            x, s = resnet._bottleneck(x, params[f"stage{stage_idx}"][block_idx], stride, True)
            stats.append(s)
        out[f"stage{stage_idx}"] = x.detach().numpy().copy()
    pooled = x.float().mean((2, 3))
    logits = pooled @ params["head"]["w"] + params["head"]["b"]
    out["logits"] = logits.detach().numpy().copy()
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            leaves.append(node.detach().numpy().copy())
    walk(stats)
    return out, leaves


def _stem_ops(resnet, params, images) -> dict:
    """The stem's convolution, and the batch statistics of its output in
    channels-last and contiguous layout, as float32 arrays."""
    import torch
    x = images.to(torch.float32).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    conv = resnet._conv(x, params["stem"]["conv"], 2)
    bn = params["stem"]["bn"]
    out = {"conv": conv.numpy().copy()}
    for layout, t in (("channels_last", conv), ("contiguous", conv.contiguous())):
        _, mean, invstd = torch.native_batch_norm(t, bn["scale"], bn["bias"], None, None,
                                                  True, 0.0, 1e-5)
        out[f"bn_mean_{layout}"] = mean.numpy().copy()
        out[f"bn_invstd_{layout}"] = invstd.numpy().copy()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", default="1,2,4,8")
    parser.add_argument("--jax-logits", metavar="NPY", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.jax_logits:
        _jax_logits(args.jax_logits)
        return 0
    counts = [int(t) for t in args.threads.split(",")]

    jax_logits = _jax_runs()
    import torch

    from petastorm_tpu_torch.models import resnet

    jax_params, images = _inputs()
    params = resnet.params_from_jax(jax_params, device="cpu")

    runs, ops = {}, {}
    with torch.no_grad():
        for n in [1] + [c for c in counts if c != 1]:
            torch.set_num_threads(n)
            runs[n] = _staged_forward(resnet, params, torch.from_numpy(images))
            # The test's own call, at the same count.
            logits, _ = resnet.apply(params, torch.from_numpy(images), train=True,
                                     compute_dtype=torch.float32)
            runs[n][0]["apply_logits"] = logits.numpy().copy()
            ops[n] = _stem_ops(resnet, params, torch.from_numpy(images))
    base, base_stats = runs[1]
    report = {"threads": counts, "torch": torch.__version__, "cpus": os.cpu_count(),
              "vs_1_thread": {}, "logits_vs_jax": {}, "stem_ops_vs_1_thread": {},
              "bar": 1e-4,
              "jax_default_vs_jax_1_thread": _rel(jax_logits["xla_default"],
                                                  jax_logits["xla_1_thread"])}
    for n in counts:
        stages, stats = runs[n]
        report["vs_1_thread"][n] = {
            **{k: _rel(v, base[k]) for k, v in stages.items() if k != "apply_logits"},
            "batch_stats_max": max(_rel(a, b) for a, b in zip(stats, base_stats))}
        report["stem_ops_vs_1_thread"][n] = {k: _rel(v, ops[1][k]) for k, v in ops[n].items()}
        report["logits_vs_jax"][n] = {name: _rel(stages["apply_logits"], want)
                                      for name, want in jax_logits.items()}
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
