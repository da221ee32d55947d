"""``petastorm-tpu-torch-throughput``: reader throughput of a store (the JAX
package's ``benchmark/cli.py``, with ``-d torch`` for its ``-d jax``)::

    python -m petastorm_tpu_torch.benchmark.cli file:///path/to/store --json
    python -m petastorm_tpu_torch.benchmark.cli URL -d torch --device-step-ms 50
    python -m petastorm_tpu_torch.benchmark.cli URL -d torch --device cpu

``--json`` prints one line with the JAX CLI's keys.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys


def build_parser():
    parser = argparse.ArgumentParser(
        description="Measure petastorm_tpu_torch reader throughput on a dataset")
    parser.add_argument("dataset_url", help="Dataset URL (file://, s3://, hdfs://, ...)")
    parser.add_argument("-f", "--field-regex", nargs="+",
                        help="Read only fields matching these regexes")
    parser.add_argument("-w", "--workers-count", type=int, default=3)
    parser.add_argument("-p", "--pool-type", default="thread",
                        choices=["thread", "process", "dummy"])
    parser.add_argument("-m", "--warmup-cycles", type=int, default=200)
    parser.add_argument("-n", "--measure-cycles", type=int, default=1000)
    parser.add_argument("-d", "--read-method", default="python",
                        choices=["python", "tf", "torch"],
                        help="python: the reader's rows; tf: the rows through a tf.data "
                             "Dataset (make_petastorm_dataset); torch: batches of 16 staged "
                             "onto --device by the port's DataLoader")
    parser.add_argument("-q", "--shuffling-queue-size", type=int, default=500)
    parser.add_argument("--min-after-dequeue", type=int, default=400)
    parser.add_argument("--device", default="cuda",
                        help="With -d torch: where the DataLoader stages its batches and "
                             "the synthetic step runs (cuda, cuda:N or cpu)")
    parser.add_argument("--device-step-ms", type=float, default=None,
                        help="With -d torch: overlap batches against a calibrated device "
                             "step of this duration and report the input stall against the "
                             "step as measured")
    parser.add_argument("--profile-threads", action="store_true",
                        help="cProfile the measurement (on Python 3.12 every thread of the "
                             "process) and print cumulative stats at the end")
    parser.add_argument("--spawn-new-process", action="store_true",
                        help="Re-run the measurement in a fresh interpreter so RSS is not "
                             "polluted by this process's history")
    parser.add_argument("--rowgroup-coalescing", type=int, default=1,
                        help="Read up to N same-file row groups per IO call")
    parser.add_argument("--json", action="store_true", help="Emit one JSON line")
    parser.add_argument("-v", action="store_true", help="INFO logging")
    parser.add_argument("-vv", action="store_true", help="DEBUG logging")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.vv:
        logging.basicConfig(level=logging.DEBUG)
    elif args.v:
        logging.basicConfig(level=logging.INFO)

    if args.spawn_new_process:
        import subprocess
        argv = list(sys.argv[1:] if argv is None else argv)
        # The flag may be any unambiguous argparse prefix (--spawn-new, --sp).
        argv = [a for a in argv
                if not (a.startswith("--sp") and "--spawn-new-process".startswith(a))]
        return subprocess.call([sys.executable, "-m", "petastorm_tpu_torch.benchmark.cli",
                                *argv])

    from petastorm_tpu_torch.benchmark.throughput import reader_throughput
    result = reader_throughput(
        args.dataset_url, field_regex=args.field_regex,
        warmup_cycles=args.warmup_cycles, measure_cycles=args.measure_cycles,
        pool_type=args.pool_type, loaders_count=args.workers_count,
        shuffling_queue_size=args.shuffling_queue_size,
        min_after_dequeue=args.min_after_dequeue, read_method=args.read_method,
        device_step_ms=args.device_step_ms, profile_threads=args.profile_threads,
        device=args.device,
        reader_extra_kwargs=({"rowgroup_coalescing": args.rowgroup_coalescing}
                             if args.rowgroup_coalescing > 1 else None))
    print(json.dumps(result.as_dict()) if args.json else result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
