"""``petastorm-tpu-torch-generate-metadata``: (re)write the metadata of an
existing Parquet store without Spark: the stored schema (or one inferred
from the Arrow schema, or a named Unischema object) and the row-group index
go into ``_common_metadata``; ``--use-summary-metadata`` also writes a
summary ``_metadata`` of every file's row groups.

    python -m petastorm_tpu_torch.etl.generate_metadata URL
    python -m petastorm_tpu_torch.etl.generate_metadata --dataset_url URL \
        [--unischema_class package.module.Schema]
"""
from __future__ import annotations

import argparse
import importlib
import sys

from petastorm_tpu_torch.etl.dataset_metadata import (DatasetContext, infer_or_load_unischema,
                                                      load_row_groups, write_dataset_metadata,
                                                      write_summary_metadata)
from petastorm_tpu_torch.unischema import Unischema


def _load_unischema_class(class_path: str):
    """The Unischema object ``package.module.SchemaObject`` names."""
    module_name, _, attr = class_path.rpartition(".")
    if not module_name:
        raise ValueError(f"--unischema_class must be a full dotted path, got {class_path!r}")
    return getattr(importlib.import_module(module_name), attr)


def generate_metadata(dataset_url: str, use_inferred_schema: bool = False,
                      use_summary_metadata: bool = False, unischema_class: str = None) -> int:
    """Write the store's metadata; returns the row groups indexed."""
    ctx = DatasetContext(dataset_url)
    if unischema_class:
        schema = _load_unischema_class(unischema_class)
    elif use_inferred_schema:
        schema = Unischema.from_arrow_schema(ctx.arrow_schema(), omit_unsupported_fields=True)
    else:
        schema = infer_or_load_unischema(ctx)
    # The summary's footer pass feeds the index: each file is opened once.
    stats = write_summary_metadata(ctx) if use_summary_metadata else None
    write_dataset_metadata(ctx, schema, file_stats=stats)
    return len(load_row_groups(ctx))


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    # The reference spells the URL as an option (--dataset_url); both work.
    parser.add_argument("dataset_url", nargs="?", default=None)
    parser.add_argument("--dataset_url", dest="dataset_url_opt", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--unischema_class", default=None,
                        help="Full dotted path of a Unischema object to store instead of "
                             "the stored or inferred one")
    parser.add_argument("--use-inferred-schema", action="store_true",
                        help="Ignore any stored schema; infer one from the Arrow schema")
    parser.add_argument("--use-summary-metadata", action="store_true",
                        help="Also write a summary _metadata file (the row groups of every "
                             "data file, tagged with their file paths)")
    for ignored in ("--master", "--spark-driver-memory", "--hdfs-driver"):
        parser.add_argument(ignored, default=None,
                            help="Accepted for the reference CLI's sake and ignored (this "
                                 "command runs without Spark)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.dataset_url and args.dataset_url_opt and args.dataset_url != args.dataset_url_opt:
        parser.error(f"conflicting dataset urls: positional {args.dataset_url!r} vs "
                     f"--dataset_url {args.dataset_url_opt!r}")
    url = args.dataset_url or args.dataset_url_opt
    if not url:
        parser.error("dataset_url is required (positional or --dataset_url)")
    n = generate_metadata(url, args.use_inferred_schema, args.use_summary_metadata,
                          unischema_class=args.unischema_class)
    print(f"metadata written; {n} row groups indexed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
