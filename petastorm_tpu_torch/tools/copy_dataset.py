"""``petastorm-tpu-torch-copy-dataset``: copy a petastorm store, optionally
narrowed to some columns and to rows whose given fields are not null,
without Spark.

    python -m petastorm_tpu_torch.tools.copy_dataset SOURCE_URL TARGET_URL \
        [--field-regex RE ...] [--not-null-fields NAME ...] [--overwrite-output]
"""
from __future__ import annotations

import argparse
import sys

from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
from petastorm_tpu_torch.predicates import in_lambda
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.unischema import Unischema


def _not_null(values: dict, fields) -> bool:
    return all(values[f] is not None for f in fields)


def copy_dataset(source_url: str, target_url: str, field_regex=None, not_null_fields=None,
                 rows_per_row_group: int = 1000, workers_count: int = 4,
                 overwrite_output: bool = False, row_group_size_mb: int = None) -> int:
    """Copy the rows of one store into a new one; returns the rows copied.

    An existing non-empty target raises unless ``overwrite_output``, which
    deletes it first (once the source has opened). A target that is the
    source, or lies inside it or around it, raises. ``row_group_size_mb``
    bounds the output's row groups by bytes instead of
    ``rows_per_row_group``."""
    src_fs, source_path = get_filesystem_and_path_or_paths(source_url)
    fs, target_path = get_filesystem_and_path_or_paths(target_url)
    if type(src_fs) is type(fs):
        # Either nesting is fatal: overwriting removes the target tree, and a
        # target around the source takes the source with it.
        src_parts = str(source_path).rstrip("/").split("/")
        tgt_parts = str(target_path).rstrip("/").split("/")
        shorter = min(len(src_parts), len(tgt_parts))
        if src_parts[:shorter] == tgt_parts[:shorter]:
            raise ValueError(f"source ({source_url}) and target ({target_url}) are the same "
                             f"path or nested within each other; refusing: "
                             f"--overwrite-output would delete source data")
    predicate = (in_lambda(list(not_null_fields), _not_null, list(not_null_fields))
                 if not_null_fields else None)
    writer_kwargs = ({"row_group_size_mb": row_group_size_mb} if row_group_size_mb is not None
                     else {"rows_per_row_group": rows_per_row_group})
    copied = 0
    with make_reader(source_url, schema_fields=field_regex, predicate=predicate,
                     shuffle_row_groups=False, num_epochs=1,
                     workers_count=workers_count) as reader:
        # The target goes only once the source has opened: a mistyped source
        # must not cost an existing target.
        if fs.exists(target_path) and fs.ls(target_path):
            if not overwrite_output:
                raise ValueError(f"Target {target_url} already exists; pass "
                                 f"overwrite_output=True (--overwrite-output) to replace it")
            fs.rm(target_path, recursive=True)
        out_schema = Unischema(reader.schema.name + "_copy", list(reader.schema.fields.values()))
        with materialize_dataset_local(target_url, out_schema, **writer_kwargs) as writer:
            for sample in reader:
                writer.write_row(sample._asdict())
                copied += 1
    return copied


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("source_url")
    parser.add_argument("target_url")
    parser.add_argument("--field-regex", nargs="+",
                        help="Copy only fields matching these regexes")
    parser.add_argument("--not-null-fields", nargs="+",
                        help="Skip rows where any of these fields is null")
    parser.add_argument("--overwrite-output", action="store_true",
                        help="Replace an existing target (default: an existing target is "
                             "an error)")
    parser.add_argument("--rows-per-row-group", type=int, default=1000)
    parser.add_argument("--row-group-size-mb", type=int, default=None,
                        help="Bound output row groups by bytes instead of "
                             "--rows-per-row-group")
    parser.add_argument("--partition-count", type=int, default=None,
                        help="Accepted for the reference CLI's sake and ignored (a Spark "
                             "repartition; this copy runs without Spark)")
    parser.add_argument("--hdfs-driver", default=None,
                        help="Accepted for the reference CLI's sake and ignored")
    parser.add_argument("-w", "--workers-count", type=int, default=4)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.partition_count is not None:
        print("note: --partition-count is ignored (copy without Spark)", file=sys.stderr)
    copied = copy_dataset(args.source_url, args.target_url, field_regex=args.field_regex,
                          not_null_fields=args.not_null_fields,
                          rows_per_row_group=args.rows_per_row_group,
                          workers_count=args.workers_count,
                          overwrite_output=args.overwrite_output,
                          row_group_size_mb=args.row_group_size_mb)
    print(f"copied {copied} rows to {args.target_url}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
