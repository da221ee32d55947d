"""``petastorm-tpu-torch-metadata``: print a store's schema, its row groups
and files, and its row-group indexes.

    python -m petastorm_tpu_torch.etl.metadata_util URL [--skip-schema] [--print-values]
"""
from __future__ import annotations

import argparse
import sys

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl.dataset_metadata import (DatasetContext, infer_or_load_unischema,
                                                      load_row_groups)
from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset_url")
    parser.add_argument("--skip-schema", action="store_true")
    parser.add_argument("--print-values", action="store_true",
                        help="Print indexed values of every row-group index")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    ctx = DatasetContext(args.dataset_url)
    if not args.skip_schema:
        print(infer_or_load_unischema(ctx))
    row_groups = load_row_groups(ctx)
    print(f"{len(row_groups)} row groups in {len({rg.path for rg in row_groups})} files")
    try:
        indexes = get_row_group_indexes(ctx)
    except MetadataError:
        print("no row-group indexes")
        return 0
    for name, indexer in indexes.items():
        print(f"index {name!r}: {len(indexer.indexed_values)} values")
        if args.print_values:
            for v in indexer.indexed_values:
                print(f"  {v!r} -> {sorted(indexer.get_row_group_indexes(v))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
