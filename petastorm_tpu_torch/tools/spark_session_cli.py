"""Spark session arguments shared by Spark-backed commands: ``--master`` and
``--spark-session-config key=value ...``, and the session they build.
pyspark is imported only when a session is built."""
from __future__ import annotations

import argparse


def add_configure_spark_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--master", type=str, default="local[*]",
                        help="Spark master (default: local[*])")
    parser.add_argument("--spark-session-config", type=str, nargs="+", default=[],
                        help="Extra Spark conf entries as key=value pairs")


def configure_spark(args):
    """The SparkSession of ``args.master`` and ``args.spark_session_config``."""
    try:
        from pyspark.sql import SparkSession
    except ImportError as e:
        raise ImportError("This command requires pyspark") from e
    builder = SparkSession.builder.master(args.master)
    for entry in args.spark_session_config:
        key, _, value = entry.partition("=")
        if not value:
            raise ValueError(f"--spark-session-config entries must be key=value, got {entry!r}")
        builder = builder.config(key, value)
    return builder.getOrCreate()
