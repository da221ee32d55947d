"""Command-line tools over petastorm stores: ``copy_dataset`` and the Spark
session arguments of Spark-backed commands."""
