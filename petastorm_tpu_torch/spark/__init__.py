"""Spark integration: the dataset converter (a DataFrame materialized once
into a cached Parquet store, read back through this package's loaders) and
``dataset_as_rdd``. pyspark is imported inside the functions that need it."""
