"""Spark helpers for petastorm stores.

:func:`dataset_as_rdd` returns a Spark RDD of decoded, schema-namedtuple rows
of a store: Spark reads the Parquet and distributes the decode, which this
package's codecs do (:func:`petastorm_tpu_torch.utils.decode.decode_row`).
"""
from __future__ import annotations

from petastorm_tpu_torch.etl.dataset_metadata import get_schema_from_dataset_url
from petastorm_tpu_torch.utils.decode import decode_row


def dataset_as_rdd(dataset_url: str, spark_session, schema_fields=None,
                   storage_options=None, filesystem=None):
    """An RDD of decoded namedtuple records of the store at ``dataset_url``.

    :param spark_session: a SparkSession
    :param schema_fields: fields to read (UnischemaFields, names or regex
        patterns, as ``Unischema.create_schema_view`` takes); None reads
        every field
    :param storage_options/filesystem: how the store's schema is read
        (:class:`~petastorm_tpu_torch.fs_utils.FilesystemResolver`); Spark
        reads the Parquet files through its own filesystem
    """
    schema = get_schema_from_dataset_url(dataset_url, storage_options=storage_options,
                                         filesystem=filesystem)
    dataset_df = spark_session.read.parquet(dataset_url)
    if schema_fields is not None:
        schema = schema.create_schema_view(schema_fields)
        dataset_df = dataset_df.select(*schema.fields.keys())
    return (dataset_df.rdd
            .map(lambda row: decode_row(row.asDict(), schema))
            .map(lambda record: schema.make_namedtuple(**record)))
