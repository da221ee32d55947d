"""Dataset converter -> K1 -> ViT training with the PyTorch/CUDA package
(BASELINE config 4).

With pyspark installed, a DataFrame of the images goes through
``make_spark_converter`` (materialized once into a cached Parquet store).
Without pyspark, the converter's cache store is written directly (a uint8
``FixedSizeList`` image column and an int32 label, row groups of 256 rows)
and a ``SparkDatasetConverter`` is opened on it: the converter's read side
needs no Spark. Either way ``make_device_loader`` hands out batches on the
card, K1 (``normalize_images``) turns the uint8 images into bf16, and a
small ViT trains with plain SGD.

    PYTHONPATH=. python examples/torch_spark_to_vit/main.py [--url URL] [--rows 4096] \
        [--steps 40] [--batch-size 64] [--device cuda]

The store goes to ``converter_vit_torch`` under the temporary directory
(``$TMPDIR``) unless ``--url`` names another place.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from petastorm_tpu_torch.models import vit
from petastorm_tpu_torch.ops.image_ops import normalize_images

#: The JAX converter example's ViT (``examples/spark_to_vit/main.py``).
VIT = dict(patch=8, dim=64, depth=2, heads=4, mlp_dim=128)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def synthetic_groups(rows: int, classes: int, image: int, rows_per_group: int = 256,
                     seed: int = 0):
    """Yields (images, labels) one row group at a time: each image its
    class's prototype plus Gaussian noise (sigma 40), clipped to uint8 and
    flattened to ``image*image*3``; int32 labels."""
    rng = np.random.default_rng(seed)
    width = image * image * 3
    protos = rng.integers(0, 256, (classes, width)).astype(np.float32)
    labels = rng.integers(0, classes, rows).astype(np.int32)
    for start in range(0, rows, rows_per_group):
        group = labels[start:start + rows_per_group]
        noise = rng.standard_normal((len(group), width), dtype=np.float32) * 40.0
        yield np.clip(protos[group] + noise, 0, 255).astype(np.uint8), group


def build_store_sparkless(url: str, rows: int, classes: int, image: int,
                          rows_per_group: int = 256, seed: int = 0) -> dict:
    """The converter's cache store written directly, one row group at a
    time (a uint8 ``FixedSizeList`` image column and an int32 label);
    returns its footer statistics (``total_rows``, ``file_sizes``)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset_metadata
    path = url[len("file://"):]
    os.makedirs(path, exist_ok=True)
    width = image * image * 3
    schema = pa.schema([("image", pa.list_(pa.uint8(), width)), ("label", pa.int32())])
    with pq.ParquetWriter(f"{path}/part-00000.parquet", schema) as writer:
        for images, labels in synthetic_groups(rows, classes, image, rows_per_group, seed):
            writer.write_table(pa.table({
                "image": pa.FixedSizeListArray.from_arrays(pa.array(images.reshape(-1)), width),
                "label": labels}, schema=schema), row_group_size=rows_per_group)
    return write_dataset_metadata(url, None)


def make_converter(url: str, rows: int, classes: int, image: int):
    """Through ``make_spark_converter`` when pyspark imports (the cache goes
    under ``url``), else a converter over the store written directly at
    ``url``."""
    from petastorm_tpu_torch.spark.spark_dataset_converter import (SparkDatasetConverter,
                                                                   make_spark_converter)
    try:
        from pyspark.sql import SparkSession
        from pyspark.sql.types import ArrayType, IntegerType, StructField, StructType
    except ImportError:
        stats = build_store_sparkless(url, rows, classes, image)
        return SparkDatasetConverter(url, stats["total_rows"])
    spark = SparkSession.builder.getOrCreate()
    schema = StructType([StructField("image", ArrayType(IntegerType()), False),
                         StructField("label", IntegerType(), False)])
    df = spark.createDataFrame([(img.tolist(), int(lbl))
                                for images, labels in synthetic_groups(rows, classes, image)
                                for img, lbl in zip(images, labels)], schema)
    return make_spark_converter(df, parent_cache_dir_url=url, dtype=None)


def train(converter, steps: int, batch_size: int, classes: int, image: int,
          device: str = "cuda", log=print) -> list:
    """``steps`` SGD steps (lr 0.05, bf16 compute) on the converter's
    batches; returns the losses."""
    params = vit.init_params(torch.Generator(device=device).manual_seed(0), image_size=image,
                             num_classes=classes, device=device,
                             **{k: v for k, v in VIT.items()})
    step = vit.make_train_step(0.05, patch=VIT["patch"], heads=VIT["heads"])
    losses = []
    with converter.make_device_loader(batch_size=batch_size, num_epochs=None,
                                      shuffle_row_groups=True, seed=0, device=device) as loader:
        it = iter(loader)
        t0 = time.perf_counter()
        for i in range(steps):
            batch = next(it)
            # A Spark-written store holds the pixels as int32.
            pixels = batch["image"].to(torch.uint8).view(-1, image, image, 3)
            batch = {"image": normalize_images(pixels, MEAN, STD), "label": batch["label"]}
            params, loss, acc = step(params, batch)
            losses.append(loss.item())
            if (i + 1) % 10 == 0:
                log(f"step {i + 1}: loss={np.mean(losses[-10:]):.4f} acc={acc.item():.3f}")
        it.close()
    log(f"{steps * batch_size / (time.perf_counter() - t0):.0f} samples/sec; final loss "
        f"{losses[-1]:.4f} (random={np.log(classes):.2f})")
    return losses


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="file://" + os.path.join(tempfile.gettempdir(),
                                                                   "converter_vit_torch"))
    parser.add_argument("--rows", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    classes, image = 10, 16
    converter = make_converter(args.url, args.rows, classes, image)
    losses = train(converter, args.steps, args.batch_size, classes, image, device=args.device)
    assert losses[-1] < losses[0], "the loss did not fall"


if __name__ == "__main__":
    main()
