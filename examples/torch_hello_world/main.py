"""hello_world for the PyTorch/CUDA package: write a 3-field store, read
one row back, then a batch of tensors staged onto the card (BASELINE
config 1).

    PYTHONPATH=. python examples/torch_hello_world/main.py [--url URL] [--device cuda]

The store goes to ``hello_world_torch`` under the temporary directory
(``$TMPDIR``) unless ``--url`` names another place.
"""
import argparse
import os
import tempfile

import numpy as np

from petastorm_tpu_torch import DataLoader, make_reader
from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

HelloWorldSchema = Unischema("HelloWorldSchema", [
    UnischemaField("id", np.int32, (), ScalarCodec(np.int32), False),
    UnischemaField("image1", np.uint8, (128, 256, 3), CompressedImageCodec("png"), False),
    UnischemaField("array_4d", np.uint8, (4, 128, 30, 3), NdarrayCodec(), False),
])
DEFAULT_URL = "file://" + os.path.join(tempfile.gettempdir(), "hello_world_torch")


def generate(url: str, rows: int = 32):
    rng = np.random.default_rng(0)
    with materialize_dataset_local(url, HelloWorldSchema, rows_per_row_group=8) as w:
        for i in range(rows):
            w.write_row({"id": np.int32(i),
                         "image1": rng.integers(0, 255, (128, 256, 3)).astype(np.uint8),
                         "array_4d": rng.integers(0, 255, (4, 128, 30, 3)).astype(np.uint8)})


def main(url: str = DEFAULT_URL, device: str = "cuda"):
    generate(url)
    with make_reader(url, num_epochs=1, shuffle_row_groups=False) as reader:
        sample = next(reader)
        print("row sample: id =", sample.id, "image1", sample.image1.shape)
    with make_reader(url, num_epochs=1, shuffle_row_groups=False) as reader:
        with DataLoader(reader, batch_size=8, device=device) as loader:
            batch = next(iter(loader))
    print("torch batch:", tuple(batch["image1"].shape), batch["image1"].dtype,
          "on", batch["image1"].device)
    return batch


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default=DEFAULT_URL)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.url, args.device)
