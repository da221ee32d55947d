"""MNIST MLP trained through the PyTorch/CUDA package (BASELINE config 2).

Writes a synthetic, linearly separable 10-class problem shaped like MNIST to
a store, then trains the MLP (momentum SGD) on batches that ``DataLoader``
stages onto the card.

    PYTHONPATH=. python examples/torch_mnist/main.py [--url URL] [--rows 10000] \
        [--epochs 3] [--device cuda]

The store goes to ``mnist_torch`` under the temporary directory (``$TMPDIR``)
unless ``--url`` names another place.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from petastorm_tpu_torch import DataLoader, make_reader
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.models import mlp
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

MnistSchema = Unischema("MnistSchema", [
    UnischemaField("image", np.float32, (784,), NdarrayCodec(), False),
    UnischemaField("label", np.int32, (), ScalarCodec(np.int32), False),
])


def synthetic_mnist(n: int, seed=0):
    """Class prototypes plus noise: separable, shaped like MNIST."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 784)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    images = protos[labels] + 0.5 * rng.normal(size=(n, 784)).astype(np.float32)
    return images, labels


def write_dataset(url: str, images, labels):
    with materialize_dataset_local(url, MnistSchema, rows_per_row_group=1000) as w:
        for img, lbl in zip(images, labels):
            w.write_row({"image": img, "label": lbl})


def train(url: str, epochs: int = 3, batch_size: int = 128, device: str = "cuda",
          log=print) -> dict:
    """Momentum SGD at lr 0.05 for ``epochs`` passes; returns the mean
    accuracy of the last 10 steps, samples/s and the steps taken."""
    params = mlp.init_params(torch.Generator(device=device).manual_seed(0), device=device)
    momentum = {layer: {k: torch.zeros_like(v) for k, v in leaves.items()}
                for layer, leaves in params.items()}
    step = mlp.make_train_step(learning_rate=0.05)
    accs, samples, t_start = [], 0, time.perf_counter()
    for epoch in range(epochs):
        t0 = time.perf_counter()
        losses = []
        with make_reader(url, num_epochs=1, shuffle_row_groups=True, seed=epoch) as reader:
            loader = DataLoader(reader, batch_size=batch_size, shuffling_queue_capacity=5000,
                                seed=epoch, device=device)
            for batch in loader:
                params, momentum, loss, acc = step(params, momentum, batch)
                losses.append(loss)
                accs.append(acc)
                samples += batch_size
        log(f"epoch {epoch}: loss={torch.stack(losses).mean().item():.4f} "
            f"acc={torch.stack(accs[-len(losses):]).mean().item():.4f} "
            f"({time.perf_counter() - t0:.1f}s, {len(losses)} steps)")
    return {"accuracy": torch.stack(accs[-10:]).mean().item(),
            "samples_per_sec": samples / (time.perf_counter() - t_start), "steps": len(accs)}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="file://" + os.path.join(tempfile.gettempdir(),
                                                                   "mnist_torch"))
    parser.add_argument("--rows", type=int, default=10000)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    images, labels = synthetic_mnist(args.rows)
    write_dataset(args.url, images, labels)
    result = train(args.url, epochs=args.epochs, device=args.device)
    print(f"final train accuracy: {result['accuracy']:.4f}; "
          f"{result['samples_per_sec']:.0f} samples/s")
    assert result["accuracy"] > 0.9, "training did not converge"


if __name__ == "__main__":
    main()
