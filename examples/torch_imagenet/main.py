"""ImageNet-style ResNet-50 training through the PyTorch/CUDA package
(BASELINE config 3): ``CompressedImageCodec`` JPEG decode in the reader's
workers -> uint8 batches staged onto the card by ``DataLoader`` -> flips and
crops on the card -> K1 (``normalize_images``: uint8 to normalized bf16)
-> the ResNet-50 step, with the input stall measured against the real step.

A synthetic class-separable image store keeps the example self-contained;
write a real ImageNet store in its place to train on the real thing.

    PYTHONPATH=. python examples/torch_imagenet/main.py [--url URL] [--rows 2048] \
        [--steps 30] [--batch 8] [--device cuda]

The store goes to ``imagenet_torch`` under the temporary directory
(``$TMPDIR``) unless ``--url`` names another place.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from petastorm_tpu_torch import DataLoader, make_reader
from petastorm_tpu_torch.benchmark.imagenet_bench import write_synthetic_imagenet
from petastorm_tpu_torch.loader import DTypePolicy
from petastorm_tpu_torch.models import resnet
from petastorm_tpu_torch.ops.augment import random_crop, random_flip_horizontal, seeded_generator
from petastorm_tpu_torch.ops.image_ops import normalize_images


def train(url: str, steps: int = 30, batch_size: int = 8, classes: int = 100,
          learning_rate: float = 0.05, device: str = "cuda", workers: int = 4,
          log=print) -> dict:
    """One warm-up step, then ``steps`` timed ones. Each batch is flipped and
    cropped on its device (draws keyed by the step), normalized by K1 and
    trained on (momentum SGD). Returns the losses, samples/s, the input
    stall (the host's wait for a batch over the loop) and the loader's
    ``stall_report()``."""
    dev = torch.device(device)
    params = resnet.init_params(torch.Generator(device=dev).manual_seed(0), classes, device=dev)
    init_opt, raw_step = resnet.make_train_step(learning_rate=learning_rate)
    opt = init_opt(params)

    def step(batch, i):
        nonlocal params, opt
        gen = seeded_generator((42, i), dev)
        images = random_flip_horizontal(gen, batch["image"])
        images = random_crop(gen, images, padding=4)
        images = normalize_images(images)   # K1 on the card
        params, opt, loss, acc = raw_step(params, opt, {"image": images, "label": batch["label"]})
        return loss, acc

    with make_reader(url, num_epochs=None, shuffle_row_groups=True, seed=0,
                     workers_count=workers) as reader:
        loader = DataLoader(reader, batch_size=batch_size, prefetch=2,
                            dtype_policy=DTypePolicy(), device=dev)
        it = iter(loader)
        loss, _ = step(next(it), 0)
        loss.item()   # warm-up: the first step builds the kernels
        wait_s = compute_s = 0.0
        losses = []
        for i in range(steps):
            t0 = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            loss, acc = step(batch, i + 1)
            losses.append(loss.item())   # waits for the step
            t2 = time.perf_counter()
            wait_s += t1 - t0
            compute_s += t2 - t1
            if (i + 1) % 10 == 0:
                log(f"step {i + 1}: loss={np.mean(losses[-10:]):.3f} acc={acc.item():.3f}")
        report = loader.stall_report()
        it.close()
    total = wait_s + compute_s
    return {"losses": losses, "samples_per_sec": steps * batch_size / total,
            "input_stall_pct": 100.0 * wait_s / total, "stall_report": report}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="file://" + os.path.join(tempfile.gettempdir(),
                                                                   "imagenet_torch"))
    parser.add_argument("--rows", type=int, default=2048)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if not os.path.exists(args.url.replace("file://", "") + "/_common_metadata"):
        print("writing synthetic imagenet store...")
        write_synthetic_imagenet(args.url, args.rows, image_size=args.image_size)
    result = train(args.url, steps=args.steps, batch_size=args.batch, device=args.device)
    print(f"batch={args.batch} throughput={result['samples_per_sec']:.1f} samples/sec "
          f"input_stall={result['input_stall_pct']:.1f}%")
    losses = result["losses"]
    assert losses[-1] < losses[0] * 1.05, "loss did not trend down"


if __name__ == "__main__":
    main()
