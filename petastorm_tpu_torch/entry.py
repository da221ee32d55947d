"""The flagship forward: ResNet-50 on ImageNet-sized images, the
counterpart of the JAX package's ``__graft_entry__.entry()``."""
from __future__ import annotations

import numpy as np
import torch

from petastorm_tpu_torch.loader.loader import resolve_device
from petastorm_tpu_torch.models import resnet


def entry(device="cuda"):
    """-> ``(forward, (params, example_images))``: ``forward(params,
    images)`` gives the logits of ResNet-50 with 1000 classes in inference
    mode (bf16 compute), parameters drawn from a ``torch.Generator`` seeded
    0, and the reference's 8 example images,
    ``np.random.default_rng(0).random((8, 224, 224, 3))`` as float32."""
    dev = resolve_device(device)
    params = resnet.init_params(torch.Generator(device=dev).manual_seed(0), num_classes=1000,
                                device=dev)

    def forward(params, images):
        logits, _ = resnet.apply(params, images, train=False)
        return logits

    example_images = torch.from_numpy(
        np.random.default_rng(0).random((8, 224, 224, 3)).astype(np.float32)).to(dev)
    return forward, (params, example_images)
