"""MNIST MLP in PyTorch: the minimal training consumer (BASELINE config 2),
the counterpart of the JAX package's ``models/mlp.py``.

Parameters are a plain dict with the JAX package's keys, dense weights
``(in, out)``. The train step is functional like the reference's:
``train_step(params, momentum, batch)`` returns new trees.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from petastorm_tpu_torch.loader.loader import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


def init_params(generator: torch.Generator, in_dim: int = 784, hidden: int = 512,
                classes: int = 10, device="cuda") -> Params:
    """He-normal float32 weights drawn from ``generator`` (which must live on
    ``device``) and zero biases, with the JAX package's keys and shapes; the
    values differ from the JAX package's for the same seed (use
    :func:`params_from_jax` to carry its weights across)."""
    dev = resolve_device(device)

    def dense(fan_in, fan_out):
        w = torch.randn((fan_in, fan_out), generator=generator, device=dev)
        return {"w": w * math.sqrt(2.0 / fan_in), "b": torch.zeros(fan_out, device=dev)}

    return {"fc1": dense(in_dim, hidden), "fc2": dense(hidden, hidden),
            "out": dense(hidden, classes)}


def params_from_jax(tree, device="cuda") -> Params:
    """The JAX package's parameter tree (arrays as numpy) as float32 tensors
    on ``device``, same keys and layouts."""
    dev = resolve_device(device)
    return {layer: {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
                    for k, v in leaves.items()}
            for layer, leaves in tree.items()}


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (batch, 784) float32 -> logits (batch, 10)."""
    h = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    h = torch.relu(h @ params["fc2"]["w"] + params["fc2"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


def loss_fn(params: Params, batch: dict):
    """-> (mean negative log-likelihood, accuracy)."""
    logits = apply(params, batch["image"])
    labels = batch["label"].long()
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, acc


def make_train_step(learning_rate: float = 1e-3):
    """SGD with momentum, the reference's update: ``m = 0.9 m + g``, then
    ``p -= lr m``. ``train_step(params, momentum, batch) -> (params,
    momentum, loss, acc)`` returns new trees (the inputs are not written);
    start ``momentum`` at zeros shaped like ``params``."""
    def train_step(params: Params, momentum: Params, batch: dict):
        keys = [(layer, k) for layer in params for k in params[layer]]
        leaves = [params[layer][k].detach().requires_grad_(True) for layer, k in keys]
        tracked = {layer: {} for layer in params}
        for (layer, k), t in zip(keys, leaves):
            tracked[layer][k] = t
        loss, acc = loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, leaves)
        new_params = {layer: {} for layer in params}
        new_momentum = {layer: {} for layer in params}
        with torch.no_grad():
            for (layer, k), p, g in zip(keys, leaves, grads):
                m = 0.9 * momentum[layer][k] + g
                new_momentum[layer][k] = m
                new_params[layer][k] = p.detach() - learning_rate * m
        return new_params, new_momentum, loss.detach(), acc.detach()
    return train_step
