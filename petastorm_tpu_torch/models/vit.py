"""ViT-B/16 in PyTorch: the converter's consumer (BASELINE config 4), the
counterpart of the JAX package's ``models/vit.py``.

Parameters are a plain dict with the JAX package's keys and layouts: dense
weights ``(in, out)``, the patch embedding HWIO ``(patch, patch, 3, dim)``.
The embedding is the JAX package's strided ``"VALID"`` convolution written
as a patchify and one matmul (the HWIO weight flattened to
``(patch * patch * 3, dim)`` takes the patches in (row, column, channel)
order). Attention is plain matmuls and a float32 softmax, as the reference
computes it outside any Pallas kernel; the matmuls are cuBLAS's on the card.

Where PyTorch's defaults differ from the reference's, this module follows the
reference:

* GELU is the tanh approximation (``jax.nn.gelu``'s default), not torch's
  exact erf;
* layer norm runs in float32 with eps 1e-6 and the population variance, and
  casts back to the input's dtype;
* the attention scores are cast to float32 after the compute-dtype product,
  then scaled, then put through the softmax, then cast back;
* the head runs in float32 on the CLS row.

Weights stay float32 (the master copy) and are cast to ``compute_dtype`` where
each is used, so their gradients are float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.loader.loader import resolve_device

Params = Dict[str, Any]

#: ViT-B/16 (Dosovitskiy et al., "An Image is Worth 16x16 Words", ICLR 2021,
#: Table 1: "ViT-Base", 12 layers, hidden 768, MLP 3072, 12 heads, 86 M
#: parameters) at image 224 with a 1000-class head.
VIT_B16 = dict(image_size=224, patch=16, dim=768, depth=12, heads=12, mlp_dim=3072,
               num_classes=1000)

_LN_EPS = 1e-6


def init_params(generator: torch.Generator, image_size: int = 224, patch: int = 16,
                dim: int = 768, depth: int = 12, heads: int = 12, mlp_dim: int = 3072,
                num_classes: int = 1000, device="cuda") -> Params:
    """Random float32 parameters drawn from ``generator`` (which must live on
    ``device``), with the JAX package's keys, shapes and scales: He-normal
    dense weights, the patch embedding and positions at 0.02, the head at
    0.01, zero biases and CLS token. The values differ from the JAX
    package's for the same seed; use :func:`params_from_jax` to carry its
    weights across. ``heads`` shapes nothing here; pass it to :func:`apply`."""
    dev = resolve_device(device)
    n_patches = (image_size // patch) ** 2

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32) * scale

    def dense(fan_in, fan_out, scale=None):
        scale = scale if scale is not None else math.sqrt(2.0 / fan_in)
        return {"w": normal((fan_in, fan_out), scale),
                "b": torch.zeros(fan_out, device=dev)}

    def ln():
        return {"scale": torch.ones(dim, device=dev), "bias": torch.zeros(dim, device=dev)}

    params = {
        "patch_embed": {"w": normal((patch, patch, 3, dim), 0.02),
                        "b": torch.zeros(dim, device=dev)},
        "cls": torch.zeros((1, 1, dim), device=dev),
        "pos": normal((1, n_patches + 1, dim), 0.02),
        "blocks": [],
        "ln_out": ln(),
        "head": dense(dim, num_classes, scale=0.01),
    }
    for _ in range(depth):
        params["blocks"].append({
            "ln1": ln(),
            "qkv": dense(dim, 3 * dim),
            "proj": dense(dim, dim),
            "ln2": ln(),
            "mlp1": dense(dim, mlp_dim),
            "mlp2": dense(mlp_dim, dim),
        })
    return params


def params_from_jax(tree, device="cuda") -> Params:
    """The JAX package's parameter tree (arrays as numpy) as this module's
    parameters: the same keys and layouts, float32 tensors on ``device``."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

    return convert(tree)


def _layer_norm(x: torch.Tensor, p: dict, eps: float = _LN_EPS) -> torch.Tensor:
    """Float32 layer norm over the last axis (population variance)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["bias"], eps)
    return y.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _attention(x: torch.Tensor, block: dict, heads: int) -> torch.Tensor:
    b, n, d = x.shape
    hd = d // heads
    q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2)
               for t in _dense(x, block["qkv"]).split(d, dim=-1))
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, d)
    return _dense(out, block["proj"])


def _patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H//patch * W//patch, patch*patch*C): the windows
    of a stride-``patch`` ``"VALID"`` convolution, each in (row, column,
    channel) order, the order of an HWIO kernel's first three axes."""
    n, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x[:, :gh * patch, :gw * patch]
    x = x.reshape(n, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, gh * gw, patch * patch * c)


def apply(params: Params, images: torch.Tensor, patch: int = 16, heads: int = 12,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``images`` (N, H, W, 3), any float or integer type -> float32 logits
    (N, classes). ``patch`` and ``heads`` must match :func:`init_params`."""
    x = images.to(compute_dtype)
    w = params["patch_embed"]["w"]
    x = _patchify(x, patch) @ w.reshape(-1, w.shape[-1]).to(compute_dtype)
    x = x + params["patch_embed"]["b"].to(compute_dtype)
    b, _, d = x.shape
    cls = params["cls"].to(compute_dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(compute_dtype)
    for block in params["blocks"]:
        x = x + _attention(_layer_norm(x, block["ln1"]), block, heads)
        h = _gelu(_dense(_layer_norm(x, block["ln2"]), block["mlp1"]))
        x = x + _dense(h, block["mlp2"])
    x = _layer_norm(x, params["ln_out"])
    return x[:, 0].float() @ params["head"]["w"] + params["head"]["b"]


def loss_fn(params: Params, batch: dict, patch: int = 16, heads: int = 12,
            compute_dtype=torch.bfloat16):
    """-> (mean negative log-likelihood, accuracy) of ``batch["image"]``
    against ``batch["label"]`` (class indices of any integer type)."""
    logits = apply(params, batch["image"], patch=patch, heads=heads,
                   compute_dtype=compute_dtype)
    labels = batch["label"].long()
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, acc


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every tensor of ``params``, in a fixed order."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            leaves.append(node)

    walk(params)
    return leaves


def make_train_step(learning_rate: float = 0.05, patch: int = 16, heads: int = 12,
                    compute_dtype=torch.bfloat16):
    """Plain SGD, the JAX converter example's step (``p - lr * g``):
    ``train_step(params, batch) -> (params, loss, acc)`` updates the float32
    leaves in place; ``loss`` and ``acc`` are detached."""
    def train_step(params: Params, batch: dict):
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, acc = loss_fn(params, batch, patch=patch, heads=heads,
                            compute_dtype=compute_dtype)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            torch._foreach_add_(leaves, grads, alpha=-learning_rate)
        return params, loss.detach(), acc.detach()
    return train_step


def vit_flops_per_image(image_size: int = 224, patch: int = 16, dim: int = 768,
                        depth: int = 12, mlp_dim: int = 3072, num_classes: int = 1000) -> float:
    """Forward FLOPs of one image, counting a multiply-add as 2: the patch
    embedding ``2 P (p^2 3) D``, per layer the QKV, projection and MLP
    products ``2 T (3 D^2 + D^2 + 2 D M)`` and the two attention products
    ``4 T^2 D``, and the head ``2 D K`` (T = P + 1 tokens, P patches). Norms,
    softmax and GELU are left out. ViT-B/16 at 224: about 35.1 GFLOP."""
    n_patches = (image_size // patch) ** 2
    tokens = n_patches + 1
    per_layer = 2 * tokens * (4 * dim * dim + 2 * dim * mlp_dim) + 4 * tokens * tokens * dim
    return float(2 * n_patches * patch * patch * 3 * dim + depth * per_layer
                 + 2 * dim * num_classes)
