"""ResNet-50 in PyTorch: the ImageNet consumer, the counterpart of the JAX
package's ``models/resnet.py``.

Parameters are a plain dict with the JAX package's keys and He-normal
scales. Convolution weights are kept in PyTorch's logical OIHW order with
``torch.channels_last`` memory, and activations run as logical NCHW in
channels-last memory: a permute of a contiguous NHWC batch is exactly that,
and it is the layout cuDNN's tensor-core convolutions take without a
transpose. The convolutions are cuDNN's on the card (the reference's are
``lax.conv_general_dilated``, not Pallas kernels).

Where the reference's semantics differ from PyTorch's defaults, this module
follows the reference:

* ``"SAME"`` padding the XLA way, ``low = total // 2``, ``high = total -
  low``, which is lopsided at stride 2 (the 7x7 stem at 224 pads (2, 3), a
  3x3 stride-2 convolution at 56 pads (0, 1)); torch's ``padding="same"``
  refuses stride > 1 and a symmetric padding shifts every window. The max
  pool pads with -inf the same way.
* Batch norm normalises by the population variance and updates the moving
  statistics with it (``0.9 * old + 0.1 * new``), where ``F.batch_norm``'s
  running update would use the unbiased variance. The statistics are
  returned, not written into buffers, so the train step stays pure and a
  rematerialised block does not update them twice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.loader.loader import resolve_device

Params = Dict[str, Any]

# (blocks per stage, bottleneck mid-channels per stage)
_RESNET50_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))

_BN_MOMENTUM, _BN_EPS = 0.9, 1e-5


def init_params(generator: torch.Generator, num_classes: int = 1000, device="cuda") -> Params:
    """Random float32 parameters drawn from ``generator`` (which must live
    on ``device``), with the JAX package's keys, shapes (convolutions as
    OIHW) and scales. The values differ from the JAX package's for the same
    seed; use :func:`params_from_jax` to carry its weights across."""
    dev = resolve_device(device)

    def conv(kh, kw, cin, cout):
        w = torch.randn((cout, cin, kh, kw), generator=generator, device=dev,
                        dtype=torch.float32) * math.sqrt(2.0 / (kh * kw * cin))
        return w.contiguous(memory_format=torch.channels_last)

    def bn(c):
        return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev),
                "mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)}

    params: Params = {"stem": {"conv": conv(7, 7, 3, 64), "bn": bn(64)}}
    cin = 64
    for stage_idx, (blocks, mid) in enumerate(_RESNET50_STAGES):
        stage = []
        for block_idx in range(blocks):
            cout = mid * 4
            block = {"conv1": conv(1, 1, cin, mid), "bn1": bn(mid),
                     "conv2": conv(3, 3, mid, mid), "bn2": bn(mid),
                     "conv3": conv(1, 1, mid, cout), "bn3": bn(cout)}
            if block_idx == 0:
                block["proj"] = conv(1, 1, cin, cout)
                block["proj_bn"] = bn(cout)
            stage.append(block)
            cin = cout
        params[f"stage{stage_idx}"] = stage
    params["head"] = {"w": torch.randn((cin, num_classes), generator=generator, device=dev,
                                       dtype=torch.float32) * 0.01,
                      "b": torch.zeros(num_classes, device=dev)}
    return params


def params_from_jax(tree, device="cuda") -> Params:
    """The JAX package's parameter tree (arrays as numpy) as this module's
    parameters: the same keys, float32 tensors on ``device``, HWIO
    convolution weights as OIHW (``permute(3, 2, 0, 1)``) in channels-last
    memory; the head stays ``(in, out)``."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        t = torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return t

    return convert(tree)


def _same_padding(size: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding of one spatial dimension: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """``x`` padded as ``"SAME"`` pads it for a ``k`` x ``k`` window at
    ``stride``, and the padding still to be given symmetrically to the
    operator: a symmetric padding goes to the operator (no copy), a
    lopsided one is written out with ``F.pad``."""
    ph, pw = _same_padding(x.shape[2], k, stride), _same_padding(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    x, padding = _pad_same(x, w.shape[2], stride)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool at stride 2, ``"SAME"`` with -inf padding."""
    x, padding = _pad_same(x, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=padding)


def _batch_norm(x: torch.Tensor, bn: dict, train: bool, momentum=_BN_MOMENTUM, eps=_BN_EPS):
    """-> (batch norm of ``x`` in ``x``'s dtype, new moving statistics).
    Statistics and the affine map are float32. In training the batch's
    mean and population variance (over N, H, W) normalise, and the new
    moving statistics (detached) blend them in; the variance comes back
    from the kernel's saved ``1 / sqrt(var + eps)``."""
    if train:
        out, mean, invstd = torch.native_batch_norm(x, bn["scale"], bn["bias"], None, None,
                                                    True, 0.0, eps)
        var = invstd.detach().pow(-2) - eps
        new_stats = {"mean": momentum * bn["mean"] + (1 - momentum) * mean.detach(),
                     "var": momentum * bn["var"] + (1 - momentum) * var}
        return out, new_stats
    out = F.batch_norm(x, bn["mean"], bn["var"], bn["scale"], bn["bias"], training=False,
                       eps=eps)
    return out, {"mean": bn["mean"], "var": bn["var"]}


def _bottleneck(x: torch.Tensor, block: dict, stride: int, train: bool):
    stats = {}
    h, stats["bn1"] = _batch_norm(_conv(x, block["conv1"]), block["bn1"], train)
    h = F.relu(h)
    h, stats["bn2"] = _batch_norm(_conv(h, block["conv2"], stride), block["bn2"], train)
    h = F.relu(h)
    h, stats["bn3"] = _batch_norm(_conv(h, block["conv3"]), block["bn3"], train)
    if "proj" in block:
        shortcut, stats["proj_bn"] = _batch_norm(_conv(x, block["proj"], stride),
                                                 block["proj_bn"], train)
    else:
        shortcut = x
    return F.relu(h + shortcut), stats


def apply(params: Params, images: torch.Tensor, train: bool = False,
          compute_dtype=torch.bfloat16, remat: bool = False):
    """images: (N, H, W, 3) float32 in [0, 1] -> (logits (N, classes)
    float32, new batch-norm statistics).

    ``remat=True`` runs each bottleneck under ``torch.utils.checkpoint``
    (non-reentrant) while grad is enabled: the backward recomputes the
    block's activations instead of keeping them (the reference's
    ``jax.checkpoint``). The statistics of the recomputation are dropped."""
    x = images.to(compute_dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    new_stats: Params = {"stem": {}}
    x, new_stats["stem"]["bn"] = _batch_norm(_conv(x, params["stem"]["conv"], 2),
                                             params["stem"]["bn"], train)
    x = _max_pool(F.relu(x))
    for stage_idx, (blocks, _) in enumerate(_RESNET50_STAGES):
        stage_stats = []
        for block_idx in range(blocks):
            stride = 2 if (block_idx == 0 and stage_idx > 0) else 1
            block = params[f"stage{stage_idx}"][block_idx]
            if remat and torch.is_grad_enabled():
                x, s = checkpoint(_bottleneck, x, block, stride, train, use_reentrant=False)
            else:
                x, s = _bottleneck(x, block, stride, train)
            stage_stats.append(s)
        new_stats[f"stage{stage_idx}"] = stage_stats
    x = x.float().mean((2, 3))
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, new_stats


def merge_bn_stats(params: Params, new_stats: Params) -> Params:
    """Fold updated moving statistics back into the parameter tree: a new
    tree (the reference's is pure) sharing every other tensor."""
    def merge(p, path_stats):
        out = dict(p)
        for k, v in path_stats.items():
            if isinstance(v, dict) and "mean" in v:
                out[k] = {**p[k], **v}
            elif isinstance(v, list):
                out[k] = [merge(pb, sb) for pb, sb in zip(p[k], v)]
            elif isinstance(v, dict):
                out[k] = merge(p[k], v)
        return out
    return merge(params, new_stats)


def loss_fn(params: Params, batch: dict, train: bool = True, remat: bool = False):
    """-> (mean negative log-likelihood, (accuracy, new statistics)).
    ``batch["label"]`` holds class indices of any integer type."""
    logits, new_stats = apply(params, batch["image"], train=train, remat=remat)
    labels = batch["label"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, (acc, new_stats)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The trainable tensors of ``params`` in a fixed order: every tensor
    but the batch-norm moving statistics."""
    leaves = []

    def walk(node, key=None):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], k)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif key not in ("mean", "var"):
            leaves.append(node)

    walk(params)
    return leaves


def make_train_step(learning_rate: float = 0.1, weight_decay: float = 1e-4,
                    momentum: float = 0.9, remat: bool = False):
    """SGD with momentum and weight decay (the standard ImageNet recipe)
    -> ``(init_opt, train_step)``.

    ``init_opt(params)`` marks the trainable leaves (:func:`param_leaves`)
    as requiring grad and returns ``torch.optim.SGD(lr, momentum,
    weight_decay, dampening=0)``: ``v = momentum * v + g + weight_decay * p``
    then ``p -= lr * v``, the reference's update, whose first ``v`` (from
    zero) is the optimizer's first momentum buffer. The reference also
    decays the moving statistics and then overwrites them with the new ones
    (``merge_bn_stats``); here they are only overwritten, with the same
    result. ``train_step(params, opt, batch) -> (params, opt, loss, acc)``
    updates the trainable leaves in place and returns the tree with the new
    statistics merged in; ``loss`` and ``acc`` are detached."""
    def init_opt(params: Params) -> torch.optim.SGD:
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return torch.optim.SGD(leaves, lr=learning_rate, momentum=momentum, dampening=0.0,
                               weight_decay=weight_decay)

    def train_step(params: Params, opt: torch.optim.SGD, batch: dict):
        loss, (acc, new_stats) = loss_fn(params, batch, train=True, remat=remat)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return merge_bn_stats(params, new_stats), opt, loss.detach(), acc

    return init_opt, train_step


def resnet50_flops_per_step(batch: int, image_size: int, num_classes: int) -> float:
    """Model FLOPs of one training step on ``batch`` images of
    ``image_size`` x ``image_size``, counted from the shapes (there is no
    compiler cost model to ask): 2 x the multiply-adds of every convolution
    at its real output size (``ceil(in / stride)``, ``"SAME"``) and of the
    head, times 3 for the forward, the input gradient and the weight
    gradient. Batch norm, ReLU, pooling and the optimizer are not counted.
    Per image at 224: 4.09e9 multiply-adds, so about 24.5 GFLOP a step."""
    def out(size, stride):
        return -(-size // stride)

    s = out(image_size, 2)                       # the stem
    macs = s * s * 7 * 7 * 3 * 64
    s = out(s, 2)                                # the max pool
    cin = 64
    for stage_idx, (blocks, mid) in enumerate(_RESNET50_STAGES):
        for block_idx in range(blocks):
            stride = 2 if (block_idx == 0 and stage_idx > 0) else 1
            so = out(s, stride)
            macs += s * s * cin * mid            # conv1, 1x1
            macs += so * so * 9 * mid * mid      # conv2, 3x3 at the stride
            macs += so * so * mid * mid * 4      # conv3, 1x1
            if block_idx == 0:
                macs += so * so * cin * mid * 4  # the projection, 1x1 at the stride
            cin, s = mid * 4, so
    macs += cin * num_classes                    # the head
    return float(3 * 2 * macs * batch)
