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
* With a ``data_group`` (data parallelism: each rank holds its own rows of
  the global batch) batch norm normalises by the global batch's statistics,
  which is what the reference's ``jnp.mean``/``jnp.var`` compute under GSPMD
  over a batch sharded on ``"data"`` (:class:`CrossRankBatchNorm`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.loader.loader import resolve_device
from petastorm_tpu_torch.parallel import comm

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


class _ConvToFloat32(torch.autograd.Function):
    """A convolution of low-precision ``x`` and ``w`` whose output stays
    float32: a float32 convolution of the rounded values (exact products,
    float32 sums). XLA hands a bf16 convolution's float32 result to the
    batch norm that follows it without rounding it first (excess precision
    is on by default); rounding there instead puts the port's training
    logits 1.8x further from float32 than the reference's. The backward is
    the low-precision convolution's, as for ``F.conv2d`` in that dtype."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return F.conv2d(x.float(), w.float(), stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy.to(x.dtype), x, w, None, [ctx.stride] * 2, list(ctx.padding), [1, 1], False,
            [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """A ``"SAME"`` convolution in ``x``'s dtype -> float32 (every
    convolution here feeds a batch norm, which rounds once)."""
    x, padding = _pad_same(x, w.shape[2], stride)
    if x.dtype == torch.float32:
        return F.conv2d(x, w, stride=stride, padding=padding)
    return _ConvToFloat32.apply(x, w.to(x.dtype), stride, padding)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool at stride 2, ``"SAME"`` with -inf padding."""
    x, padding = _pad_same(x, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=padding)


def _combine_moments(moments: List[torch.Tensor]):
    """``(count, mean, M2)`` a channel over every rank's ``(3, C)`` float32
    ``[count, mean, M2]``, folded in rank order (Chan et al.'s pairwise
    update): every rank folds the same gathered values in the same order, so
    every rank holds the same bits."""
    n, mean, m2 = moments[0]
    for other in moments[1:]:
        nb, mean_b, m2_b = other
        total = n + nb
        delta = mean_b - mean
        mean = mean + delta * (nb / total)
        m2 = m2 + m2_b + delta * delta * (n * nb / total)
        n = total
    return n, mean, m2


def _channel(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over (N, C, H, W)."""
    return v[None, :, None, None]


class CrossRankBatchNorm(torch.autograd.Function):
    """Training batch norm over the global batch of a data-parallel group:
    ``apply(x, scale, bias, group, eps) -> (y, mean, var)``, ``x`` (N, C, H,
    W) this rank's rows, ``mean`` and ``var`` the global batch's float32
    mean and population variance a channel (not differentiable).

    Forward: each rank's count, mean and M2 (the sum of squared deviations,
    from ``torch.var_mean``: no float32 sum of squares, which would lose the
    variance of millions of values a channel) are gathered and folded in
    rank order (:func:`_combine_moments`); then ``y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in float32, as the reference
    computes it (``x`` is a float32 convolution output; :func:`_norm`
    rounds ``y`` once).

    Backward: with ``x^ = (x - mean) * rsqrt(var + eps)`` and the global
    count M, ``dx = (dy - sum(dy) / M - x^ * sum(dy x^) / M) * rsqrt(var +
    eps) * scale``, where both sums run over the global batch: one
    all-reduce of the two a channel. ``dscale`` and ``dbias`` are this
    rank's sums (the train step sums every gradient over the group).
    :data:`~petastorm_tpu_torch.parallel.comm.transfer_stats` counts the
    forward's gathers as ``bn_stats`` and the backward's sums as
    ``bn_grad``."""

    @staticmethod
    def forward(ctx, x, scale, bias, group, eps):
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        local = xf.numel() // xf.shape[1]
        moments = torch.stack([torch.full_like(mean, float(local)), mean, var * local])
        count, mean, m2 = _combine_moments(comm.all_gather(moments, group,
                                                           record_as="bn_stats"))
        var = m2 / count
        invstd = torch.rsqrt(var + eps)
        y = ((xf - _channel(mean)) * _channel(invstd * scale) + _channel(bias)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, invstd, count = ctx.saved_tensors
        xhat = (x.float() - _channel(mean)) * _channel(invstd)
        dyf = dy.float()
        sums = torch.stack([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        dbias, dscale = sums[0].clone(), sums[1].clone()
        comm.all_reduce_([sums], ctx.group, record_as="bn_grad")
        dx = (dyf - _channel(sums[0] / count) - xhat * _channel(sums[1] / count)) \
            * _channel(invstd * scale)
        return dx.to(x.dtype), dscale, dbias, None, None


def _global_batch_norm(x: torch.Tensor, bn: dict, train: bool, data_group,
                       momentum=_BN_MOMENTUM, eps=_BN_EPS):
    """:func:`_batch_norm` over the global batch of ``data_group``
    (:class:`CrossRankBatchNorm`) in training: the moving statistics blend
    the global statistics, so they are equal on every rank."""
    if not train:
        return _batch_norm(x, bn, train)
    out, mean, var = CrossRankBatchNorm.apply(x, bn["scale"], bn["bias"], data_group, eps)
    return out, {"mean": momentum * bn["mean"] + (1 - momentum) * mean,
                 "var": momentum * bn["var"] + (1 - momentum) * var}


def _batch_norm(x: torch.Tensor, bn: dict, train: bool, momentum=_BN_MOMENTUM, eps=_BN_EPS):
    """-> (batch norm of float32 ``x``, new moving statistics).
    Statistics and the affine map are float32 (:func:`_norm` rounds the
    result once to the compute dtype). In training the batch's mean and
    population variance (over N, H, W) normalise, and the new moving
    statistics (detached) blend them in; the variance comes back from the
    kernel's saved ``1 / sqrt(var + eps)``."""
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


def _norm(train: bool, data_group, dtype: torch.dtype):
    """A layer's batch norm ``(x, bn) -> (y, stats)`` of a float32
    convolution output, rounded once to ``dtype``: one process's, or the
    global batch's of ``data_group``."""
    def norm(x, bn):
        if data_group is None:
            out, stats = _batch_norm(x, bn, train)
        else:
            out, stats = _global_batch_norm(x, bn, train, data_group)
        return out.to(dtype), stats
    return norm


def _bottleneck(x: torch.Tensor, block: dict, stride: int, train: bool, data_group=None):
    stats = {}
    bn = _norm(train, data_group, x.dtype)
    h, stats["bn1"] = bn(_conv(x, block["conv1"]), block["bn1"])
    h = F.relu(h)
    h, stats["bn2"] = bn(_conv(h, block["conv2"], stride), block["bn2"])
    h = F.relu(h)
    h, stats["bn3"] = bn(_conv(h, block["conv3"]), block["bn3"])
    if "proj" in block:
        shortcut, stats["proj_bn"] = bn(_conv(x, block["proj"], stride), block["proj_bn"])
    else:
        shortcut = x
    return F.relu(h + shortcut), stats


def apply(params: Params, images: torch.Tensor, train: bool = False,
          compute_dtype=torch.bfloat16, remat: bool = False, data_group=None):
    """images: (N, H, W, 3) float32 in [0, 1] -> (logits (N, classes)
    float32, new batch-norm statistics).

    ``remat=True`` runs each bottleneck under ``torch.utils.checkpoint``
    (non-reentrant) while grad is enabled: the backward recomputes the
    block's activations instead of keeping them (the reference's
    ``jax.checkpoint``). The statistics of the recomputation are dropped.

    ``data_group``: a process group whose ranks each hold their own rows of
    the global batch; training batch norms then use the global batch's
    statistics (:class:`CrossRankBatchNorm`). Every rank must run the same
    layers in the same order: each batch norm is a collective, again in a
    rematerialised block's recomputation."""
    x = images.to(compute_dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    new_stats: Params = {"stem": {}}
    x, new_stats["stem"]["bn"] = _norm(train, data_group, compute_dtype)(
        _conv(x, params["stem"]["conv"], 2), params["stem"]["bn"])
    x = _max_pool(F.relu(x))
    for stage_idx, (blocks, _) in enumerate(_RESNET50_STAGES):
        stage_stats = []
        for block_idx in range(blocks):
            stride = 2 if (block_idx == 0 and stage_idx > 0) else 1
            block = params[f"stage{stage_idx}"][block_idx]
            if remat and torch.is_grad_enabled():
                x, s = checkpoint(_bottleneck, x, block, stride, train, data_group,
                                  use_reentrant=False)
            else:
                x, s = _bottleneck(x, block, stride, train, data_group)
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


def loss_fn(params: Params, batch: dict, train: bool = True, remat: bool = False,
            data_group=None):
    """-> (mean negative log-likelihood, (accuracy, new statistics)).
    ``batch["label"]`` holds class indices of any integer type.

    ``data_group``: this rank's rows are its share of the group's global
    batch. Batch norm uses the global statistics (:func:`apply`), and the
    summed loss (and accuracy) is divided by the global row count
    (all-reduced), so the ranks' losses sum to the global batch's mean: the
    mean GSPMD computes when a batch sharded over ``"data"`` meets the
    reference's step."""
    logits, new_stats = apply(params, batch["image"], train=train, remat=remat,
                              data_group=data_group)
    labels = batch["label"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])
    hits = (logits.argmax(-1) == labels).float()
    if data_group is None:
        return nll.mean(), (hits.mean(), new_stats)
    count = torch.tensor([float(labels.shape[0])], dtype=torch.float64)
    comm.all_reduce_([count], data_group)
    return nll.sum() / count.item(), (hits.sum() / count.item(), new_stats)


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
                    momentum: float = 0.9, remat: bool = False, data_group=None):
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
    statistics merged in; ``loss`` and ``acc`` are detached.

    Data parallelism: ``data_group`` goes to :func:`loss_fn`, and the
    gradients (flattened into one buffer: one all-reduce a step) and the
    loss and accuracy are summed over the group, so every rank takes the
    global batch's update and reports its loss, as ``llama``'s step does.
    The ranks then hold equal parameters and moving statistics, bit for
    bit."""
    def init_opt(params: Params) -> torch.optim.SGD:
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return torch.optim.SGD(leaves, lr=learning_rate, momentum=momentum, dampening=0.0,
                               weight_decay=weight_decay)

    def train_step(params: Params, opt: torch.optim.SGD, batch: dict):
        loss, (acc, new_stats) = loss_fn(params, batch, train=True, remat=remat,
                                         data_group=data_group)
        loss.backward()
        loss, acc = loss.detach(), acc.detach()
        if data_group is not None:
            grads = [t.grad for t in param_leaves(params)]
            flat = torch.cat([g.reshape(-1) for g in grads])
            comm.all_reduce_([flat], data_group)
            for g, summed in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(summed.view_as(g))
            totals = torch.stack([loss, acc])
            comm.all_reduce_([totals], data_group)
            loss, acc = totals[0], totals[1]
        opt.step()
        opt.zero_grad(set_to_none=True)
        return merge_bn_stats(params, new_stats), opt, loss, acc

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
