"""Llama-style decoder-only transformer: the consumer of NGram token
windows, forward and training step.

RMSNorm (float32 statistics), RoPE, grouped-query attention, SwiGLU MLP
(or a soft mixture of experts on every ``moe_every``-th layer), float32
master parameters and ``compute_dtype`` (bfloat16 by default) activations.
Parameters are a plain dict with the JAX package's key names and its
``(in, out)`` matrix layout, so :func:`params_from_jax` carries its weights
across unchanged. The functions mirror ``petastorm_tpu.models.llama``
one for one. Gradients come from autograd; through
:func:`~petastorm_tpu_torch.ops.flash_attn.make_flash_attention` the
attention's backward runs the flash backward kernels.

Sequence parallelism: under GSPMD the JAX model sees global arrays; here
each rank of a sequence process group runs its own block of the window.
:func:`loss_fn` with ``seq_group`` takes the global window, builds the
targets on it, and runs the rank's block at its global positions;
:func:`make_train_step` sums the gradients over the group before AdamW.
The attention is a ring or Ulysses ``attn_fn`` over the same group
(:mod:`petastorm_tpu_torch.parallel`).

Tensor and expert parallelism (the JAX package's ``model`` mesh axis): with
``model_group`` each rank holds its slice of every leaf that
:func:`param_shardings` splits (:func:`shard_params`): Megatron's layout,
query and kv heads, hidden units, vocabulary rows of the embedding and
columns of the head, and experts. Activations stay replicated over the
group; :func:`~petastorm_tpu_torch.parallel.comm.copy_to_group` and
:func:`~petastorm_tpu_torch.parallel.comm.reduce_from_group` bracket each
column- and row-parallel pair, the embedding is a masked lookup summed over
the group, and the cross entropy is vocabulary-parallel, so the full logits
never exist on one rank.

FSDP (ZeRO-3, the JAX package's :func:`param_shardings_fsdp`): with
``fsdp_group`` each rank of the data group also holds only its block of
every matrix (:func:`shard_params` over both axes) and of its AdamW state.
Each block is gathered whole over the group where it is used
(:func:`~petastorm_tpu_torch.parallel.comm.gather_for_use`, at
``compute_dtype``), one layer at a time, and its gradient is
reduce-scattered back into blocks inside autograd.

Pipeline parallelism: ``layers_fn`` replaces the layer loop, as in the JAX
package (:mod:`petastorm_tpu_torch.parallel.pipeline`).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.loader.loader import resolve_device
from petastorm_tpu_torch.parallel import comm, moe
from petastorm_tpu_torch.parallel.attention import dense_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # Mixture of experts: every ``moe_every``-th layer uses ``n_experts``
    # experts (0 = dense MLP everywhere), split over the model group.
    n_experts: int = 0
    moe_every: int = 2
    # "soft": every expert on every token, outputs combined by router
    # probability. "switch": top-k routing with a capacity per expert
    # (petastorm_tpu_torch.parallel.moe).
    moe_dispatch: str = "soft"
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


TINY = LlamaConfig(vocab=256, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden=128)


def _is_moe_layer(cfg: LlamaConfig, layer_idx: int) -> bool:
    return cfg.n_experts > 0 and layer_idx % cfg.moe_every == cfg.moe_every - 1


def init_params(generator: torch.Generator, cfg: LlamaConfig, device="cuda") -> dict:
    """Random float32 parameters drawn from ``generator`` (which must live
    on ``device``), with the JAX package's shapes and scales. The values
    differ from the JAX package's for the same seed; use
    :func:`params_from_jax` to carry its weights across."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)

    def mat(fan_in, fan_out):
        return normal(fan_in, fan_out) / float(np.sqrt(fan_in))

    def ones(n):
        return torch.ones(n, device=dev, dtype=torch.float32)

    params = {"embed": normal(cfg.vocab, cfg.dim) * 0.02, "layers": [],
              "norm_out": ones(cfg.dim), "lm_head": mat(cfg.dim, cfg.vocab)}
    hd = cfg.head_dim
    for li in range(cfg.n_layers):
        layer = {"attn_norm": ones(cfg.dim),
                 "wq": mat(cfg.dim, cfg.n_heads * hd),
                 "wk": mat(cfg.dim, cfg.n_kv_heads * hd),
                 "wv": mat(cfg.dim, cfg.n_kv_heads * hd),
                 "wo": mat(cfg.n_heads * hd, cfg.dim),
                 "mlp_norm": ones(cfg.dim)}
        if _is_moe_layer(cfg, li):
            e = cfg.n_experts
            layer["router"] = normal(cfg.dim, e) * 0.02
            layer["ew1"] = normal(e, cfg.dim, cfg.hidden) / float(np.sqrt(cfg.dim))
            layer["ew3"] = normal(e, cfg.dim, cfg.hidden) / float(np.sqrt(cfg.dim))
            layer["ew2"] = normal(e, cfg.hidden, cfg.dim) / float(np.sqrt(cfg.hidden))
        else:
            layer["w1"] = mat(cfg.dim, cfg.hidden)   # gate
            layer["w3"] = mat(cfg.dim, cfg.hidden)   # up
            layer["w2"] = mat(cfg.hidden, cfg.dim)   # down
        params["layers"].append(layer)
    return params


def _param_pspec_tuples(cfg: LlamaConfig, model_axis) -> dict:
    """Partition tuples per parameter, as a ``PartitionSpec``'s entries:
    Megatron's tensor-parallel layout when ``model_axis`` is an axis name,
    all replicated when None. ``()`` is replicated (norm scales, router)."""
    m = model_axis
    attention = {"attn_norm": (), "wq": (None, m), "wk": (None, m), "wv": (None, m),
                 "wo": (m, None), "mlp_norm": ()}
    dense_layer = dict(attention, w1=(None, m), w3=(None, m), w2=(m, None))
    # Expert parallelism: the leading expert axis on the model axis.
    moe_layer = dict(attention, router=(), ew1=(m, None, None), ew3=(m, None, None),
                     ew2=(m, None, None))
    return {"embed": (m, None),     # vocabulary rows
            "layers": [dict(moe_layer) if _is_moe_layer(cfg, li) else dict(dense_layer)
                       for li in range(cfg.n_layers)],
            "norm_out": (),
            "lm_head": (None, m)}   # vocabulary columns


def param_shardings(mesh, cfg: LlamaConfig, model_axis: str = "model") -> dict:
    """The tensor-parallel layout over ``mesh``'s ``model_axis``: a tree like
    :func:`init_params`' of partition tuples (``(None, "model")`` splits a
    leaf's columns over the axis). The JAX package returns ``NamedSharding``s
    for GSPMD; here a tuple says which slice of the leaf a rank holds
    (:func:`shard_params`). Raises ``ValueError`` unless the axis' size
    divides the heads, the kv heads (so query head h of a rank still meets
    kv head h // rep there), the hidden width, the vocabulary and the
    experts."""
    size = int(mesh.shape[model_axis])
    widths = {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "hidden": cfg.hidden,
              "vocab": cfg.vocab, "n_experts": cfg.n_experts}
    bad = {k: v for k, v in widths.items() if v % size}
    if bad:
        raise ValueError(f"the {model_axis!r} axis ({size} ranks) must divide {bad}")
    return _param_pspec_tuples(cfg, model_axis)


def _param_shapes(cfg: LlamaConfig) -> dict:
    """The shape of every leaf :func:`init_params` draws, as a tree like its."""
    hd, e = cfg.head_dim, cfg.n_experts
    attention = {"attn_norm": (cfg.dim,), "wq": (cfg.dim, cfg.n_heads * hd),
                 "wk": (cfg.dim, cfg.n_kv_heads * hd), "wv": (cfg.dim, cfg.n_kv_heads * hd),
                 "wo": (cfg.n_heads * hd, cfg.dim), "mlp_norm": (cfg.dim,)}
    dense_layer = dict(attention, w1=(cfg.dim, cfg.hidden), w3=(cfg.dim, cfg.hidden),
                       w2=(cfg.hidden, cfg.dim))
    moe_layer = dict(attention, router=(cfg.dim, e), ew1=(e, cfg.dim, cfg.hidden),
                     ew3=(e, cfg.dim, cfg.hidden), ew2=(e, cfg.hidden, cfg.dim))
    return {"embed": (cfg.vocab, cfg.dim),
            "layers": [moe_layer if _is_moe_layer(cfg, li) else dense_layer
                       for li in range(cfg.n_layers)],
            "norm_out": (cfg.dim,), "lm_head": (cfg.dim, cfg.vocab)}


def _fsdp_dim(spec: tuple) -> Optional[int]:
    """The dimension FSDP splits over the data axis: the first one the
    model axis leaves whole (None for ``()``, a replicated leaf)."""
    return next((i for i, axis in enumerate(spec) if axis is None), None)


def param_shardings_fsdp(mesh, cfg: LlamaConfig, data_axis: str = "data",
                         model_axis: Optional[str] = "model") -> dict:
    """The ZeRO-3 layout: :func:`param_shardings`' tuples with ``data_axis``
    in the first entry that is None, so that every matrix is also split over
    the data axis (and, with it, its gradient and AdamW state). ``()`` stays
    replicated: the norm scales and the router, as the JAX package decides
    by the tuple. ``model_axis=None``: FSDP alone (Megatron's axis left
    out). Raises ``ValueError`` where the data axis' size does not divide
    the dimension it splits (or, with ``model_axis``, where
    :func:`param_shardings` raises)."""
    if model_axis is not None:
        param_shardings(mesh, cfg, model_axis)
    size = int(mesh.shape[data_axis])
    tuples, shapes = _param_pspec_tuples(cfg, model_axis), _param_shapes(cfg)
    bad = []

    def add_data(spec, shape, name):
        dim = _fsdp_dim(spec)
        if dim is None:
            return spec
        if shape[dim] % size:
            bad.append(f"{name}{list(shape)} dim {dim}")
        return spec[:dim] + (data_axis,) + spec[dim + 1:]

    out = {key: ([{k: add_data(spec[k], shape[k], f"layers.{li}.{k}") for k in spec}
                  for li, (spec, shape) in enumerate(zip(node, shapes[key]))]
                 if isinstance(node, list) else add_data(node, shapes[key], key))
           for key, node in tuples.items()}
    if bad:
        raise ValueError(f"the {data_axis!r} axis ({size} ranks) must divide {bad}")
    return out


def _fsdp_dims(cfg: LlamaConfig, model_group) -> dict:
    """The tree of the dimension each leaf's block is gathered along under
    FSDP (None: replicated), for the layout :func:`param_shardings_fsdp`
    gives with a model axis when ``model_group`` is given, without one
    otherwise."""
    return _map_leaves(lambda spec: _fsdp_dim(spec),
                       _param_pspec_tuples(cfg, None if model_group is None else "model"))


def _map_leaves(fn, specs: dict, *trees: dict) -> dict:
    """``fn(spec, *leaves)`` over the tree of ``specs`` and each of ``trees``
    (the same structure), as a tree."""
    return {key: ([{k: fn(spec[k], *(t[key][li][k] for t in trees)) for k in spec}
                   for li, spec in enumerate(node)]
                  if isinstance(node, list) else fn(node, *(t[key] for t in trees)))
            for key, node in specs.items()}


def shard_params(params: dict, shardings: dict, mesh) -> dict:
    """This rank's slice of each leaf of the full ``params`` (from
    :func:`init_params` or :func:`params_from_jax`): a leaf split along a
    dimension over a mesh axis keeps the rank's equal block there (its index
    along the axis), as a new tensor, so the full tree can be freed."""
    def take(spec, t):
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = t.chunk(int(mesh.shape[axis]), dim=dim)[dist.get_rank(mesh.group(axis))]
        return t.clone()
    return _map_leaves(take, shardings, params)


def unshard_params(slices: list, shardings: dict, axis: Optional[str] = None) -> dict:
    """The inverse of :func:`shard_params` over one axis: ``slices[i]`` is the
    tree of the axis' rank i; each leaf split over ``axis`` is their
    concatenation along the dimension ``axis`` splits, any other leaf rank
    0's. ``axis=None``: the axis of each leaf's first split dimension (a
    layout over one axis). Over two axes (FSDP with a model axis), join over
    one axis, then over the other."""
    def join(spec, *parts):
        dims = [d for d, a in enumerate(spec) if a is not None and (axis is None or a == axis)]
        return torch.cat(parts, dim=dims[0]) if dims else parts[0]
    return _map_leaves(join, shardings, *slices)


def params_from_jax(tree, device="cuda") -> dict:
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


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * inv * scale).to(x.dtype)


def _rope(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """x: (b, s, h, d) -> rotated. Positions are global sequence indices:
    ``offset`` is the global position of x's first row (a sequence-parallel
    rank's block)."""
    _, s, _, d = x.shape
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    pos = torch.arange(offset, offset + s, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * freqs[None, :]               # (s, half)
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _moe_block(h: torch.Tensor, layer: dict, model_group=None) -> torch.Tensor:
    """Soft-mixture MoE with dense dispatch: every expert runs on every
    token and the outputs combine by router probability. Over a model group
    each rank runs its own experts and the partial sums are reduced."""
    local = layer["ew1"].shape[0]
    first = _rank(model_group) * local
    probs = torch.softmax(h.float() @ layer["router"], dim=-1)
    probs = moe.combine_weights(probs, model_group)[..., first:first + local].to(h.dtype)
    hc = comm.copy_to_group(h, model_group)
    gate = F.silu(torch.einsum("bsd,edh->besh", hc, layer["ew1"].to(h.dtype)))
    up = torch.einsum("bsd,edh->besh", hc, layer["ew3"].to(h.dtype))
    expert_out = torch.einsum("besh,ehd->besd", gate * up, layer["ew2"].to(h.dtype))
    return comm.reduce_from_group(torch.einsum("besd,bse->bsd", expert_out, probs), model_group)


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Embedding lookup as a one-hot contraction over the vocabulary; equal
    to the gather (every product is 0 or the embedding value)."""
    onehot = F.one_hot(tokens.long(), embed.shape[0]).to(compute_dtype)
    return onehot @ embed.to(compute_dtype)


def _embed(embed: torch.Tensor, tokens: torch.Tensor, compute_dtype, embed_lookup: str,
           model_group=None) -> torch.Tensor:
    """The embedding of ``tokens``. Over a model group ``embed`` holds this
    rank's rows of the vocabulary: tokens outside them look up row 0 and are
    zeroed, and the rows' sum over the group is the lookup (each token found
    on one rank)."""
    if model_group is not None:
        rows = embed.shape[0]
        local = tokens.long() - _rank(model_group) * rows
        inside = (local >= 0) & (local < rows)
        tokens = torch.where(inside, local, 0)
    if embed_lookup == "onehot":
        x = _embed_lookup(embed, tokens, compute_dtype)
    else:
        x = embed.to(compute_dtype)[tokens.long()]
    if model_group is None:
        return x
    return comm.reduce_from_group(torch.where(inside[..., None], x, 0), model_group)


def apply_block(layer: dict, x: torch.Tensor, cfg: LlamaConfig, attn_fn=None,
                pos_offset: int = 0, model_group=None, data_group=None, seq_group=None):
    """One transformer block (attention + MLP/MoE residuals) -> (x, aux).
    ``aux`` is the switch MoE's auxiliary loss (this rank's share of it
    over the data and sequence groups), 0.0 for other blocks.
    ``pos_offset``: the global position of x's first token. ``model_group``:
    the layer holds this rank's heads, hidden units or experts (see the
    module's docstring); the data and sequence groups route the switch
    MoE's tokens globally."""
    hd = cfg.head_dim
    heads, kv_heads = layer["wq"].shape[1] // hd, layer["wk"].shape[1] // hd
    rep = heads // kv_heads
    gqa_native = attn_fn is None or getattr(attn_fn, "supports_gqa", False)
    h = _rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    b, s, _ = h.shape
    hc = comm.copy_to_group(h, model_group)
    q = (hc @ layer["wq"].to(h.dtype)).reshape(b, s, heads, hd)
    k = (hc @ layer["wk"].to(h.dtype)).reshape(b, s, kv_heads, hd)
    v = (hc @ layer["wv"].to(h.dtype)).reshape(b, s, kv_heads, hd)
    q, k = _rope(q, cfg.rope_theta, pos_offset), _rope(k, cfg.rope_theta, pos_offset)
    if not gqa_native and rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    attn = (attn_fn or partial(dense_attention, causal=True))(q, k, v)
    attn = attn.reshape(b, s, heads * hd)
    x = x + comm.reduce_from_group(attn @ layer["wo"].to(attn.dtype), model_group)
    h = _rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
    aux = 0.0
    if "router" in layer and cfg.moe_dispatch == "switch":
        out, aux = moe.switch_moe_block(
            h, layer["router"], layer["ew1"], layer["ew3"], layer["ew2"], top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, data_group=data_group,
            seq_group=seq_group, expert_group=model_group)
        x = x + out
    elif "router" in layer:
        x = x + _moe_block(h, layer, model_group)
    else:
        hc = comm.copy_to_group(h, model_group)
        gate = F.silu(hc @ layer["w1"].to(h.dtype))
        up = hc @ layer["w3"].to(h.dtype)
        x = x + comm.reduce_from_group((gate * up) @ layer["w2"].to(h.dtype), model_group)
    return x, aux


def _gathered_block(layer: dict, x: torch.Tensor, cfg: LlamaConfig, attn_fn, pos_offset: int,
                    dims: dict, fsdp_group, compute_dtype, **groups):
    """:func:`apply_block` on the layer's blocks gathered whole over the
    FSDP group (each split leaf along its dimension in ``dims``, at
    ``compute_dtype``; the norm scales and the router are whole already)."""
    whole = {k: t if dims[k] is None else comm.gather_for_use(t, fsdp_group, dims[k],
                                                              compute_dtype)
             for k, t in layer.items()}
    return apply_block(whole, x, cfg, attn_fn=attn_fn, pos_offset=pos_offset, **groups)


def _whole(params: dict, key: str, dims, fsdp_group, compute_dtype) -> torch.Tensor:
    """``params[key]`` (the embedding or the head) gathered whole over the
    FSDP group, or as it is without one."""
    if dims is None:
        return params[key]
    return comm.gather_for_use(params[key], fsdp_group, dims[key], compute_dtype)


def _checkpointed(fn, *args):
    """``fn(*args)``; while grad is enabled, under
    ``torch.utils.checkpoint`` (non-reentrant): only ``args`` are kept for
    the backward, which runs ``fn`` again (the JAX package's
    ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def apply(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, attn_fn=None,
          compute_dtype=torch.bfloat16, with_aux: bool = False,
          embed_lookup: str = "gather", return_hidden: bool = False,
          remat_layers: bool = False, pos_offset: int = 0, model_group=None,
          data_group=None, seq_group=None, fsdp_group=None, layers_fn=None):
    """tokens: (batch, seq) int -> logits (batch, seq, vocab) float32 (or the
    pre-lm_head hidden states when ``return_hidden``).

    :param attn_fn: attention ``(q, k, v) -> out`` on (b, s, h, hd) tensors;
        ``None`` uses dense causal attention. Without a true
        ``supports_gqa`` attribute it gets K/V repeated to every head.
    :param embed_lookup: ``"gather"`` (default) or ``"onehot"`` (the
        contraction of :func:`_embed_lookup`; the same values)
    :param with_aux: also return the summed MoE auxiliary loss (a float32
        zero without a switch MoE layer)
    :param remat_layers: run each block under checkpointing, so that only
        the layer-boundary activations are kept for the backward, which
        recomputes each block (the long-context memory lever)
    :param pos_offset: the global position of ``tokens[:, 0]`` (RoPE), for a
        sequence-parallel rank's block of the window
    :param model_group: ``params`` is this rank's slice (:func:`shard_params`);
        the logits are then this rank's columns of the vocabulary
    :param data_group: the ranks holding other rows of the batch, and
    :param seq_group: the ranks holding other blocks of the window: the
        switch MoE routes over all their tokens, and its ``aux`` is this
        rank's share (the shares sum to the batch's)
    :param fsdp_group: the data group, over which ``params`` holds this
        rank's block of every matrix (:func:`param_shardings_fsdp` with a
        model axis when ``model_group`` is given, without one otherwise;
        :func:`shard_params`). Each layer's blocks are gathered whole at
        ``compute_dtype`` inside a checkpoint of the layer, so only one
        layer's whole matrices exist at a time, and the backward gathers
        them again (and runs the layer again) rather than keeping them. The
        embedding is gathered for its lookup, the head once a call (its copy
        is kept for the backward). The gradient of each block is summed over
        the group by the gather's backward. It also serves as
        ``data_group`` when that is None.
    :param layers_fn: ``f(params["layers"], x) -> (x, aux)`` in place of the
        layer loop: the pipeline-parallel hook (a
        :func:`~petastorm_tpu_torch.parallel.pipeline.make_pipeline` over
        :func:`apply_block`, with ``params["layers"]`` this rank's stage,
        :func:`~petastorm_tpu_torch.parallel.pipeline.stack_stage_params`).
        It owns its rematerialization, so ``remat_layers`` with it raises
        ``ValueError``; so does ``fsdp_group``, whose gathers are the
        layer loop's.
    """
    if embed_lookup not in ("gather", "onehot"):
        raise ValueError(f"unknown embed_lookup {embed_lookup!r}")
    if layers_fn is not None and remat_layers:
        raise ValueError("remat_layers applies to the sequential layer loop; a layers_fn "
                         "(pipeline parallelism) owns its own rematerialization: wrap it there "
                         "instead")
    if layers_fn is not None and fsdp_group is not None:
        raise ValueError("fsdp_group gathers the layers of the sequential layer loop; a "
                         "layers_fn (pipeline parallelism) takes its stages whole")
    data_group = _data_group(data_group, fsdp_group)
    dims = None if fsdp_group is None else _fsdp_dims(cfg, model_group)
    x = _embed(_whole(params, "embed", dims, fsdp_group, compute_dtype), tokens, compute_dtype,
               embed_lookup, model_group)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    groups = {"model_group": model_group, "data_group": data_group, "seq_group": seq_group}
    if layers_fn is not None:
        x, layers_aux = layers_fn(params["layers"], x)
        aux = aux + layers_aux
    else:
        for li, layer in enumerate(params["layers"]):
            if dims is not None:
                x, layer_aux = _checkpointed(
                    partial(_gathered_block, dims=dims["layers"][li], fsdp_group=fsdp_group,
                            compute_dtype=compute_dtype, **groups),
                    layer, x, cfg, attn_fn, pos_offset)
            elif remat_layers:
                x, layer_aux = _checkpointed(partial(apply_block, **groups), layer, x, cfg,
                                             attn_fn, pos_offset)
            else:
                x, layer_aux = apply_block(layer, x, cfg, attn_fn=attn_fn,
                                           pos_offset=pos_offset, **groups)
            aux = aux + layer_aux
    x = _rmsnorm(x, params["norm_out"], cfg.norm_eps)
    if not return_hidden:
        head = _whole(params, "lm_head", dims, fsdp_group, compute_dtype)
        x = (comm.copy_to_group(x, model_group) @ head.to(x.dtype)).float()
    return (x, aux) if with_aux else x


def _data_group(data_group, fsdp_group):
    """The data group: ``fsdp_group`` is one (its ranks hold other rows of
    the batch and other blocks of the weights)."""
    if fsdp_group is not None and data_group is not None and data_group is not fsdp_group:
        raise ValueError("fsdp_group shards the weights over the data group: pass the same "
                         "group as data_group, or leave data_group out")
    return fsdp_group if data_group is None else data_group


def _nll_per_token(logits: torch.Tensor, targets: torch.Tensor,
                   model_group=None) -> torch.Tensor:
    """``logsumexp(logits) - logits[target]`` along the last axis. Over a
    model group ``logits`` are this rank's columns of the vocabulary: the
    row max, the sum of exponentials and the target's logit are reduced over
    the group (a vocabulary-parallel cross entropy)."""
    if model_group is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    cols = logits.shape[-1]
    peak = logits.detach().amax(dim=-1)
    comm.all_reduce_([peak], model_group, record_as="tp_max", op=dist.ReduceOp.MAX)
    sum_exp = comm.reduce_from_group(torch.exp(logits - peak[..., None]).sum(dim=-1), model_group)
    local = targets.long() - _rank(model_group) * cols
    inside = (local >= 0) & (local < cols)
    target = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    target = comm.reduce_from_group(torch.where(inside, target, 0.0), model_group)
    return peak + torch.log(sum_exp) - target


def _chunk_nll(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
               model_group=None) -> torch.Tensor:
    """Per-token loss of one chunk of hidden states: its lm_head logits
    (float32) exist only inside this call."""
    return _nll_per_token((x @ head.to(x.dtype)).float(), targets, model_group)


def loss_fn(params: dict, batch: dict, cfg: LlamaConfig, attn_fn=None,
            aux_weight: float = 1e-2, embed_lookup: str = "gather",
            compute_dtype=torch.bfloat16, shift: str = "split",
            xent_chunk: Optional[int] = None, remat_layers: bool = False,
            seq_group=None, data_group=None, model_group=None, fsdp_group=None,
            layers_fn=None) -> torch.Tensor:
    """Next-token cross entropy plus ``aux_weight`` times the switch MoE's
    auxiliary loss (the soft mixture has none). batch: ``{'tokens': (b, s)
    int}``.

    ``shift="split"``: inputs ``tokens[:, :-1]``, targets ``tokens[:, 1:]``.
    ``shift="roll"``: inputs are the full window, targets
    ``roll(tokens, -1)`` with the wrapped last position left out of the
    mean. ``xent_chunk`` computes the lm_head and the log-sum-exp over that
    many tokens at a time, each chunk under checkpointing, so the
    ``(b, s, vocab)`` logits never exist at once, in the forward or the
    backward. ``remat_layers`` is :func:`apply`'s.

    ``seq_group``: a process group over which the window is split into equal
    contiguous blocks (sequence parallelism; ``shift="roll"`` only).
    ``tokens`` is then the whole window on every rank. The targets and the
    mask are built on it before the rank takes its block (the last target of
    rank r is the first token of rank r + 1), the block runs at its global
    positions, and its summed loss is divided by the number of targets over
    the group (all-reduced), so the ranks' losses sum to the loss of the
    window. ``attn_fn`` must attend over the same group.

    ``data_group``: a process group whose ranks each hold their own rows of
    the global batch (data parallelism). The summed loss is divided by the
    number of targets over the group (all-reduced), so the ranks' losses sum
    to the loss of the global batch: the mean GSPMD computes when a batch
    sharded over ``"data"`` meets the JAX step. With both groups the count
    is reduced over each. The switch MoE routes over the tokens of both
    groups, and each rank adds its share of the auxiliary loss.

    ``model_group``: ``params`` is this rank's slice (:func:`shard_params`),
    the tokens and the loss are the group's (every rank of it computes the
    same loss), and the cross entropy is vocabulary-parallel: with or
    without ``xent_chunk``, no rank holds more than its columns of the
    logits.

    ``fsdp_group`` and ``layers_fn`` are :func:`apply`'s (``fsdp_group`` is
    the data group: with ``xent_chunk`` the head is gathered once for all
    the chunks).
    """
    tokens = batch["tokens"]
    data_group = _data_group(data_group, fsdp_group)
    if shift not in ("split", "roll"):
        raise ValueError(f"unknown shift {shift!r}")
    if seq_group is not None and shift != "roll":
        raise ValueError("a sequence-parallel loss takes shift='roll' (the window must split "
                         "into equal blocks)")
    inputs = tokens if shift == "roll" else tokens[:, :-1]
    b, s_tok = tokens.shape
    if shift == "roll":
        targets = torch.roll(tokens, -1, dims=1)
        mask = (torch.arange(s_tok, device=tokens.device) < s_tok - 1).float()
        denom = (s_tok - 1) * b
    else:
        targets = tokens[:, 1:]
        mask = torch.ones(s_tok - 1, device=tokens.device)
        denom = targets.numel()
    offset = 0
    if seq_group is not None:
        size, rank = dist.get_world_size(seq_group), dist.get_rank(seq_group)
        if s_tok % size:
            raise ValueError(f"the window ({s_tok}) must split into {size} equal blocks")
        block = s_tok // size
        offset = rank * block
        inputs, targets = (t[:, offset:offset + block] for t in (inputs, targets))
        mask = mask[offset:offset + block]
        denom = b * (min(offset + block, s_tok - 1) - offset)
    groups = [g for g in (seq_group, data_group) if g is not None]
    if groups:
        count = torch.tensor([float(denom)], dtype=torch.float64)
        for group in groups:
            comm.all_reduce_([count], group)
        denom = count.item()
    run = partial(apply, params, inputs, cfg, attn_fn=attn_fn, embed_lookup=embed_lookup,
                  compute_dtype=compute_dtype, with_aux=True, remat_layers=remat_layers,
                  pos_offset=offset, model_group=model_group, data_group=data_group,
                  seq_group=seq_group, fsdp_group=fsdp_group, layers_fn=layers_fn)
    if xent_chunk:
        x, aux = run(return_hidden=True)
        n_tok = x.shape[0] * x.shape[1]
        if n_tok % xent_chunk:
            raise ValueError(f"xent_chunk ({xent_chunk}) must divide batch*seq ({n_tok})")
        xf = comm.copy_to_group(x.reshape(n_tok, x.shape[-1]), model_group)
        tf = targets.reshape(n_tok)
        head = _whole(params, "lm_head", None if fsdp_group is None else _fsdp_dims(
            cfg, model_group), fsdp_group, compute_dtype)
        nll_tok = torch.cat([
            _checkpointed(_chunk_nll, xf[i:i + xent_chunk], head, tf[i:i + xent_chunk],
                          model_group)
            for i in range(0, n_tok, xent_chunk)]).reshape(x.shape[0], x.shape[1])
    else:
        logits, aux = run()
        nll_tok = _nll_per_token(logits, targets, model_group)
    return (nll_tok * mask).sum() / denom + aux_weight * aux


def param_leaves(params: dict) -> list:
    """Every tensor of ``params``, in a fixed order (top-level keys sorted,
    then each layer's keys sorted; a pipeline stage's stacked ``layers``
    dict by its keys sorted)."""
    leaves = []
    for key in sorted(params):
        node = params[key]
        if isinstance(node, (list, tuple)):
            leaves.extend(layer[k] for layer in node for k in sorted(layer))
        elif isinstance(node, dict):
            leaves.extend(node[k] for k in sorted(node))
        else:
            leaves.append(node)
    return leaves


def make_train_step(cfg: LlamaConfig, learning_rate: float = 3e-4, attn_fn=None,
                    embed_lookup: str = "gather", compute_dtype=torch.bfloat16,
                    shift: str = "split", xent_chunk: Optional[int] = None,
                    remat_layers: bool = False, seq_group=None, data_group=None,
                    model_group=None, fsdp_group=None, layers_fn=None):
    """AdamW train step -> ``(init_opt, train_step)``, as the JAX package's.

    ``init_opt(params)`` marks every leaf of ``params`` as requiring grad
    and returns the optimizer: ``torch.optim.AdamW(learning_rate, betas=(0.9,
    0.999), eps=1e-8, weight_decay=0.1)`` over every leaf, the update
    ``optax.adamw(learning_rate, weight_decay=0.1)`` makes (decay on every
    leaf, bias correction on both moments). ``train_step(params, opt,
    batch) -> (params, opt, loss)`` takes the gradient of :func:`loss_fn`
    and updates the parameters **in place** (the returned ``params`` is the
    same dict): the step keeps one copy of the weights, not two. ``loss`` is
    the loss before the update, detached.

    Sequence parallelism: ``seq_group`` goes to :func:`loss_fn`, and every
    gradient is summed over it before AdamW, so every rank takes the same
    update from the window's gradient; ``loss`` is then summed over it too:
    the window's loss.

    Data parallelism: ``data_group`` goes to :func:`loss_fn`, and every
    gradient (and the loss) is summed over it as well, so the ranks take the
    global batch's update and report its loss; with both groups, over each
    in turn.

    Tensor and expert parallelism: ``model_group`` goes to :func:`loss_fn`,
    and ``params`` and the optimizer hold this rank's slices. Nothing is
    summed over the model group here: inside autograd the backward of each
    copy into the group sums the partial gradients of the replicated
    activations, and :func:`~petastorm_tpu_torch.parallel.moe.combine_weights`
    those of the router probabilities, so every leaf's gradient is whole
    (a replicated leaf's) or this rank's slice of the whole (a split leaf's)
    on every rank. AdamW is elementwise, so each rank's update is its slice
    of the full update.

    FSDP: ``fsdp_group`` (the data group) goes to :func:`loss_fn`, and
    ``params`` and the optimizer hold this rank's blocks, so the AdamW
    moments are sharded as the weights are. The gradient of each block is
    summed over the group inside autograd (the gather's reduce-scatter);
    only the replicated leaves (norm scales, router) are summed over the
    data group here.

    Pipeline: ``layers_fn`` goes to :func:`loss_fn`; ``params["layers"]`` is
    this rank's stage, whose gradient the pipeline's backward computed."""
    data = _data_group(data_group, fsdp_group)
    groups = [g for g in (seq_group, data) if g is not None]
    # FSDP's blocks are summed over the data group by their gathers' backward.
    replicated = None if fsdp_group is None else \
        [dim is None for dim in param_leaves(_fsdp_dims(cfg, model_group))]

    def init_opt(params: dict) -> torch.optim.AdamW:
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.1)

    def train_step(params: dict, opt: torch.optim.AdamW, batch: dict):
        loss = loss_fn(params, batch, cfg, attn_fn=attn_fn, embed_lookup=embed_lookup,
                       compute_dtype=compute_dtype, shift=shift, xent_chunk=xent_chunk,
                       remat_layers=remat_layers, seq_group=seq_group,
                       data_group=data_group, model_group=model_group,
                       fsdp_group=fsdp_group, layers_fn=layers_fn)
        loss.backward()
        grads = [t.grad for t in param_leaves(params)]
        if seq_group is not None:
            comm.all_reduce_(grads, seq_group)
        if data is not None:
            comm.all_reduce_(grads if replicated is None else
                             [g for g, whole in zip(grads, replicated) if whole], data)
        opt.step()
        opt.zero_grad(set_to_none=True)
        loss = loss.detach()
        for group in groups:
            comm.all_reduce_([loss], group)
        return params, opt, loss

    return init_opt, train_step
