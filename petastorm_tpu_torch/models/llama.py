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
from petastorm_tpu_torch.parallel import comm
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
    # soft-mixture experts (0 = dense MLP everywhere).
    n_experts: int = 0
    moe_every: int = 2
    # "soft": every expert on every token, outputs combined by router
    # probability. "switch" (sparse top-k dispatch, with its top_k and
    # capacity settings) is not ported yet and raises.
    moe_dispatch: str = "soft"

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


def _moe_block(h: torch.Tensor, layer: dict) -> torch.Tensor:
    """Soft-mixture MoE with dense dispatch: every expert runs on every
    token and the outputs combine by router probability."""
    probs = torch.softmax(h.float() @ layer["router"], dim=-1).to(h.dtype)
    gate = F.silu(torch.einsum("bsd,edh->besh", h, layer["ew1"].to(h.dtype)))
    up = torch.einsum("bsd,edh->besh", h, layer["ew3"].to(h.dtype))
    expert_out = torch.einsum("besh,ehd->besd", gate * up, layer["ew2"].to(h.dtype))
    return torch.einsum("besd,bse->bsd", expert_out, probs)


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Embedding lookup as a one-hot contraction over the vocabulary; equal
    to the gather (every product is 0 or the embedding value)."""
    onehot = F.one_hot(tokens.long(), embed.shape[0]).to(compute_dtype)
    return onehot @ embed.to(compute_dtype)


def apply_block(layer: dict, x: torch.Tensor, cfg: LlamaConfig, attn_fn=None,
                pos_offset: int = 0):
    """One transformer block (attention + MLP/MoE residuals) -> (x, aux).
    ``aux`` is 0.0: the soft mixture has no auxiliary loss (the switch
    dispatch, which has one, is not ported). ``pos_offset``: the global
    position of x's first token."""
    hd = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    gqa_native = attn_fn is None or getattr(attn_fn, "supports_gqa", False)
    h = _rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    b, s, _ = h.shape
    q = (h @ layer["wq"].to(h.dtype)).reshape(b, s, cfg.n_heads, hd)
    k = (h @ layer["wk"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ layer["wv"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    q, k = _rope(q, cfg.rope_theta, pos_offset), _rope(k, cfg.rope_theta, pos_offset)
    if not gqa_native and rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    attn = (attn_fn or partial(dense_attention, causal=True))(q, k, v)
    attn = attn.reshape(b, s, cfg.n_heads * hd)
    x = x + attn @ layer["wo"].to(attn.dtype)
    h = _rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
    if "router" in layer:
        if cfg.moe_dispatch == "switch":
            raise NotImplementedError(
                "moe_dispatch='switch' needs the sparse top-k dispatch of "
                "petastorm_tpu/parallel/moe.py, not ported yet (ROADMAP Queue A item 8, "
                "model parallelism: MoE)")
        x = x + _moe_block(h, layer)
    else:
        gate = F.silu(h @ layer["w1"].to(h.dtype))
        up = h @ layer["w3"].to(h.dtype)
        x = x + (gate * up) @ layer["w2"].to(h.dtype)
    return x, 0.0


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
          remat_layers: bool = False, pos_offset: int = 0):
    """tokens: (batch, seq) int -> logits (batch, seq, vocab) float32 (or the
    pre-lm_head hidden states when ``return_hidden``).

    :param attn_fn: attention ``(q, k, v) -> out`` on (b, s, h, hd) tensors;
        ``None`` uses dense causal attention. Without a true
        ``supports_gqa`` attribute it gets K/V repeated to every head.
    :param embed_lookup: ``"gather"`` (default) or ``"onehot"`` (the
        contraction of :func:`_embed_lookup`; the same values)
    :param with_aux: also return the summed MoE auxiliary loss (a float32
        zero: the soft mixture has none)
    :param remat_layers: run each block under checkpointing, so that only
        the layer-boundary activations are kept for the backward, which
        recomputes each block (the long-context memory lever)
    :param pos_offset: the global position of ``tokens[:, 0]`` (RoPE), for a
        sequence-parallel rank's block of the window
    """
    if embed_lookup not in ("gather", "onehot"):
        raise ValueError(f"unknown embed_lookup {embed_lookup!r}")
    if embed_lookup == "onehot":
        x = _embed_lookup(params["embed"], tokens, compute_dtype)
    else:
        x = params["embed"].to(compute_dtype)[tokens.long()]
    for layer in params["layers"]:
        if remat_layers:
            x, _ = _checkpointed(apply_block, layer, x, cfg, attn_fn, pos_offset)
        else:
            x, _ = apply_block(layer, x, cfg, attn_fn=attn_fn, pos_offset=pos_offset)
    x = _rmsnorm(x, params["norm_out"], cfg.norm_eps)
    out = x if return_hidden else (x @ params["lm_head"].to(x.dtype)).float()
    return (out, torch.zeros((), dtype=torch.float32, device=x.device)) if with_aux else out


def _nll_per_token(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[target]`` along the last axis."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, targets.long()[..., None])[..., 0]


def _chunk_nll(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token loss of one chunk of hidden states: its lm_head logits
    (float32) exist only inside this call."""
    return _nll_per_token((x @ head.to(x.dtype)).float(), targets)


def loss_fn(params: dict, batch: dict, cfg: LlamaConfig, attn_fn=None,
            aux_weight: float = 1e-2, embed_lookup: str = "gather",
            compute_dtype=torch.bfloat16, shift: str = "split",
            xent_chunk: Optional[int] = None, remat_layers: bool = False,
            seq_group=None) -> torch.Tensor:
    """Next-token cross entropy. batch: ``{'tokens': (b, s) int}``.
    ``aux_weight`` weighs the switch MoE's auxiliary loss, which is not
    ported; the soft mixture has none, so it adds nothing yet.

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
    """
    tokens = batch["tokens"]
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
        count = torch.tensor([float(b * (min(offset + block, s_tok - 1) - offset))],
                             dtype=torch.float64)
        comm.all_reduce_([count], seq_group)
        denom = count.item()
    if xent_chunk:
        x = apply(params, inputs, cfg, attn_fn=attn_fn, embed_lookup=embed_lookup,
                  compute_dtype=compute_dtype, return_hidden=True, remat_layers=remat_layers,
                  pos_offset=offset)
        n_tok = x.shape[0] * x.shape[1]
        if n_tok % xent_chunk:
            raise ValueError(f"xent_chunk ({xent_chunk}) must divide batch*seq ({n_tok})")
        xf = x.reshape(n_tok, x.shape[-1])
        tf = targets.reshape(n_tok)
        head = params["lm_head"]
        nll_tok = torch.cat([
            _checkpointed(_chunk_nll, xf[i:i + xent_chunk], head, tf[i:i + xent_chunk])
            for i in range(0, n_tok, xent_chunk)]).reshape(x.shape[0], x.shape[1])
    else:
        logits = apply(params, inputs, cfg, attn_fn=attn_fn, embed_lookup=embed_lookup,
                       compute_dtype=compute_dtype, remat_layers=remat_layers,
                       pos_offset=offset)
        nll_tok = _nll_per_token(logits, targets)
    return (nll_tok * mask).sum() / denom


def param_leaves(params: dict) -> list:
    """Every tensor of ``params``, in a fixed order (top-level keys sorted,
    then each layer's keys sorted)."""
    leaves = []
    for key in sorted(params):
        node = params[key]
        if isinstance(node, (list, tuple)):
            leaves.extend(layer[k] for layer in node for k in sorted(layer))
        else:
            leaves.append(node)
    return leaves


def make_train_step(cfg: LlamaConfig, learning_rate: float = 3e-4, attn_fn=None,
                    embed_lookup: str = "gather", compute_dtype=torch.bfloat16,
                    shift: str = "split", xent_chunk: Optional[int] = None,
                    remat_layers: bool = False, seq_group=None):
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
    the window's loss."""
    def init_opt(params: dict) -> torch.optim.AdamW:
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.1)

    def train_step(params: dict, opt: torch.optim.AdamW, batch: dict):
        loss = loss_fn(params, batch, cfg, attn_fn=attn_fn, embed_lookup=embed_lookup,
                       compute_dtype=compute_dtype, shift=shift, xent_chunk=xent_chunk,
                       remat_layers=remat_layers, seq_group=seq_group)
        loss.backward()
        if seq_group is not None:
            comm.all_reduce_([t.grad for t in param_leaves(params)], seq_group)
        opt.step()
        opt.zero_grad(set_to_none=True)
        loss = loss.detach()
        if seq_group is not None:
            comm.all_reduce_([loss], seq_group)
        return params, opt, loss

    return init_opt, train_step
