"""Plain softmax attention: the Llama model's default attention and the
reference the flash kernel is held against."""
from __future__ import annotations

import numpy as np
import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Softmax attention on full tensors; q is (b, seq, heads, dim) and
    k/v are (b, seq, kv_heads, dim) with ``heads % kv_heads == 0`` —
    grouped-query attention runs natively (each K/V head serves
    ``heads/kv_heads`` query heads through the einsum, no repeat).

    Scores come from an einsum in the input dtype and are then cast to
    float32; the causal mask is position-based (``q_pos >= k_pos``, top-left)
    so it also holds for lq != lk."""
    b, lq, h, d = q.shape
    kv_h, lk = k.shape[2], k.shape[1]
    if h == kv_h:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    else:
        if h % kv_h:
            raise ValueError(f"heads ({h}) must be a multiple of kv_heads ({kv_h})")
        qg = q.reshape(b, lq, kv_h, h // kv_h, d)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
        scores = scores.reshape(b, h, lq, lk)
    scores = scores / float(np.sqrt(np.float32(d)))   # sqrt rounded to float32
    if causal:
        pos_q = torch.arange(lq, device=q.device)[:, None]
        pos_k = torch.arange(lk, device=q.device)[None, :]
        scores = scores.masked_fill(~(pos_q >= pos_k), float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    if h == kv_h:
        return torch.einsum("bhqk,bkhd->bqhd", w, v)
    wg = w.reshape(b, kv_h, h // kv_h, lq, lk)
    return torch.einsum("bgrqk,bkgd->bqgrd", wg, v).reshape(b, lq, h, d)
