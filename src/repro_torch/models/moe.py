"""Mixture-of-Experts with top-k routing and capacity-based sort dispatch.

Dispatch is sort/scatter based (no (T, E, C) one-hot tensor): tokens are
argsorted by expert id, positioned within their expert's buffer by a rank
subtraction, dropped past capacity, processed with one grouped product
over the expert dimension, and scattered back weighted by router probs.

Supports a parallel dense residual branch (Snowflake Arctic) / shared
expert (Llama-4) via ``dense_residual``; the layer that holds it adds it.

Bitmap hook: ``dispatch_bitmap_words`` exposes the (token x expert)
routing mask as packed words for EWAH telemetry.

Plain torch ops, as the reference computes them outside any Pallas kernel.
Two orders matter.  Ties among the router's probabilities go to the lower
expert, as ``lax.top_k`` breaks them; and where capacity drops tokens, the
reference's ``jnp.argsort`` is stable, so the port sorts with
``stable=True`` and the same tokens fall past capacity.  The reference's
expert-parallel ``moe_block_ep`` (a ``shard_map`` with ``all_to_all`` over
a device mesh) is not ported: it needs more than one card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import cast, dense_init_, new_param


class MoESpec(NamedTuple):
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # parallel dense/shared-expert branch


class MoE(torch.nn.Module):
    """The router and the stacked expert weights, float32 masters."""

    def __init__(self, d_model: int, spec: MoESpec, device: torch.device):
        super().__init__()
        E, Fd = spec.n_experts, spec.d_ff
        self.router = new_param((d_model, E), device)
        self.wi = new_param((E, d_model, Fd), device)
        self.wg = new_param((E, d_model, Fd), device)
        self.wo = new_param((E, Fd, d_model), device)

    def init(self, generator: torch.Generator) -> None:
        dense_init_(self.router, generator)
        for w in (self.wi, self.wg, self.wo):
            dense_init_(w, generator, in_axis=1)

    def params(self):
        return dict(self.named_parameters(recurse=False))


def route(params, spec: MoESpec, xf: torch.Tensor):
    """xf (T, D) -> (probs (T,k), experts (T,k), router logits)."""
    logits = (xf @ cast(params["router"])).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k takes the lower expert of a tie and torch.topk does not
    # promise to; bfloat16 router logits tie often (3 of 64 tokens over 128
    # experts), so the top k are the first k of a stable descending sort
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :spec.top_k], topi[:, :spec.top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi, logits


def moe_block(params, spec: MoESpec, x: torch.Tensor, *,
              capacity: Optional[int] = None):
    """x (B, S, D) -> (y, aux) with load-balance auxiliary loss."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    topv, topi, logits = route(params, spec, xf)
    E, k = spec.n_experts, spec.top_k
    if capacity is None:
        capacity = max(int(spec.capacity_factor * k * T / E), 1)

    # flatten (token, expert-slot) pairs and sort by expert, stably
    expert_flat = topi.reshape(-1)                          # (kT,)
    token_flat = torch.arange(T, device=x.device).repeat_interleave(k)
    weight_flat = topv.reshape(-1).to(x.dtype)              # (kT,)
    order = torch.argsort(expert_flat, stable=True)
    es, ts, ws = expert_flat[order], token_flat[order], weight_flat[order]

    # a count of fixed size E (bincount's size depends on the data, and
    # the dry-run traces this on meta tensors)
    counts = torch.zeros(E, dtype=es.dtype, device=x.device).index_add(
        0, es, torch.ones_like(es))                         # (E,)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(k * T, device=x.device) - starts[es]
    keep = pos < capacity
    pos_c = torch.clamp(pos, 0, capacity - 1)

    # gather tokens into (E, capacity, D) expert buffers
    contrib = torch.where(keep[:, None], xf[ts], 0).to(x.dtype)
    buf = torch.zeros((E, capacity, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((es, pos_c), contrib, accumulate=True)

    # grouped expert FFN (SwiGLU)
    h = torch.bmm(buf, cast(params["wi"]))
    g = torch.bmm(buf, cast(params["wg"]))
    h = F.silu(g.float()).to(h.dtype) * h
    y_e = torch.bmm(h, cast(params["wo"]))

    # scatter back, weighted
    y_tok = y_e[es, pos_c] * (ws * keep)[:, None]
    yf = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    yf = yf.index_add(0, ts, y_tok)

    # auxiliary load-balance loss (Switch-style)
    me = torch.softmax(logits, dim=-1).mean(0)              # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add(
        0, expert_flat, torch.full((k * T,), 1.0 / (k * T),
                                   device=x.device))
    aux = E * torch.sum(me * ce)
    return yf.reshape(B, S, D), aux


def dispatch_bitmap_words(topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(T, k) expert ids -> (E, ceil(T/32)) packed routing bitmaps, as
    ``int32`` bit-casts of the reference's ``uint32`` words.

    Rows of the (token x expert) boolean matrix, word-packed on the
    device.  The sums run in int64 (CPU ``uint32`` tensors have no shift)
    and are cast to the 32-bit pattern at the end.
    """
    T, k = topi.shape
    Tp = -(-T // 32) * 32
    onehot = torch.zeros((Tp, n_experts), dtype=torch.int64,
                         device=topi.device)
    onehot[torch.arange(T, device=topi.device).repeat_interleave(k),
           topi.reshape(-1).long()] = 1
    w = onehot.reshape(Tp // 32, 32, n_experts)
    weights = torch.ones(32, dtype=torch.int64, device=topi.device) \
        << torch.arange(32, device=topi.device)
    words = (w * weights[None, :, None]).sum(dim=1)         # [0, 2^32)
    return (words - ((words >> 31) << 32)).to(torch.int32).T.contiguous()
