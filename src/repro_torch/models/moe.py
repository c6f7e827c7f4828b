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
``stable=True`` and the same tokens fall past capacity.

``moe_block_ep`` is the reference's expert-parallel MoE: the body of its
``shard_map``, run by every rank of a ``launch.mesh.ProcessMesh`` on its own
block of tokens and its own expert shards, with the reference's two
all-to-alls, all-gather, reduce-scatter and mean taken from
``torch.distributed``'s functional collectives, whose backward is the
reverse collective.  ``ep_shards`` cuts a rank's shards out of the full
parameters by the ``opt_ep`` rules, and ``moe_block_ep_replicated`` is the
whole ``shard_map``: replicated input and parameters in, replicated output
out, every gradient whole on every rank (the model calls it; the port has
no GSPMD, so activations and parameters are replicated on every rank).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import _trace

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


# -- expert parallelism ------------------------------------------------------

# the cost counter's scopes (``kernels/_trace.py``): the body that every
# rank runs on its own block, one device's work as the reference's
# ``shard_map`` body is; and the replication around it (``_ShardIn``'s
# backward, ``_ShardOut``), which the port does in place of GSPMD's layouts
EP_SCOPE = "moe_block_ep"
REPLICATION_SCOPE = "ep_replication"


def _f_axes(mesh) -> Tuple[str, ...]:
    """The axes the tokens and the experts' FFN dimension split over: every
    axis but ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _fc():
    import torch.distributed._functional_collectives as fc
    return fc


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Row block i of ``t`` (split on dim 0) to the group's rank i; the
    result stacks the blocks received, by source rank."""
    fc = _fc()
    return fc.wait_tensor(fc.all_to_all_single_autograd(t.contiguous(), None,
                                                        None, group))


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(G * t.shape[0], ...): every rank's ``t`` of the group, by rank."""
    fc = _fc()
    gather = getattr(fc, "all_gather_single_autograd", None) \
        or fc.all_gather_tensor_autograd
    return fc.wait_tensor(gather(t.contiguous(), 0, group))


def _reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of ``t``, this rank's row block of it."""
    fc = _fc()
    scatter = getattr(fc, "reduce_scatter_single_autograd", None) \
        or fc.reduce_scatter_tensor_autograd
    return fc.wait_tensor(scatter(t.contiguous(), "sum", 0, group))


class _Mean(torch.autograd.Function):
    """The mean over every rank (the reference's ``pmean``); its backward
    is the mean of the cotangents, ``pmean``'s transpose."""

    @staticmethod
    def forward(ctx, t):
        out = t.detach().clone()
        dist.all_reduce(out)
        return out / dist.get_world_size()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g / dist.get_world_size()


def _axes(spec, d: int) -> Tuple[str, ...]:
    """The mesh axes that ``spec`` splits dimension ``d`` over, in order."""
    axes = spec[d] if d < len(spec) else None
    return () if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes))


def _block(shape: Sequence[int], spec, coord: Dict[str, int],
           sizes: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that a rank at ``coord`` holds
    under ``spec`` (one entry a dimension: None, an axis name or a tuple of
    names, split row-major over the axes)."""
    out = []
    for d, n in enumerate(shape):
        axes = _axes(spec, d)
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * sizes[a], idx * sizes[a] + coord[a]
        if n % parts:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split {parts} ways ({spec})")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _named(spec) -> set:
    """The mesh axes that ``spec`` splits a dimension over."""
    return {a for axes in spec if axes is not None
            for a in ((axes,) if isinstance(axes, str) else axes)}


def _copies(spec, mesh) -> int:
    """How many ranks hold each block: the sizes of the axes ``spec``
    leaves out, multiplied."""
    return math.prod(s for a, s in mesh.shape.items()
                     if a not in _named(spec))


def _gather_every(t: torch.Tensor, n: int) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t``, by rank (no autograd)."""
    every = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor      # the older name
    gather(every, t.contiguous().reshape(-1))
    return every.view(n, *t.shape)


def _assemble(every: torch.Tensor, spec, mesh, shape: Sequence[int], *,
              sum_copies: bool) -> torch.Tensor:
    """The whole tensor of ``shape`` from ``every`` (n, *block), every
    rank's ``_block`` by rank.  The ranks that differ only on the axes
    ``spec`` leaves out hold copies of one block: summed with
    ``sum_copies``, else the one at index 0 on those axes taken.  One
    permutation lays the blocks in place: each dimension is its axes'
    indices, row-major, then the block's own."""
    named = _named(spec)
    e = every.view(*mesh.axis_sizes, *every.shape[1:])
    copies = [i for i, a in enumerate(mesh.axis_names) if a not in named]
    if not sum_copies:
        e = e[tuple(0 if a not in named else slice(None)
                    for a in mesh.axis_names)]
    elif copies:
        e = e.sum(dim=copies)
    kept = [a for a in mesh.axis_names if a in named]      # e's lead axes
    perm = []
    for d in range(len(shape)):
        perm += [kept.index(a) for a in _axes(spec, d)] + [len(kept) + d]
    return e.permute(perm).reshape(shape)


class _ShardIn(torch.autograd.Function):
    """This rank's block of a tensor that every rank holds whole (a
    ``shard_map`` input spec).  Backward: every rank's block gradient,
    gathered and laid back in place, the copies of a block summed, so the
    gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, t, spec, mesh):
        ctx.spec, ctx.mesh, ctx.shape = spec, mesh, tuple(t.shape)
        return t[_block(t.shape, spec, mesh.coordinate(), mesh.shape)]

    @staticmethod
    @_trace.scoped(REPLICATION_SCOPE)
    def backward(ctx, g):
        mesh = ctx.mesh
        if mesh.size == 1:
            return g, None, None
        return (_assemble(_gather_every(g, mesh.size), ctx.spec, mesh,
                          ctx.shape, sum_copies=True), None, None)


class _ShardOut(torch.autograd.Function):
    """The whole tensor from every rank's block (a ``shard_map`` output
    spec): a block that several ranks hold (on the axes the spec leaves
    out) is taken from the one at index 0 on those axes.  Backward: this
    rank's block of the cotangent, which every rank holds whole, over the
    number of ranks that hold the block (as ``shard_map`` divides an
    output's cotangent over the axes its spec leaves out)."""

    @staticmethod
    @_trace.scoped(REPLICATION_SCOPE)
    def forward(ctx, t, spec, mesh, shape):
        ctx.spec, ctx.mesh = spec, mesh
        return _assemble(_gather_every(t, mesh.size), spec, mesh, shape,
                         sum_copies=False)

    @staticmethod
    @_trace.scoped(REPLICATION_SCOPE)
    def backward(ctx, g):
        mesh = ctx.mesh
        own = g[_block(g.shape, ctx.spec, mesh.coordinate(), mesh.shape)]
        return own / _copies(ctx.spec, mesh), None, None, None


def _token_spec(mesh, seq_len: int) -> tuple:
    """The reference's ``Fspec``: the batch split over the F axes, the
    sequence over ``model`` where it divides (else every model rank of an F
    row routes the same tokens)."""
    M = mesh.shape["model"]
    return (_f_axes(mesh), "model" if M > 1 and seq_len % M == 0 else None,
            None)


def ep_shards(params, mesh) -> Dict[str, torch.Tensor]:
    """This rank's shards of the full MoE parameters, as the reference's
    ``shard_map`` ``in_specs`` cut them under the ``opt_ep`` rules: the
    router replicated, ``wi`` and ``wg`` ('model', None, F), ``wo``
    ('model', F, None).  The gradient of each full parameter is whole on
    every rank."""
    F_ = _f_axes(mesh)
    specs = {"router": (None, None), "wi": ("model", None, F_),
             "wg": ("model", None, F_), "wo": ("model", F_, None)}
    return {k: _ShardIn.apply(params[k], spec, mesh)
            for k, spec in specs.items()}


@_trace.scoped(EP_SCOPE)
def moe_block_ep(params, spec: MoESpec, x_l: torch.Tensor, mesh):
    """Expert-parallel MoE, per rank: x_l (B_l, S_l, D), this rank's block
    of tokens -> (y_l, aux), with ``params`` this rank's shards
    (``ep_shards``) and ``mesh`` a ``launch.mesh.ProcessMesh``.

    Route locally, fill per-destination send buffers of ``C_send`` slots,
    all-to-all over ``model``, dispatch to this rank's ``E / M`` expert
    buffers of ``cap_loc`` slots, all-gather them over the F axes, run the
    grouped products on this rank's slice of the FFN dimension,
    reduce-scatter the partial outputs over F, all-to-all back, combine by
    the router weights.  ``aux`` is the load-balance loss's mean over all
    ranks.  ``C_send`` and ``cap_loc`` are the reference's; a send slot
    clamped past capacity marks the destination's last slot empty, as the
    reference's scatter does on the CPU, so the same tokens drop."""
    F_axes = _f_axes(mesh)
    M = mesh.shape["model"]
    E, k = spec.n_experts, spec.top_k
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} model ranks")
    E_loc = E // M
    Bl, Sl, D = x_l.shape
    Tl = Bl * Sl
    cf = spec.capacity_factor
    C_send = max(int(cf * k * Tl / M), 1)     # per-destination send slots
    cap_loc = max(int(cf * k * Tl / E_loc), 1)
    dev = x_l.device
    g_model, g_f = mesh.group(("model",)), mesh.group(F_axes)

    xf = x_l.reshape(Tl, D)
    topv, topi, logits = route(params, spec, xf)
    e_flat = topi.reshape(-1)                                # (kTl,)
    t_flat = torch.arange(Tl, device=dev).repeat_interleave(k)
    w_flat = topv.reshape(-1).to(x_l.dtype)
    m_dest = e_flat // E_loc
    e_loc = e_flat % E_loc

    # position within the destination's bucket
    slot_s = torch.argsort(m_dest, stable=True)
    md_s = m_dest[slot_s]
    counts = torch.zeros(M, dtype=md_s.dtype, device=dev).index_add(
        0, md_s, torch.ones_like(md_s))
    pos = torch.arange(k * Tl, device=dev) - (torch.cumsum(counts, 0)
                                              - counts)[md_s]
    keep = pos < C_send
    pos_c = torch.clamp(pos, 0, C_send - 1)
    payload = torch.where(keep[:, None], xf[t_flat[slot_s]], 0).to(x_l.dtype)
    send_x = torch.zeros((M, C_send, D), dtype=x_l.dtype, device=dev)
    send_x = send_x.index_put((md_s, pos_c), payload, accumulate=True)
    # int32 ids, as the reference's; a dropped entry writes to a spare
    # column (no data-dependent shapes, so this traces on meta)
    send_e = torch.full((M, C_send + 1), -1, dtype=torch.int32, device=dev)
    send_e = send_e.index_put(
        (md_s, torch.where(keep, pos, C_send)),
        e_loc[slot_s].to(torch.int32))[:, :C_send]
    # the reference sets the dropped slots' -1 at the clamped last slot,
    # after the kept one there
    send_e[:, C_send - 1] = torch.where(counts > C_send, -1,
                                        send_e[:, C_send - 1])

    # exchange: row m goes to model rank m
    rx = _all_to_all(send_x, g_model).reshape(M * C_send, D)
    re = _all_to_all(send_e, g_model).reshape(M * C_send).long()
    Tr = M * C_send

    # local dispatch to E_loc expert buffers
    valid = re >= 0
    key = torch.where(valid, re, E_loc)
    order2 = torch.argsort(key, stable=True)
    re_s = torch.where(valid, re, 0)[order2]
    counts2 = torch.zeros(E_loc + 1, dtype=key.dtype, device=dev).index_add(
        0, key, torch.ones_like(key))[:E_loc]
    pos2 = torch.arange(Tr, device=dev) - (torch.cumsum(counts2, 0)
                                           - counts2)[re_s]
    keep2 = (pos2 < cap_loc) & valid[order2]
    pos2_c = torch.clamp(pos2, 0, cap_loc - 1)
    buf = torch.zeros((E_loc, cap_loc, D), dtype=x_l.dtype, device=dev)
    buf = buf.index_put(
        (re_s, pos2_c),
        torch.where(keep2[:, None], rx[order2], 0).to(x_l.dtype),
        accumulate=True)

    # column-wide tokens: gather over F, compute this rank's F_ff slice
    Fsz = math.prod(mesh.shape[a] for a in F_axes)
    bufF = _all_gather(buf[None], g_f)                   # (F, E_loc, cap, D)
    bufF = bufF.transpose(0, 1).reshape(E_loc, Fsz * cap_loc, D)
    h = torch.bmm(bufF, cast(params["wi"]))
    g = torch.bmm(bufF, cast(params["wg"]))
    h = F.silu(g.float()).to(h.dtype) * h
    y_part = torch.bmm(h, cast(params["wo"]))            # partial over F_ff
    y_part = y_part.reshape(E_loc, Fsz, cap_loc, D).transpose(0, 1)
    y_loc = _reduce_scatter(y_part, g_f)[0]              # (E_loc, cap, D)

    # return trip: un-dispatch, reverse all-to-all, combine
    y_r = torch.zeros((Tr, D), dtype=x_l.dtype, device=dev).index_copy(
        0, order2,
        torch.where(keep2[:, None], y_loc[re_s, pos2_c], 0).to(x_l.dtype))
    back = _all_to_all(y_r.reshape(M, C_send, D), g_model)
    y_tok = torch.zeros((k * Tl, D), dtype=x_l.dtype, device=dev).index_copy(
        0, slot_s,
        torch.where(keep[:, None], back[md_s, pos_c], 0).to(x_l.dtype))
    yf = torch.zeros((Tl, D), dtype=x_l.dtype, device=dev).index_add(
        0, t_flat, y_tok * w_flat[:, None])

    # load-balance aux, its mean over every rank
    me = torch.softmax(logits, dim=-1).mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add(
        0, e_flat, torch.full((k * Tl,), 1.0 / (k * Tl), device=dev))
    aux = _Mean.apply(E * torch.sum(me * ce))
    return yf.reshape(x_l.shape), aux


def moe_block_ep_replicated(params, spec: MoESpec, x: torch.Tensor, mesh):
    """The reference's ``moe_block_ep(params, spec, x, mesh)``: x (B, S, D)
    and the full parameters, the same on every rank, -> (y, aux), the same
    on every rank.  Each rank runs ``moe_block_ep`` on its block of ``x``
    (the reference's ``Fspec``) and its shards (``ep_shards``); y is
    gathered from every rank's block.  The backward treats the output as
    one value, not one a rank: every gradient (of x and of each full
    parameter) comes out whole and the same on every rank, as ``jax.grad``
    of the reference's ``shard_map`` gives it."""
    xspec = _token_spec(mesh, x.shape[1])
    y_l, aux = moe_block_ep(ep_shards(params, mesh), spec,
                            _ShardIn.apply(x, xspec, mesh), mesh)
    return (_ShardOut.apply(y_l, xspec, mesh, tuple(x.shape)),
            _ShardOut.apply(aux, (), mesh, ()))


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
