"""GQA attention: bias / softcap / sliding window / cache decode /
cross-attention.

  * grouped-query attention (n_kv_heads <= n_heads), MHA as the equal case;
  * optional QKV bias (qwen family), attention-logit softcap (gemma-2);
  * causal, sliding-window (local) and full (cross / encoder) masks;
  * decode path with a preallocated KV cache written in place.

Shapes: x (B, S, D); q (B, S, H, hd); kv (B, S, KV, hd).  Plain torch ops
that mirror the reference's ``_sdpa``: float32 scores, a -1e30 mask, a
float32 softmax, GQA by head grouping, or the bfloat16-score variant that
the mesh rules switch on (``--bf16-scores`` of the dry-run).  The
reference computes this outside any Pallas kernel, so there is no kernel
here either.  The one-device port leaves out the reference's sharding
constraints, which are the identity on one device.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch

from .layers import apply_rope, cast, dense_init_, new_param, softcap


class AttnSpec(NamedTuple):
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    use_rope: bool = True  # whisper uses learned positions instead


class Attention(torch.nn.Module):
    """The projections of one attention layer, float32 masters."""

    def __init__(self, d_model: int, spec: AttnSpec, device: torch.device):
        super().__init__()
        H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
        self.wq = new_param((d_model, H * hd), device)
        self.wk = new_param((d_model, KV * hd), device)
        self.wv = new_param((d_model, KV * hd), device)
        self.wo = new_param((H * hd, d_model), device)
        if spec.qkv_bias:
            self.bq = new_param((H * hd,), device)
            self.bk = new_param((KV * hd,), device)
            self.bv = new_param((KV * hd,), device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)

    def params(self) -> Mapping[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))


def init_attention(generator: torch.Generator, d_model: int, spec: AttnSpec,
                   device: torch.device) -> Attention:
    attn = Attention(d_model, spec, device)
    attn.init(generator)
    return attn


def project(params: Mapping[str, torch.Tensor], spec: AttnSpec,
            x: torch.Tensor, which: str) -> torch.Tensor:
    """One of the q, k, v projections of x (B, S, D), as (B, S, heads,
    hd).  Eager code computes what it is asked for: where the reference
    takes one of ``_project_qkv``'s three and leaves XLA to drop the
    others, the port asks for the one."""
    B, S, _ = x.shape
    y = x @ cast(params["w" + which])
    if spec.qkv_bias:
        y = y + cast(params["b" + which])
    heads = spec.n_heads if which == "q" else spec.n_kv_heads
    return y.reshape(B, S, heads, spec.head_dim)


def _project_qkv(params: Mapping[str, torch.Tensor], spec: AttnSpec,
                 xq: torch.Tensor, xkv: torch.Tensor):
    return (project(params, spec, xq, "q"), project(params, spec, xkv, "k"),
            project(params, spec, xkv, "v"))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], spec: AttnSpec) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,KV,hd); GQA via head grouping.

    Scores in float32 with a float32 softmax, or, when the mesh rules ask
    for it (``sharding.want_bf16_scores``), in the compute dtype with
    float32 softmax sums: the max is taken out of the gradient, as the
    reference takes it under ``stop_gradient``, and the mask is -30000,
    which bfloat16 holds."""
    from repro_torch.distributed import sharding as _shd
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd) * (hd ** -0.5)
    bf16_scores = _shd.want_bf16_scores()
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k)
    if not bf16_scores:
        logits = logits.float()
    logits = softcap(logits, spec.attn_softcap)
    if mask is not None:
        logits = torch.where(mask, logits,
                             -30000.0 if bf16_scores else -1e30)
    if bf16_scores:
        m = logits.amax(dim=-1, keepdim=True).detach()
        e = torch.exp(logits - m)
        s = e.float().sum(dim=-1, keepdim=True)
        probs = (e / s.to(e.dtype)).to(v.dtype)
    else:
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H * hd)


def causal_mask(Sq: int, Skv: int, q_offset: int = 0,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    """(1,1,1,Sq,Skv) bool; window = sliding-window size (local attention)."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None, None]


def attention(params: Mapping[str, torch.Tensor], spec: AttnSpec,
              x: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
              window: Optional[int] = None) -> torch.Tensor:
    """Full causal self-attention over x (training / prefill)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, spec, x, x)
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    mask = causal_mask(S, S, 0, window, device=x.device)
    out = _sdpa(q, k, v, mask, spec)
    return out @ cast(params["wo"])


def cross_attention(params: Mapping[str, torch.Tensor], spec: AttnSpec,
                    x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): no mask, no rope."""
    q, k, v = _project_qkv(params, spec, x, memory)
    out = _sdpa(q, k, v, None, spec)
    return out @ cast(params["wo"])


# -- decode with KV cache -----------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd)
    v: torch.Tensor
    length: int      # tokens already in the cache (a host int)

    @classmethod
    def zeros(cls, B: int, S_max: int, KV: int, hd: int,
              dtype=torch.bfloat16, device=None) -> "KVCache":
        return cls(torch.zeros((B, S_max, KV, hd), dtype=dtype, device=device),
                   torch.zeros((B, S_max, KV, hd), dtype=dtype, device=device),
                   0)


def decode_attention(params: Mapping[str, torch.Tensor], spec: AttnSpec,
                     x: torch.Tensor, cache: KVCache, *,
                     window: Optional[int] = None):
    """One-token decode: x (B, 1, D); returns (out, updated cache).

    The new K/V row is written in place into the cache's tensors at
    position ``cache.length``, in their dtype; attention runs over the
    whole cache with a validity mask.  A write past ``S_max`` raises
    ``ValueError``: the reference's ``dynamic_update_slice`` clamps the
    start and would overwrite the last slot.
    """
    B, one, _ = x.shape
    if one != 1:
        raise ValueError(f"decode takes one token a row, got {one}")
    S_max = cache.k.shape[1]
    pos = int(cache.length)
    if not 0 <= pos < S_max:
        raise ValueError(f"the KV cache holds {S_max} positions; cannot "
                         f"write position {pos}")
    q, k_new, v_new = _project_qkv(params, spec, x, x)
    if spec.use_rope:
        p = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, p, spec.rope_theta)
        k_new = apply_rope(k_new, p, spec.rope_theta)
    cache.k[:, pos] = k_new[:, 0]
    cache.v[:, pos] = v_new[:, 0]
    kpos = torch.arange(S_max, device=x.device)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    mask = valid[None, None, None, None, :]
    out = _sdpa_cached(q, cache.k, cache.v, mask, spec)
    return _out_proj(out, params["wo"]), KVCache(cache.k, cache.v, pos + 1)


def _sdpa_cached(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], spec: AttnSpec) -> torch.Tensor:
    """``_sdpa`` over cached bfloat16 K/V with the reference's dtype
    promotion: under a float32 compute dtype the scores take float32 q
    against the upcast keys, the probabilities are cast to the values'
    dtype, and the output keeps it."""
    dt = torch.promote_types(q.dtype, k.dtype)
    return _sdpa(q.to(dt), k.to(dt), v, mask, spec)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``out @ cast(wo)``, promoting the two as the reference's einsum
    does."""
    w = cast(wo)
    dt = torch.promote_types(out.dtype, w.dtype)
    return out.to(dt) @ w.to(dt)
