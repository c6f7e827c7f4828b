"""Single-token decode (serve_step) with per-family caches.

Cache layouts, with the reference's keys, shapes and dtypes:
  dense/moe/vlm : k/v (n_blocks, period, B, S_max, KV, hd) + length
  ssm           : h (L, B, H, P, N) fp32, conv (L, B, K-1, C)
  hybrid        : h/conv (G, per, B, ...), rest_h/rest_conv (rest, B, ...),
                  k/v (G, B, S_max, KV, hd): one KV cache per application
                  of the shared block
  enc-dec       : decoder self k/v (L, ...) + cross xk/xv (L, B, M, KV, hd)
                  computed from the frames at prefill

``length`` is a host int.  ``serve_step`` writes each layer's new state in
place into these tensors and returns the same dict with ``length`` one
larger, where the reference returns new arrays: the cache passed in is
the cache returned.  Plain torch ops; the reference computes decode outside
any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import layers as L
from .attention import (KVCache, _out_proj, _project_qkv, _sdpa_cached,
                        decode_attention)
from .layers import cast, gated_mlp, gelu_mlp, layer_norm, rms_norm
from .ssm import SSMCache, ssm_decode
from .transformer import LM, Layer, Plan


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _conv_dtype() -> torch.dtype:
    """The conv window's dtype after a step: the reference allocates it in
    bfloat16 and its concatenation promotes it to the compute dtype, so a
    float32 compute dtype holds it in float32 from the second step on.
    Allocating it so from the start gives the same numbers (the first
    window is zeros) and lets the step write in place."""
    return torch.promote_types(torch.bfloat16, L.COMPUTE_DTYPE)


def cache_spec(model: LM, B: int, S_max: int
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each cache tensor, by key."""
    cfg = model.cfg
    s = model.attn_spec
    f32, bf16 = torch.float32, torch.bfloat16

    def kv(lead, S):
        return tuple(lead) + (B, S, s.n_kv_heads, s.head_dim), bf16

    if cfg.enc_dec:
        L_ = cfg.n_layers
        M = cfg.n_frontend_positions
        return {"k": kv((L_,), S_max), "v": kv((L_,), S_max),
                "xk": kv((L_,), M), "xv": kv((L_,), M)}
    if cfg.family in ("ssm", "hybrid"):
        sp = cfg.ssm
        state = (B, sp.n_heads, sp.head_dim, sp.state_dim)
        conv = (B, sp.d_conv - 1, sp.conv_channels)
        if cfg.family == "ssm":
            L_ = cfg.n_layers
            return {"h": ((L_,) + state, f32),
                    "conv": ((L_,) + conv, _conv_dtype())}
        per, G, rest = model.hybrid_layout
        out = {"h": ((G, per) + state, f32),
               "conv": ((G, per) + conv, _conv_dtype())}
        if rest:
            out["rest_h"] = ((rest,) + state, f32)
            out["rest_conv"] = ((rest,) + conv, _conv_dtype())
        out["k"] = kv((G,), S_max)
        out["v"] = kv((G,), S_max)
        return out
    lead = (model.n_blocks, model.period)
    return {"k": kv(lead, S_max), "v": kv(lead, S_max)}


def init_cache(model: LM, B: int, S_max: int) -> Dict[str, Any]:
    """Zeroed caches on the model's device, ``length`` 0."""
    out: Dict[str, Any] = {"length": 0}
    for key, (shape, dtype) in cache_spec(model, B, S_max).items():
        out[key] = torch.zeros(shape, dtype=dtype, device=model.device)
    return out


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def _ssm_layer(model: LM, lp: Layer, x: torch.Tensor, h: torch.Tensor,
               conv: torch.Tensor, at) -> torch.Tensor:
    """One Mamba-2 layer's decode over the state at ``h[at]``/``conv[at]``,
    which it overwrites with the new state."""
    y, new = ssm_decode(lp.ssm.params(), model.cfg.ssm, model._norm(lp, x),
                        SSMCache(h[at], conv[at]))
    h[at] = new.h
    conv[at] = new.conv
    return x + y


def _decode_layer(model: LM, lp: Layer, plan: Plan, x: torch.Tensor,
                  kv: KVCache) -> torch.Tensor:
    """One attention layer's decode over the KV cache ``kv``."""
    cfg = model.cfg
    h = model._norm(lp, x)
    a, _ = decode_attention(lp.attn.params(), model.attn_spec, h, kv,
                            window=plan.window)
    if cfg.post_norms:
        a = rms_norm(lp.ln1_post, a)
    if cfg.parallel_block:
        return x + a + gated_mlp(lp.mlp.params(), h)
    x = x + a
    h2 = model._norm(lp, x, "ln2")
    # decode: drop-free capacity (a handful of tokens; no dispatch drops)
    capacity = h2.shape[0] * cfg.moe.top_k if plan.ffn == "moe" else None
    f, _ = model._ffn(lp, plan, h2, capacity=capacity)
    return x + f


@torch.no_grad()
def serve_step(model: LM, cache: Dict[str, Any], tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, V), cache with the new position)."""
    cfg = model.cfg
    length = int(cache["length"])
    if "k" in cache and length >= cache["k"].shape[-3]:
        # before any layer writes its state, so a refused step changes
        # nothing (decode_attention raises the same for a direct call)
        raise ValueError(f"the KV cache holds {cache['k'].shape[-3]} "
                         f"positions; cannot write position {length}")
    x = model._embed_tokens(tokens)
    if cfg.learned_pos:
        x = x + cast(model.pos_dec[length])[None, None, :]
    spec = model.attn_spec

    if cfg.enc_dec:
        for l, lp in enumerate(model.dec_blocks):
            a, _ = decode_attention(
                lp.attn.params(), spec, layer_norm(lp.ln1, lp.ln1_b, x),
                KVCache(cache["k"][l], cache["v"][l], length))
            x = x + a
            h2 = layer_norm(lp.ln2, lp.ln2_b, x)
            q, _, _ = _project_qkv(lp.xattn.params(), spec, h2, h2)
            ca = _sdpa_cached(q, cache["xk"][l], cache["xv"][l], None, spec)
            x = x + _out_proj(ca, lp.xattn.wo)
            x = x + gelu_mlp(lp.mlp.params(),
                             layer_norm(lp.ln3, lp.ln3_b, x))

    elif cfg.family == "ssm":
        for l, block in enumerate(model.blocks):
            x = _ssm_layer(model, block.layers[0], x, cache["h"],
                           cache["conv"], l)

    elif cfg.family == "hybrid":
        sp = model.shared
        for g, group in enumerate(model.groups):
            for i, lp in enumerate(group):
                x = _ssm_layer(model, lp, x, cache["h"], cache["conv"],
                               (g, i))
            # shared attention block (own KV cache per application)
            a, _ = decode_attention(
                sp.attn.params(), spec, rms_norm(sp.ln1, x),
                KVCache(cache["k"][g], cache["v"][g], length))
            x = x + a
            x = x + gated_mlp(sp.mlp.params(), rms_norm(sp.ln2, x))
        for r, lp in enumerate(model.rest):
            x = _ssm_layer(model, lp, x, cache["rest_h"],
                           cache["rest_conv"], r)

    else:
        for b, block in enumerate(model.blocks):
            for i, (lp, plan) in enumerate(zip(block.layers, model.plans)):
                x = _decode_layer(model, lp, plan, x, KVCache(
                    cache["k"][b, i], cache["v"][b, i], length))

    x = model._norm(model, x, "ln_f")
    cache["length"] = length + 1
    return model._logits(x), cache


# ---------------------------------------------------------------------------
# enc-dec prefill: build the cross-attention cache from frames
# ---------------------------------------------------------------------------

@torch.no_grad()
def encdec_prefill_cross(model: LM, frames: torch.Tensor):
    """Encoder memory and each decoder layer's cross K/V, stacked
    (L, B, M, KV, hd) in bfloat16."""
    memory = model._encoder(frames)
    ks, vs = [], []
    for lp in model.dec_blocks:
        _, k, v = _project_qkv(lp.xattn.params(), model.attn_spec, memory,
                               memory)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    return torch.stack(ks), torch.stack(vs)
