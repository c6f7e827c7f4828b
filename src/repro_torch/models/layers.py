"""Shared building blocks: norms, RoPE, MLPs, softcap, initialisers, loss.

Plain functions on tensors, with the reference's explicit casts: weights
are float32 masters cast to ``COMPUTE_DTYPE`` (bfloat16) where they are
used, norms, softmax statistics and the loss run in float32 and cast back.
``torch.autocast`` rounds at other places and would not give the same
numbers.  ``cast`` reads ``COMPUTE_DTYPE`` when it is called, so a caller
(a test) may switch the whole model to float32 by setting it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# -- initialisers -----------------------------------------------------------

def dense_init_(w: torch.Tensor, generator: torch.Generator,
                in_axis: int = 0) -> torch.Tensor:
    """Fill ``w`` with N(0, 1) * fan_in ** -0.5 in place."""
    fan_in = w.shape[in_axis]
    with torch.no_grad():
        return w.normal_(generator=generator).mul_(fan_in ** -0.5)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` with N(0, 1) * d ** -0.5 in place: tied-unembedding
    logits start O(1)."""
    with torch.no_grad():
        return w.normal_(generator=generator).mul_(w.shape[-1] ** -0.5)


def new_param(shape: Sequence[int], device: torch.device) -> torch.nn.Parameter:
    """A float32 master weight, zero until an ``init`` fills it."""
    return torch.nn.Parameter(torch.zeros(tuple(shape), dtype=torch.float32,
                                          device=device))


# -- norms -------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return cast(y * (1.0 + scale.float()))


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return cast(y * scale.float() + bias.float())


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)
    ang = positions[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLPs ---------------------------------------------------------------------

def gated_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (x @ Wg) * silu(x @ Wi) @ Wo — llama/qwen/gemma family."""
    h = x @ cast(params["wi"])
    g = x @ cast(params["wg"])
    h = F.silu(g.float()).to(h.dtype) * h
    return h @ cast(params["wo"])


def gelu_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Plain GELU MLP with biases — whisper family.  The reference's
    ``jax.nn.gelu`` is the tanh approximation."""
    h = x @ cast(params["wi"]) + cast(params["bi"])
    h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return h @ cast(params["wo"]) + cast(params["bo"])


class GatedMLP(torch.nn.Module):
    def __init__(self, d_model: int, d_ff: int, device: torch.device):
        super().__init__()
        self.wi = new_param((d_model, d_ff), device)
        self.wg = new_param((d_model, d_ff), device)
        self.wo = new_param((d_ff, d_model), device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wi, self.wg, self.wo):
            dense_init_(w, generator)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))


class GeluMLP(torch.nn.Module):
    def __init__(self, d_model: int, d_ff: int, device: torch.device):
        super().__init__()
        self.wi = new_param((d_model, d_ff), device)
        self.bi = new_param((d_ff,), device)
        self.wo = new_param((d_ff, d_model), device)
        self.bo = new_param((d_model,), device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wi, self.wo):
            dense_init_(w, generator)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))


# -- losses -------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE; logits (..., V), taken in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
