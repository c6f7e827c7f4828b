"""Mamba-2 (SSD, state-space duality) block — chunked scan + O(1) decode.

Recurrence (per head, state (P, N)):
    h_t = exp(dt_t * A) h_{t-1} + B_t ⊗ (dt_t * x_t)
    y_t = C_t · h_t + D * x_t
Training/prefill uses the chunked SSD algorithm (arXiv:2405.21060): an
intra-chunk attention-like einsum with a causal decay matrix, then the
inter-chunk state recurrence, which the reference scans (``lax.scan``) and
the port runs as a loop over chunks.  Decode updates the recurrent state
directly.  Plain torch ops: the reference computes all of this outside any
Pallas kernel.  The dtypes are the reference's: the recurrent state is
float32, activations follow ``COMPUTE_DTYPE``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import cast, dense_init_, new_param


class SSMSpec(NamedTuple):
    d_inner: int
    state_dim: int          # N
    head_dim: int = 64      # P
    n_groups: int = 1       # G (B/C groups)
    d_conv: int = 4
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.state_dim


class SSM(torch.nn.Module):
    """The parameters of one Mamba-2 block, float32 masters."""

    def __init__(self, d_model: int, spec: SSMSpec, device: torch.device):
        super().__init__()
        H, N, G = spec.n_heads, spec.state_dim, spec.n_groups
        proj_out = 2 * spec.d_inner + 2 * G * N + H  # z, x, B, C, dt
        self.in_proj = new_param((d_model, proj_out), device)
        self.conv_w = new_param((spec.d_conv, spec.conv_channels), device)
        self.conv_b = new_param((spec.conv_channels,), device)
        self.A_log = new_param((H,), device)
        self.D = new_param((H,), device)
        self.dt_bias = new_param((H,), device)
        self.out_proj = new_param((spec.d_inner, d_model), device)

    def init(self, generator: torch.Generator) -> None:
        """The reference's ``init_ssm``: conv weights N(0, 0.1^2),
        A_log = log(1..H), D = 1, biases 0."""
        dense_init_(self.in_proj, generator)
        dense_init_(self.out_proj, generator)
        with torch.no_grad():
            self.conv_w.normal_(generator=generator).mul_(0.1)
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.arange(
                1, self.A_log.numel() + 1, dtype=torch.float32)))
            self.D.fill_(1.0)
            self.dt_bias.zero_()

    def params(self):
        return dict(self.named_parameters(recurse=False))


def _split_proj(proj: torch.Tensor, spec: SSMSpec):
    di, gn, H = spec.d_inner, spec.n_groups * spec.state_dim, spec.n_heads
    return torch.split(proj, [di, di, gn, gn, H], dim=-1)  # z, x, B, C, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: u (B,S,C), w (K,C).  Both this and the
    reference's ``conv_general_dilated`` are cross-correlations, so the
    kernel is not flipped: torch's (C, 1, K) weight is ``w.T``."""
    K, C = w.shape
    up = F.pad(u.transpose(1, 2), (K - 1, 0))
    out = F.conv1d(up, w.T[:, None, :].to(u.dtype), groups=C)
    return out.transpose(1, 2) + b.to(u.dtype)


def ssd_scan(xbar: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, spec: SSMSpec,
             h0: Optional[torch.Tensor] = None):
    """Chunked SSD.  xbar (B,S,H,P) = dt*x;  dA (B,S,H);  Bm/Cm (B,S,G,N).

    Returns (y (B,S,H,P), final state (B,H,P,N) float32)."""
    b, S, H, P = xbar.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Lc = min(spec.chunk, S)
    assert S % Lc == 0, (S, Lc)
    nc = S // Lc
    rep = H // G
    dt = xbar.dtype

    xbar_c = xbar.reshape(b, nc, Lc, H, P)
    dA_c = dA.reshape(b, nc, Lc, H)
    B_c = Bm.reshape(b, nc, Lc, G, N).repeat_interleave(rep, dim=3)
    C_c = Cm.reshape(b, nc, Lc, G, N).repeat_interleave(rep, dim=3)

    cum = torch.cumsum(dA_c, dim=2)                         # (b,nc,Lc,H)
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i>=j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,Lc,Lc,H)
    ii = torch.arange(Lc, device=xbar.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # mask BEFORE exp: exp of the (positive) non-causal diffs overflows and
    # poisons the backward pass through where (inf * 0 = nan)
    Lmat = torch.exp(torch.where(causal, diff, -1e30)).to(dt)
    CB = torch.einsum("bclhn,bcshn->bclsh", C_c, B_c)       # (b,nc,Lc,Lc,H)
    y_intra = torch.einsum("bclsh,bcshp->bclhp", CB * Lmat, xbar_c)

    # chunk state contributions: sum_j exp(cum_last - cum_j) B_j (x_j)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum).to(dt)  # (b,nc,Lc,H)
    contrib = torch.einsum("bcshn,bcshp->bchpn",
                           B_c * decay_out[..., None], xbar_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b,nc,H)

    h = h0 if h0 is not None else torch.zeros(
        (b, H, P, N), dtype=torch.float32, device=xbar.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + contrib[:, c].float()
    h_prev = torch.stack(h_prevs, dim=1)                    # (b,nc,H,P,N)

    # inter-chunk: y_i += exp(cum_i) C_i · h_prev(chunk)
    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           C_c * torch.exp(cum).to(dt)[..., None],
                           h_prev.to(dt))
    y = (y_intra + y_inter).reshape(b, S, H, P)
    return y, h


def ssm_block(params, spec: SSMSpec, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba-2 block: x (B,S,D) -> (B,S,D)."""
    Bsz, S, _ = x.shape
    H, P, N, G = spec.n_heads, spec.head_dim, spec.state_dim, spec.n_groups
    proj = x @ cast(params["in_proj"])
    z, xc, Bc, Cc, dt = _split_proj(proj, spec)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"]).float()).to(x.dtype)
    xc, Bc, Cc = torch.split(conv_out, [spec.d_inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])         # (B,S,H)
    A = -torch.exp(params["A_log"])                          # (H,)
    xh = xc.reshape(Bsz, S, H, P)
    xbar = xh * dt[..., None].to(x.dtype)
    dA = dt * A                                              # (B,S,H)
    y, _ = ssd_scan(xbar, dA, Bc.reshape(Bsz, S, G, N),
                    Cc.reshape(Bsz, S, G, N), spec)
    y = y + xh * cast(params["D"])[None, None, :, None]
    y = y.reshape(Bsz, S, spec.d_inner)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ cast(params["out_proj"])


class SSMCache(NamedTuple):
    h: torch.Tensor      # (B, H, P, N) float32 recurrent state
    conv: torch.Tensor   # (B, d_conv-1, conv_ch) rolling conv inputs

    @classmethod
    def zeros(cls, Bsz: int, spec: SSMSpec, dtype=torch.bfloat16,
              device=None) -> "SSMCache":
        return cls(torch.zeros((Bsz, spec.n_heads, spec.head_dim,
                                spec.state_dim), dtype=torch.float32,
                               device=device),
                   torch.zeros((Bsz, spec.d_conv - 1, spec.conv_channels),
                               dtype=dtype, device=device))


def ssm_decode(params, spec: SSMSpec, x: torch.Tensor, cache: SSMCache):
    """One-token decode: x (B,1,D) -> (y (B,1,D), new cache).  O(1) in seq.
    The new cache's tensors are fresh; the conv window takes the dtype the
    reference's concatenation promotes to."""
    Bsz = x.shape[0]
    H, P, N, G = spec.n_heads, spec.head_dim, spec.state_dim, spec.n_groups
    proj = (x @ cast(params["in_proj"]))[:, 0]
    z, xc, Bc, Cc, dt = _split_proj(proj, spec)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)                # (B, C)
    window = torch.cat([cache.conv, conv_in[:, None, :]], dim=1)  # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"]) + params["conv_b"]
    conv_out = F.silu(conv_out).to(x.dtype)
    xc, Bc, Cc = torch.split(conv_out, [spec.d_inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])         # (B,H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                   # (B,H)
    x_raw = xc.reshape(Bsz, H, P).float()
    xh = x_raw * dt[..., None]
    Bm = Bc.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1).float()
    Cm = Cc.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1).float()
    h = dA[:, :, None, None] * cache.h + xh[..., None] * Bm[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, Cm)
    y = y + x_raw * params["D"][None, :, None]
    y = y.reshape(Bsz, spec.d_inner).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    out = (y @ cast(params["out_proj"]))[:, None, :]
    return out, SSMCache(h, window[:, 1:, :])
