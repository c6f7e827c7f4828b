"""The decoder LM of the dense and vlm families.

``LM`` builds, from a ModelConfig, dense / vlm decoders: GQA with optional
QKV bias, softcaps, local/global alternation, parallel blocks, sandwich
norms, LayerNorm, embedding scale, learned positions and a frontend prefix
(vlm patch embeddings) concatenated before the text.

The reference stacks each parameter over the blocks and scans them
(``lax.scan``); here every block is a module of an ``nn.ModuleList``, run in
a Python loop.  The reference's activation checkpointing is a memory
policy: the port keeps every activation, which the slice's shapes afford.
The sharding constraints of the reference are the identity on one device
and are left out.

Parameters are float32 masters named like the reference's tree
(``blocks.<b>.layers.<i>.attn.wq`` for block b of the stacked leaf
``blocks/layers/i/attn/wq``).  ``LM.params()`` lists them in the
reference's leaf order, with a stacked leaf's blocks one after the other,
so a flat vector of them matches the reference's element for element.
``params_from_numpy`` carries a reference parameter tree across.

The moe, ssm and hybrid families and the encoder-decoder raise
``NotImplementedError``: they are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

from . import layers as L
from .attention import Attention, AttnSpec, attention
from .layers import (GatedMLP, cast, cross_entropy, embed_init_, dense_init_,
                     gated_mlp, layer_norm, new_param, rms_norm, softcap)

Params = Dict[str, torch.Tensor]


class Plan(NamedTuple):
    kind: str                 # 'attn' | 'ssm'
    ffn: str = "mlp"          # 'mlp' | 'moe' | 'none'
    window: Optional[int] = None


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in repro_torch yet: it is ported with ROADMAP "
        f"Queue 1 item 13 (the rest of the LM substrate)")


class Layer(torch.nn.Module):
    """One ``Plan("attn", "mlp", window)`` layer: norms, attention, MLP."""

    def __init__(self, cfg, spec: AttnSpec, device: torch.device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = new_param((d,), device)
        if cfg.norm == "layer":
            self.ln1_b = new_param((d,), device)
        self.attn = Attention(d, spec, device)
        if cfg.post_norms:
            self.ln1_post = new_param((d,), device)
        self.mlp = GatedMLP(d, cfg.d_ff, device)
        if cfg.parallel_block:
            return
        self.ln2 = new_param((d,), device)
        if cfg.norm == "layer":
            self.ln2_b = new_param((d,), device)
        if cfg.post_norms:
            self.ln2_post = new_param((d,), device)

    def init(self, generator: torch.Generator) -> None:
        self.attn.init(generator)
        self.mlp.init(generator)


class Block(torch.nn.Module):
    """One period of layers: the unit the reference stacks and scans."""

    def __init__(self, cfg, spec: AttnSpec, n_layers: int,
                 device: torch.device):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            Layer(cfg, spec, device) for _ in range(n_layers))


def reference_order(name: str) -> Tuple:
    """Sort key that puts parameter names in the reference's leaf order:
    dict keys sorted, list indices in order, and the blocks of one stacked
    leaf one after the other."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts)
    # blocks.<b>.layers.<i>.<rest> -> (blocks, layers, i, *rest, b)
    return ("blocks", parts[2], int(parts[3]), *parts[4:], int(parts[1]))


class LM(torch.nn.Module):
    def __init__(self, cfg, device="cuda"):
        super().__init__()
        if cfg.family in ("moe", "ssm", "hybrid") or cfg.moe is not None \
                or cfg.ssm is not None:
            raise _not_ported(f"the {cfg.family} family ({cfg.name})")
        if cfg.enc_dec:
            raise _not_ported(f"the encoder-decoder ({cfg.name})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.attn_spec = AttnSpec(
            n_heads=cfg.n_heads or 1,
            n_kv_heads=cfg.n_kv_heads or (cfg.n_heads or 1),
            head_dim=cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias,
            attn_softcap=cfg.attn_softcap,
            rope_theta=cfg.rope_theta,
            use_rope=not cfg.learned_pos,
        )
        self.plans = self._layer_plans()
        dev, d = self.device, cfg.d_model
        self.embed = new_param((cfg.vocab, d), dev)
        self.ln_f = new_param((d,), dev)
        if cfg.norm == "layer":
            self.ln_f_b = new_param((d,), dev)
        if not cfg.tie_embeddings:
            self.unembed = new_param((d, cfg.vocab), dev)
        self.blocks = torch.nn.ModuleList(
            Block(cfg, self.attn_spec, self.period, dev)
            for _ in range(self.n_blocks))
        if cfg.learned_pos:
            self.pos_dec = new_param((cfg.max_positions, d), dev)

    def _layer_plans(self):
        cfg = self.cfg
        if cfg.local_global_period:
            return [Plan("attn", "mlp", cfg.sliding_window),
                    Plan("attn", "mlp", None)]
        return [Plan("attn", "mlp", cfg.sliding_window)]

    @property
    def period(self) -> int:
        return len(self.plans)

    @property
    def n_blocks(self) -> int:
        if self.cfg.n_layers % self.period:
            raise ValueError(f"n_layers {self.cfg.n_layers} is not a "
                             f"multiple of the period {self.period}")
        return self.cfg.n_layers // self.period

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Draw fresh weights from ``generator`` (on the model's device)
        into the model's parameters; returns ``params()``.  Norm scales and
        biases start at zero, as in the reference."""
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
        embed_init_(self.embed, generator)
        if not self.cfg.tie_embeddings:
            dense_init_(self.unembed, generator)
        for block in self.blocks:
            for layer in block.layers:
                layer.init(generator)
        if self.cfg.learned_pos:
            embed_init_(self.pos_dec, generator)
        return self.params()

    def params(self) -> Params:
        """The parameters by name, in the reference's leaf order."""
        named = dict(self.named_parameters())
        return {k: named[k] for k in sorted(named, key=reference_order)}

    def load_params(self, params: Mapping[str, torch.Tensor]) -> Params:
        """Copy ``params`` (every parameter, by name) into the model's own
        parameters; returns ``params()``."""
        own = self.params()
        if set(params) != set(own):
            missing = sorted(set(own) - set(params))
            extra = sorted(set(params) - set(own))
            raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                           f"unexpected {extra[:5]}")
        with torch.no_grad():
            for k, p in own.items():
                if tuple(params[k].shape) != tuple(p.shape):
                    raise ValueError(f"{k}: shape {tuple(params[k].shape)}, "
                                     f"expected {tuple(p.shape)}")
                p.copy_(params[k])
        return own

    # ------------------------------------------------------------------
    # norms / embeds / logits
    # ------------------------------------------------------------------
    def _norm(self, p: torch.nn.Module, x: torch.Tensor,
              name: str = "ln1") -> torch.Tensor:
        if self.cfg.norm == "layer":
            return layer_norm(getattr(p, name), getattr(p, name + "_b"), x)
        return rms_norm(getattr(p, name), x)

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = cast(self.embed)[tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5,
                                 dtype=L.COMPUTE_DTYPE, device=x.device)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            logits = x @ cast(self.embed).T
        else:
            logits = x @ cast(self.unembed)
        return softcap(logits, self.cfg.logit_softcap)

    # ------------------------------------------------------------------
    # layers — full-sequence path
    # ------------------------------------------------------------------
    def _apply_layer(self, lp: Layer, plan: Plan,
                     x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self._norm(lp, x)
        a = attention(lp.attn.params(), self.attn_spec, h,
                      window=plan.window)
        if cfg.post_norms:
            a = rms_norm(lp.ln1_post, a)
        if cfg.parallel_block:
            return x + a + gated_mlp(lp.mlp.params(), h)
        x = x + a
        f = gated_mlp(lp.mlp.params(), self._norm(lp, x, "ln2"))
        if cfg.post_norms:
            f = rms_norm(lp.ln2_post, f)
        return x + f

    # ------------------------------------------------------------------
    # public: forward / loss
    # ------------------------------------------------------------------
    def forward(self, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, float]:
        """batch: {'tokens': (B, S_text), optional 'frontend': (B, P, D)}.

        Returns (logits over the *text* positions (B, S_text, V), aux);
        aux, the MoE load-balance loss, is 0.0 for these families."""
        cfg = self.cfg
        tok = self._embed_tokens(batch["tokens"])
        P_front = 0
        if cfg.n_frontend_positions and "frontend" in batch:
            front = cast(batch["frontend"])
            x = torch.cat([front, tok], dim=1)
            P_front = front.shape[1]
        else:
            x = tok
        if cfg.learned_pos:
            x = x + cast(self.pos_dec)[: x.shape[1]][None]
        for block in self.blocks:
            for lp, plan in zip(block.layers, self.plans):
                x = self._apply_layer(lp, plan, x)
        x = self._norm(self, x, "ln_f")
        return self._logits(x[:, P_front:]), 0.0

    def loss(self, batch: Mapping[str, torch.Tensor],
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        """Mean next-token cross-entropy (+ 0.01 * aux).  With ``params``
        the model runs on those tensors in place of its own
        (``torch.func.functional_call``), as the reference's
        ``loss(params, batch)`` does."""
        if params is None:
            logits, aux = self(batch)
        else:
            logits, aux = torch.func.functional_call(self, dict(params),
                                                     (batch,))
        tokens = batch["tokens"]
        ce = cross_entropy(logits[:, :-1], tokens[:, 1:])
        return ce + 0.01 * aux


def params_from_numpy(cfg, tree: Mapping[str, Any],
                      device="cuda") -> Params:
    """The reference's parameter tree (nested dicts and lists of NumPy
    arrays; leaves under ``blocks`` stacked with a leading ``n_blocks``
    dimension) as the port's parameters, by name, in the reference's leaf
    order, as float32 tensors on ``device`` (``"cuda"`` by default; raises
    without CUDA).  ``cfg`` names the architecture the tree belongs to."""
    device = resolve_device(device)
    embed_shape = tuple(np.shape(tree["embed"]))
    if embed_shape != (cfg.vocab, cfg.d_model):
        raise ValueError(f"the tree's embed is {embed_shape}, {cfg.name} "
                         f"needs {(cfg.vocab, cfg.d_model)}")
    out: Params = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(prefix + (str(k),), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + (str(i),), v)
        else:
            arr = np.asarray(node, dtype=np.float32)
            if prefix[0] == "blocks":
                for b in range(arr.shape[0]):
                    name = ".".join(("blocks", str(b)) + prefix[1:])
                    out[name] = torch.tensor(arr[b], device=device)
            else:
                out[".".join(prefix)] = torch.tensor(arr, device=device)

    walk((), tree)
    return {k: out[k] for k in sorted(out, key=reference_order)}
