"""Unified LM covering all ten architectures' families.

One ``LM`` class builds, from a ModelConfig:
  * dense / vlm decoders (GQA, bias, softcaps, local/global alternation,
    parallel blocks, sandwich norms, LayerNorm, embedding scale, learned
    positions, a frontend prefix of vlm patch embeddings);
  * MoE decoders (every layer or every ``moe_period``-th layer, optional
    dense-residual / shared-expert branch);
  * attention-free SSM stacks (Mamba-2 SSD);
  * hybrid stacks (Mamba-2 backbone + shared attention block — Zamba-2);
  * encoder-decoder (whisper) with stub frame embeddings.

The reference stacks each parameter over the blocks and scans them
(``lax.scan``); here every block is a module of an ``nn.ModuleList``, run in
a Python loop.  Activation checkpointing follows ``cfg.remat`` and
``cfg.remat_policy`` at the reference's four places (each block, each
hybrid group with its shared block, each encoder and each decoder layer):
``"full"`` recomputes the region's forward in the backward, ``"dots_nb"``
saves the weight products (``aten.mm``/``addmm``, no batch dimension) and
recomputes the rest, ``"none"`` keeps every activation.  The sharding
constraints of the reference are the identity on one device and are left
out.  Its expert-parallel MoE runs where the reference's does: under the
``opt_ep`` variant with a process-group mesh installed
(``sharding.use_mesh_rules``), each MoE layer calls
``moe.moe_block_ep_replicated``.

Parameters are float32 masters named like the reference's tree, with a
stacked leaf's index after the stack's name: ``blocks.<b>.layers.<i>.attn.wq``
for block b of ``blocks/layers/i/attn/wq``, ``groups.<g>.<i>.ssm.in_proj``
for the hybrid's (G, per)-stacked ``groups/ssm/in_proj``, and
``rest.<r>.…``, ``enc_blocks.<l>.…``, ``dec_blocks.<l>.…``.  ``LM.params()``
lists them in the reference's leaf order, with a stacked leaf's entries one
after the other, so a flat vector of them matches the reference's element
for element.  ``params_from_numpy`` carries a reference parameter tree
across.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.kernels.ops import resolve_device

from . import layers as L
from .attention import Attention, AttnSpec, attention, cross_attention
from .layers import (GatedMLP, GeluMLP, cast, cross_entropy, embed_init_,
                     dense_init_, gated_mlp, gelu_mlp, layer_norm, new_param,
                     rms_norm, softcap)
from .moe import MoE, moe_block, moe_block_ep_replicated
from .ssm import SSM, ssm_block

Params = Dict[str, torch.Tensor]


class Plan(NamedTuple):
    kind: str                 # 'attn' | 'ssm'
    ffn: str = "mlp"          # 'mlp' | 'moe' | 'none'
    window: Optional[int] = None


SSM_PLAN = Plan("ssm", "none")
# leading stacked dimensions of each stacked subtree of the reference
_STACKED = {"blocks": 1, "groups": 2, "rest": 1, "enc_blocks": 1,
            "dec_blocks": 1}
# the scales that ``_norm`` and the encoder-decoder pass to ``layer_norm``
# when cfg.norm == "layer"
_LAYER_NORM_SCALES = ("ln1", "ln2", "ln3", "ln_f", "ln_enc")


class Layer(torch.nn.Module):
    """One layer of a plan: its norms, then a Mamba-2 block, or attention
    and its feed-forward (MLP, MoE with an optional dense residual, or the
    whisper GELU MLP).  ``cross`` adds the decoder's cross-attention."""

    def __init__(self, cfg, spec: AttnSpec, plan: Plan, device: torch.device,
                 cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = new_param((d,), device)
        if cfg.norm == "layer":
            self.ln1_b = new_param((d,), device)
        if plan.kind == "ssm":
            self.ssm = SSM(d, cfg.ssm, device)
            return
        self.attn = Attention(d, spec, device)
        if cfg.post_norms:
            self.ln1_post = new_param((d,), device)
        if cfg.parallel_block:
            self.mlp = GatedMLP(d, cfg.d_ff, device)
            return
        self.ln2 = new_param((d,), device)
        if cfg.norm == "layer":
            self.ln2_b = new_param((d,), device)
        if plan.ffn == "moe":
            self.moe = MoE(d, cfg.moe, device)
            if cfg.moe.dense_residual:
                self.mlp = GatedMLP(d, cfg.d_ff, device)
        elif cfg.norm == "layer" and cfg.enc_dec:
            self.mlp = GeluMLP(d, cfg.d_ff, device)
        else:
            self.mlp = GatedMLP(d, cfg.d_ff, device)
        if cfg.post_norms:
            self.ln2_post = new_param((d,), device)
        if cross:
            self.xattn = Attention(d, spec, device)
            self.ln3 = new_param((d,), device)
            self.ln3_b = new_param((d,), device)


class Block(torch.nn.Module):
    """One period of layers: the unit the reference stacks and scans."""

    def __init__(self, cfg, spec: AttnSpec, plans, device: torch.device):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            Layer(cfg, spec, plan, device) for plan in plans)


class SharedBlock(torch.nn.Module):
    """The hybrid's shared attention block, applied after every group."""

    def __init__(self, cfg, spec: AttnSpec, device: torch.device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = new_param((d,), device)
        self.attn = Attention(d, spec, device)
        self.ln2 = new_param((d,), device)
        self.mlp = GatedMLP(d, cfg.d_ff, device)


def _save_weight_products(ctx, op, *args, **kwargs):
    """The ``dots_nb`` policy: keep the outputs of the products with no
    batch dimension (the reference's ``dots_with_no_batch_dims_saveable``);
    recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXTS = {
    "full": noop_context_fn,
    "dots_nb": functools.partial(create_selective_checkpoint_contexts,
                                 _save_weight_products),
}


@contextlib.contextmanager
def _bound(slots):
    """Bind each (module, name, tensor) slot's tensor as that module's
    parameter for the duration.  The backward's recomputation runs after
    ``torch.func.functional_call`` has restored the model's own
    parameters; rebinding the tensors the forward ran on makes it
    recompute the same values."""
    old = [(m, k, m._parameters[k]) for m, k, _ in slots]
    for m, k, t in slots:
        m._parameters[k] = t
    try:
        yield
    finally:
        for m, k, t in old:
            m._parameters[k] = t


def reference_order(name: str) -> Tuple:
    """Sort key that puts parameter names in the reference's leaf order:
    dict keys sorted, list indices in order, and the entries of one stacked
    leaf one after the other (row-major over its stacked dimensions)."""
    parts = [int(p) if p.isdigit() else p for p in name.split(".")]
    n = _STACKED.get(parts[0], 0)
    # e.g. groups.<g>.<i>.<rest> -> (groups, *rest, g, i)
    return (parts[0], *parts[1 + n:], *parts[1:1 + n])


def reference_path(name: str) -> Tuple[str, Tuple[int, ...]]:
    """The reference's leaf path of a parameter name, and the index of the
    port's leaf along that leaf's stacked dimensions:
    ``groups.<g>.<i>.ssm.in_proj`` -> (``groups/ssm/in_proj``, (g, i)),
    ``blocks.<b>.layers.<i>.attn.wq`` -> (``blocks/layers/<i>/attn/wq``,
    (b,)), ``embed`` -> (``embed``, ()).  The one map between the two
    trees' names (the sharding rules match the reference's paths)."""
    parts = name.split(".")
    n = _STACKED.get(parts[0], 0)
    return ("/".join([parts[0], *parts[1 + n:]]),
            tuple(int(p) for p in parts[1:1 + n]))


class LM(torch.nn.Module):
    def __init__(self, cfg, device="cuda"):
        super().__init__()
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
        dev, d, spec = self.device, cfg.d_model, self.attn_spec
        self.embed = new_param((cfg.vocab, d), dev)
        self.ln_f = new_param((d,), dev)
        if cfg.norm == "layer":
            self.ln_f_b = new_param((d,), dev)
        if not cfg.tie_embeddings:
            self.unembed = new_param((d, cfg.vocab), dev)
        if cfg.enc_dec:
            attn = Plan("attn")
            self.enc_blocks = torch.nn.ModuleList(
                Layer(cfg, spec, attn, dev) for _ in range(cfg.n_enc_layers))
            self.dec_blocks = torch.nn.ModuleList(
                Layer(cfg, spec, attn, dev, cross=True)
                for _ in range(cfg.n_layers))
            self.pos_enc = new_param((cfg.n_frontend_positions, d), dev)
            self.pos_dec = new_param((cfg.max_positions, d), dev)
            self.ln_enc = new_param((d,), dev)
            self.ln_enc_b = new_param((d,), dev)
        elif cfg.family == "hybrid":
            per, G, rest = self.hybrid_layout
            self.groups = torch.nn.ModuleList(
                torch.nn.ModuleList(Layer(cfg, spec, SSM_PLAN, dev)
                                    for _ in range(per))
                for _ in range(G))
            self.rest = torch.nn.ModuleList(
                Layer(cfg, spec, SSM_PLAN, dev) for _ in range(rest))
            self.shared = SharedBlock(cfg, spec, dev)
        else:
            self.blocks = torch.nn.ModuleList(
                Block(cfg, spec, self.plans, dev)
                for _ in range(self.n_blocks))
            if cfg.learned_pos:
                self.pos_dec = new_param((cfg.max_positions, d), dev)

    # ------------------------------------------------------------------
    # layer plans: the repeating pattern inside one block
    # ------------------------------------------------------------------
    def _layer_plans(self):
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):
            return [SSM_PLAN]  # the hybrid's shared attention is apart
        if cfg.local_global_period:
            return [Plan("attn", "mlp", cfg.sliding_window),
                    Plan("attn", "mlp", None)]
        if cfg.moe is not None and cfg.moe_period > 1:
            return [Plan("attn", "mlp", None), Plan("attn", "moe", None)]
        if cfg.moe is not None:
            return [Plan("attn", "moe", None)]
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

    @property
    def hybrid_layout(self) -> Tuple[int, int, int]:
        """(layers a group, groups, rest layers) of the hybrid stack."""
        per = self.cfg.hybrid_period
        G = self.cfg.n_layers // per
        if G == 0:
            raise ValueError(f"n_layers {self.cfg.n_layers} is less than "
                             f"one hybrid group of {per}")
        return per, G, self.cfg.n_layers - G * per

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Draw fresh weights from ``generator`` (on the model's device)
        into the model's parameters; returns ``params()``.  Norm biases
        and RMSNorm scales (used as 1 + scale) start at zero, as in the
        reference.  LayerNorm scales multiply, so they start at one: the
        reference's start at zero, and every LayerNorm of its whisper and
        command-r then outputs zeros (all-zero logits)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                layer_norm_scale = (self.cfg.norm == "layer" and
                                    name.rsplit(".", 1)[-1]
                                    in _LAYER_NORM_SCALES)
                p.fill_(1.0 if layer_norm_scale else 0.0)
        embed_init_(self.embed, generator)
        if not self.cfg.tie_embeddings:
            dense_init_(self.unembed, generator)
        for m in self.modules():
            if isinstance(m, (Attention, GatedMLP, GeluMLP, MoE, SSM)):
                m.init(generator)
        for name in ("pos_enc", "pos_dec"):
            if hasattr(self, name):
                embed_init_(getattr(self, name), generator)
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
    def _ffn(self, lp: Layer, plan: Plan, h2: torch.Tensor,
             capacity: Optional[int] = None):
        """The feed-forward half of an attention layer on its normed input,
        post-norm included; returns (f, MoE aux loss or 0.0).

        Under the ``opt_ep`` variant with a ``launch.mesh.ProcessMesh``
        installed, the full-sequence MoE is expert-parallel, as in the
        reference (decode, which passes its drop-free ``capacity``, keeps
        ``moe_block`` there too).  With no GSPMD here, every rank holds the
        whole activations and parameters, hands ``moe_block_ep`` its own
        block of tokens and its own expert shards, and gathers the whole
        output back; the backward makes every gradient whole on every rank
        again."""
        from repro_torch.distributed import sharding as _shd
        cfg = self.cfg
        aux = 0.0
        if plan.ffn == "moe":
            mesh = _shd.current_mesh()
            if (capacity is None and _shd.current_variant() == "opt_ep"
                    and getattr(mesh, "device_mesh", None) is not None):
                f, aux = moe_block_ep_replicated(lp.moe.params(), cfg.moe,
                                                 h2, mesh)
            else:
                f, aux = moe_block(lp.moe.params(), cfg.moe, h2,
                                   capacity=capacity)
            if cfg.moe.dense_residual:
                f = f + gated_mlp(lp.mlp.params(), h2)
        elif cfg.enc_dec:
            f = gelu_mlp(lp.mlp.params(), h2)
        else:
            f = gated_mlp(lp.mlp.params(), h2)
        if cfg.post_norms:
            f = rms_norm(lp.ln2_post, f)
        return f, aux

    def _apply_layer(self, lp: Layer, plan: Plan, x: torch.Tensor):
        cfg = self.cfg
        if plan.kind == "ssm":
            return x + ssm_block(lp.ssm.params(), cfg.ssm,
                                 self._norm(lp, x)), 0.0
        h = self._norm(lp, x)
        a = attention(lp.attn.params(), self.attn_spec, h,
                      window=plan.window)
        if cfg.post_norms:
            a = rms_norm(lp.ln1_post, a)
        if cfg.parallel_block:
            return x + a + gated_mlp(lp.mlp.params(), h), 0.0
        x = x + a
        f, aux = self._ffn(lp, plan, self._norm(lp, x, "ln2"))
        return x + f, aux

    def _shared_block(self, x: torch.Tensor) -> torch.Tensor:
        sp = self.shared
        x = x + attention(sp.attn.params(), self.attn_spec,
                          rms_norm(sp.ln1, x))
        return x + gated_mlp(sp.mlp.params(), rms_norm(sp.ln2, x))

    def _remat(self, fn, modules, *args):
        """``fn(*args)``, a region whose parameters are those of
        ``modules``, under the config's activation-checkpoint policy.
        Without grad mode there is no backward to recompute for, and the
        region simply runs."""
        cfg = self.cfg
        if not cfg.remat or cfg.remat_policy == "none" \
                or not torch.is_grad_enabled():
            return fn(*args)
        if cfg.remat_policy not in _REMAT_CONTEXTS:
            raise ValueError(f"remat_policy must be full, dots_nb or none, "
                             f"got {cfg.remat_policy!r}")
        slots = [(m, k, t) for mod in modules for m in mod.modules()
                 for k, t in m._parameters.items()]

        def region(*a):
            with _bound(slots):
                return fn(*a)
        # no RNG runs in a region: the RNG state need not be kept
        return checkpoint(region, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=_REMAT_CONTEXTS[cfg.remat_policy])

    def _apply_block(self, block: Block, x: torch.Tensor):
        aux = 0.0
        for lp, plan in zip(block.layers, self.plans):
            x, a = self._apply_layer(lp, plan, x)
            aux = aux + a
        return x, aux

    def _apply_group(self, group, x: torch.Tensor) -> torch.Tensor:
        for lp in group:
            x, _ = self._apply_layer(lp, SSM_PLAN, x)
        return self._shared_block(x)

    def _decoder_stack(self, x: torch.Tensor):
        """The decoder-only stacks: blocks, or the hybrid's groups, shared
        block and rest layers; returns (x, aux).  Each block, and each
        hybrid group with its shared block, is one checkpoint region; the
        hybrid's rest layers are none, as in the reference."""
        aux = 0.0
        if self.cfg.family == "hybrid":
            for group in self.groups:
                x = self._remat(self._apply_group, [group, self.shared],
                                group, x)
            for lp in self.rest:
                x, _ = self._apply_layer(lp, SSM_PLAN, x)
            return x, aux
        for block in self.blocks:
            x, a = self._remat(self._apply_block, [block], block, x)
            aux = aux + a
        return x, aux

    # ------------------------------------------------------------------
    # public: forward / loss
    # ------------------------------------------------------------------
    def forward(self, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Any]:
        """batch: {'tokens': (B, S_text), optional 'frontend': (B, P, D)}
        ('frontend' is required by the encoder-decoder).

        Returns (logits over the *text* positions (B, S_text, V), aux);
        aux, the MoE load-balance loss, is 0.0 for the other families."""
        cfg = self.cfg
        if cfg.enc_dec:
            return self._encdec_forward(batch)
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
        x, aux = self._decoder_stack(x)
        x = self._norm(self, x, "ln_f")
        return self._logits(x[:, P_front:]), aux

    def _encoder_layer(self, lp: Layer, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(lp.ln1, lp.ln1_b, x)
        # unmasked self-attention: cross-attention of h over itself
        x = x + cross_attention(lp.attn.params(), self.attn_spec, h, h)
        return x + gelu_mlp(lp.mlp.params(), layer_norm(lp.ln2, lp.ln2_b, x))

    def _decoder_layer(self, lp: Layer, x: torch.Tensor,
                       memory: torch.Tensor) -> torch.Tensor:
        x = x + attention(lp.attn.params(), self.attn_spec,
                          layer_norm(lp.ln1, lp.ln1_b, x))
        x = x + cross_attention(lp.xattn.params(), self.attn_spec,
                                layer_norm(lp.ln2, lp.ln2_b, x), memory)
        return x + gelu_mlp(lp.mlp.params(), layer_norm(lp.ln3, lp.ln3_b, x))

    def _encoder(self, frames: torch.Tensor) -> torch.Tensor:
        x = cast(frames) + cast(self.pos_enc)[: frames.shape[1]][None]
        for lp in self.enc_blocks:
            x = self._remat(self._encoder_layer, [lp], lp, x)
        return layer_norm(self.ln_enc, self.ln_enc_b, x)

    def _encdec_forward(self, batch: Mapping[str, torch.Tensor]):
        memory = self._encoder(batch["frontend"])
        tok = self._embed_tokens(batch["tokens"])
        x = tok + cast(self.pos_dec)[: tok.shape[1]][None]
        for lp in self.dec_blocks:
            x = self._remat(self._decoder_layer, [lp], lp, x, memory)
        x = self._norm(self, x, "ln_f")
        return self._logits(x), 0.0

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
    arrays; leaves under ``blocks``, ``rest``, ``enc_blocks`` and
    ``dec_blocks`` stacked with one leading dimension, under ``groups``
    with two) as the port's parameters, by name, in the reference's leaf
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
            n = _STACKED.get(prefix[0], 0)
            for idx in np.ndindex(arr.shape[:n]):
                name = ".".join((prefix[0], *map(str, idx)) + prefix[1:])
                out[name] = torch.tensor(arr[idx], device=device)

    walk((), tree)
    return {k: out[k] for k in sorted(out, key=reference_order)}
