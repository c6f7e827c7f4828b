"""Sharding rules: logical parameter and activation axes -> mesh specs.

Mesh axes (``launch/mesh.py``): ('pod',) 'data', 'model'.
  * data  — FSDP parameter sharding + batch data-parallelism
  * model — tensor parallelism (heads / d_ff / vocab) and expert parallelism
  * pod   — extra data-parallel axis across pods (multi-pod mesh); FSDP
            shards over ('pod', 'data') combined so the 400-480B MoE archs
            fit.

The reference's rules, as pure functions of a mesh's ``shape`` and
``axis_names``.  A spec is a tuple with one entry a dimension: ``None``
(replicated), an axis name, or a tuple of axis names.  Parameter rules are
(path regex -> spec) with the first match winning, matched against the
reference's stacked leaf paths (``blocks/layers/0/attn/wq``):
``models.transformer.reference_path`` maps the port's unstacked names to
them, and a port leaf takes the reference leaf's spec without its stacked
axes, which the reference leaves unsharded.

``use_mesh_rules`` installs the mesh, the variant and two switches that
model code reads (``want_bf16_scores`` in attention).  The state is
process-wide, not thread-local as the reference's: activation
checkpointing recomputes the forward on the autograd engine's device
thread, which must read the switches the forward read.  ``constrain``,
``constrain_qkv`` and ``constrain_moe_buf`` are the identity: on one card
there is nothing to constrain.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Tuple

from repro_torch.models.transformer import reference_path

Spec = Tuple[Any, ...]


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# ---------------------------------------------------------------------------
# Parameter rules.  D = d_model axis (FSDP), M = model/TP axis.
# ---------------------------------------------------------------------------

def param_rules(mesh, variant: str = "baseline") -> List[Tuple[str, Spec]]:
    """variant: 'baseline' | 'opt' (attn-SP + EP×TP MoE) | 'opt_attn'
    (attn-SP only, baseline MoE weight sharding) | 'opt_ep'."""
    F = fsdp_axes(mesh)
    if variant in ("opt", "opt_ep"):
        # EP×TP MoE: expert dim over 'model'; the FSDP axes move to the FFN
        # dim (wi/wg) / contracting dim (wo)
        moe_rules = [
            (r".*moe.*router$", (F, None)),
            (r".*moe.*w(i|g)$", ("model", None, F)),
            (r".*moe.*wo$", ("model", F, None)),
        ]
    else:
        moe_rules = [
            (r".*moe.*router$", (F, None)),
            (r".*moe.*w(i|g)$", ("model", F, None)),
            (r".*moe.*wo$", ("model", None, F)),
        ]
    return moe_rules + [
        # embeddings / unembeddings: vocab over model, d_model over FSDP
        (r".*embed.*", ("model", F)),
        (r".*pos_enc.*|.*pos_dec.*", (None, F)),
        # attention
        (r".*attn.*w(q|k|v)$", (F, "model")),
        (r".*attn.*wo$", ("model", F)),
        (r".*attn.*b(q|k|v)$", ("model",)),
        # dense MLPs: d_ff over model, d_model over FSDP
        (r".*mlp.*w(i|g)$", (F, "model")),
        (r".*mlp.*wo$", ("model", F)),
        (r".*mlp.*b(i)$", ("model",)),
        (r".*mlp.*b(o)$", (None,)),
        # SSM: project d_inner-ish dims over model, d_model over FSDP
        (r".*ssm.*in_proj$", (F, "model")),
        (r".*ssm.*out_proj$", ("model", F)),
        (r".*ssm.*conv_w$", (None, "model")),
        (r".*ssm.*conv_b$", ("model",)),
        (r".*ssm.*(A_log|D|dt_bias)$", (None,)),
        # norms and everything else: replicated
        (r".*", (None,)),
    ]


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _sanitize(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop sharding on dims the axis size does not divide; one entry a
    dimension."""
    out = []
    padded = list(spec)[: len(shape)] + [None] * (len(shape) - len(spec))
    for d, axis in enumerate(padded):
        if axis is not None and shape[d] % _axis_size(mesh, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


def spec_for(name: str, shape: Tuple[int, ...], mesh,
             variant: str = "baseline") -> Spec:
    """Spec of the port's parameter ``name`` of ``shape``: the reference's
    rule for its stacked path, without the stacked axes."""
    path, _ = reference_path(name)
    for pat, spec in param_rules(mesh, variant):
        if re.fullmatch(pat, path):
            return _sanitize(spec, tuple(shape), mesh)
    return ()


def _shape(leaf) -> Tuple[int, ...]:
    """A tensor's shape, or the shape of a (shape, dtype) pair."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def param_shardings(params: Mapping[str, Any], mesh,
                    variant: str = "baseline") -> Dict[str, Spec]:
    """Spec of every parameter, by name (tensors or (shape, dtype)
    pairs, e.g. ``LM(cfg, device="meta").params()``)."""
    return {k: spec_for(k, _shape(v), mesh, variant)
            for k, v in params.items()}


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of a ``shape`` sharded by ``spec``."""
    return tuple(d // _axis_size(mesh, a)
                 for d, a in zip(shape, tuple(spec) + (None,) * len(shape)))


# ---------------------------------------------------------------------------
# Mesh-rule context (process-wide; see the module docstring).
# ---------------------------------------------------------------------------

class _Rules:
    mesh = None
    variant = "baseline"
    bf16_scores = False
    moe_buf = True


_rules = _Rules()


def use_mesh_rules(mesh, variant: str = "baseline", *,
                   bf16_scores: bool = False, moe_buf: bool = True):
    _rules.mesh = mesh
    _rules.variant = variant
    _rules.bf16_scores = bf16_scores
    _rules.moe_buf = moe_buf
    return mesh


def want_bf16_scores() -> bool:
    return _rules.bf16_scores


def want_moe_buf_constraint() -> bool:
    return _rules.moe_buf


def current_mesh():
    return _rules.mesh


def current_variant() -> str:
    return _rules.variant


def constrain(x, kind: str):
    return x


def constrain_qkv(q, k, v):
    return q, k, v


def constrain_moe_buf(buf):
    return buf


def cache_shardings(cache: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """Decode-cache specs, by key.

    k/v/xk/xv (..., B, S, KV, hd): batch over DP when divisible, else the
    sequence axis; KV heads over 'model' when divisible, else head_dim.
    SSM states h (..., B, H, P, N) and conv (..., B, K-1, C): batch over DP,
    heads / channels over 'model'.  Everything else (``length``)
    replicated."""
    F = fsdp_axes(mesh)
    Fsize = _axis_size(mesh, F)
    Msize = mesh.shape["model"]
    out: Dict[str, Spec] = {}
    for name, leaf in cache.items():
        shape = _shape(leaf) if not isinstance(leaf, int) else ()
        nd = len(shape)
        spec: List[Any] = [None] * nd
        if name in ("k", "v", "xk", "xv") and nd >= 4:
            B, S, KV, hd = shape[nd - 4:]
            if B % Fsize == 0:
                spec[nd - 4] = F
            elif S % Fsize == 0:
                spec[nd - 3] = F
            if KV % Msize == 0:
                spec[nd - 2] = "model"
            elif hd % Msize == 0:
                spec[nd - 1] = "model"
        elif name in ("h", "conv", "rest_h", "rest_conv") and nd >= 3:
            b_ax = nd - 4 if name.endswith("h") else nd - 3
            m_ax = nd - 3 if name.endswith("h") else nd - 1
            if shape[b_ax] % Fsize == 0:
                spec[b_ax] = F
            if shape[m_ax] % Msize == 0:
                spec[m_ax] = "model"
        else:
            spec = []
        out[name] = tuple(spec)
    return out


def batch_shardings(batch: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """Inputs: the leading (batch) dim over the DP axes when divisible."""
    F = fsdp_axes(mesh)
    return {k: _sanitize((F,), _shape(v), mesh) for k, v in batch.items()}


def device_bytes(leaves: Mapping[str, Any], specs: Mapping[str, Spec],
                 mesh) -> int:
    """Bytes one device holds of ``leaves`` (tensors or (shape, dtype)
    pairs; a host int such as a cache's ``length`` holds none) sharded by
    ``specs``."""
    total = 0
    for k, leaf in leaves.items():
        if isinstance(leaf, int):
            continue
        size = (leaf.element_size() if hasattr(leaf, "element_size")
                else leaf[1].itemsize)
        total += math.prod(shard_shape(_shape(leaf), specs[k], mesh)) * size
    return total
