"""EWAH sparse-gradient exchange with error feedback.

The paper's machinery applied to a distributed-training collective:
gradients are sparsified block-wise (keep the top-energy blocks of 256
values), and the surviving-block *bitmap* — the kind of sparse boolean
vector EWAH compresses well — indexes the packed payload.  On one device
the mask is applied and the masked gradient is what an all-reduce would
sum; the stats report the wire size that the bitmap + payload encoding
would achieve.  Error feedback accumulates the dropped mass, so
convergence is kept.

The per-block norms run in the ``block_sqnorms`` CUDA kernel
(``kernels/grad_compress.py``) on a CUDA gradient.  Gradients are dicts of
tensors by name; a flat vector lists them in the dict's order (the model's
``params()`` order, which is the reference's leaf order).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ewah import EWAH
from repro_torch.kernels import ops as kops

Tensors = Dict[str, torch.Tensor]


class CompressionStats(NamedTuple):
    dense_bytes: int
    payload_bytes: int
    bitmap_words: int

    @property
    def wire_bytes(self) -> int:
        return self.payload_bytes + 4 * self.bitmap_words

    @property
    def ratio(self) -> float:
        return self.dense_bytes / max(self.wire_bytes, 1)


def _flatten(tree: Mapping[str, torch.Tensor]):
    leaves = list(tree.values())
    flat = torch.cat([leaf.reshape(-1).float() for leaf in leaves])
    return flat, leaves


def _unflatten(tree: Mapping[str, torch.Tensor],
               flat: torch.Tensor) -> Tensors:
    """Cut ``flat`` into tensors shaped and typed like ``tree``'s; each is a
    view of ``flat`` where the dtype is float32."""
    out = {}
    off = 0
    for k, leaf in tree.items():
        n = leaf.numel()
        out[k] = flat[off:off + n].reshape(leaf.shape).to(leaf.dtype)
        off += n
    return out


def sparsify(grads: Mapping[str, torch.Tensor],
             error: Optional[Mapping[str, torch.Tensor]], keep_ratio: float,
             values_per_block: int = 256):
    """(grads, error feedback) -> (kept flat grads, new error flat,
    block keep mask, flat grads + error)."""
    flat, _ = _flatten(grads)
    if error is not None:
        eflat, _ = _flatten(error)
        flat = flat + eflat
    n = flat.shape[0]
    npad = -(-n // values_per_block) * values_per_block
    fpad = F.pad(flat, (0, npad - n))
    mask_blocks = kops.topk_block_mask(fpad, keep_ratio, values_per_block)
    mask = mask_blocks.repeat_interleave(values_per_block)[:n]
    kept = flat * mask
    new_error_flat = flat - kept
    return kept, new_error_flat, mask_blocks, flat


def compressed_allreduce(grads: Mapping[str, torch.Tensor],
                         error: Optional[Mapping[str, torch.Tensor]],
                         keep_ratio: float, values_per_block: int = 256
                         ) -> Tuple[Tensors, Tensors, CompressionStats]:
    """Returns (sparsified grads, new error, wire stats).

    The cross-replica mean is the caller's; the stats report what the
    EWAH-encoded exchange would put on the wire."""
    kept, new_error_flat, mask_blocks, flat = sparsify(
        grads, error, keep_ratio, values_per_block)
    grads_out = _unflatten(grads, kept)
    error_out = _unflatten(grads, new_error_flat)

    mask_np = mask_blocks.cpu().numpy()
    bitmap = EWAH.from_bool(mask_np)
    n_kept = int(mask_np.sum()) * values_per_block
    stats = CompressionStats(
        dense_bytes=int(flat.shape[0]) * 4,
        payload_bytes=n_kept * 4,
        bitmap_words=bitmap.size_words,
    )
    return grads_out, error_out, stats


def init_error(params: Mapping[str, Any]) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
