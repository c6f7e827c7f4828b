"""Input stand-ins per (arch × shape): shapes and dtypes, no allocation.

train/prefill : {'tokens': (B, S_text) int32 [, 'frontend': (B, P, D) bf16]}
decode        : serve_step inputs — the cache's (shape, dtype) by key
                (S_max = shape.seq_len; ``length`` is a host int) and
                (B, 1) int32 tokens
Text length accounts for stub frontend positions so *total* model positions
equal the assigned seq_len (vlm: patches + text; whisper enc positions are a
separate 1500-frame encoder input, decoder gets the full seq_len).

A spec is a (shape, dtype) pair; ``materialize`` makes tensors of them (on
``meta`` for a dry-run: nothing is allocated).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import decode as dec
from repro_torch.models.transformer import LM

from .base import ModelConfig, ShapeConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.enc_dec:
        return shape.seq_len
    return shape.seq_len - cfg.n_frontend_positions


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    B = shape.global_batch
    out: Dict[str, Spec] = {"tokens": ((B, text_len(cfg, shape)),
                                       torch.int32)}
    if cfg.n_frontend_positions:
        out["frontend"] = ((B, cfg.n_frontend_positions, cfg.d_model),
                           torch.bfloat16)
    return out


def decode_specs(model: LM, shape: ShapeConfig
                 ) -> Tuple[Dict[str, Spec], Spec]:
    B = shape.global_batch
    return dec.cache_spec(model, B, shape.seq_len), ((B, 1), torch.int32)


def materialize(specs: Dict[str, Spec], device="meta"
                ) -> Dict[str, torch.Tensor]:
    """Uninitialized tensors of ``specs`` on ``device``."""
    device = resolve_device(device)
    return {k: torch.empty(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in specs.items()}


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig, rng=None,
                   device="cuda") -> Dict[str, Any]:
    """Real tensors matching ``batch_specs``, drawn as the reference draws
    them (tokens ``rng.integers(0, vocab)``, frames standard normal cast to
    bfloat16; ``default_rng(0)`` unless ``rng`` is given), on ``device``."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    specs = batch_specs(cfg, shape)
    tokens = rng.integers(0, cfg.vocab, size=specs["tokens"][0])
    out = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)}
    if "frontend" in specs:
        frames = rng.standard_normal(specs["frontend"][0])
        out["frontend"] = torch.from_numpy(frames).to(
            device=device, dtype=torch.bfloat16)
    return out
