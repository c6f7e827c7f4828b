"""Batched greedy serving loop (prefill + decode) over the unified LM."""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import decode as dec
from repro_torch.models.transformer import LM


def prefill_into_cache(model: LM, cache, tokens: torch.Tensor):
    """Sequentially decode the prompt into the cache (teacher forcing).

    Simple and exact for every family (attention caches, SSM states,
    hybrids); production prefill would batch this per chunk."""
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = dec.serve_step(model, cache, tokens[:, i:i + 1])
    return logits, cache


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    # torch.argmax, like jnp.argmax, takes the first maximum
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def _wait(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def generate(model: LM, prompts: np.ndarray, max_new_tokens: int,
             max_len: Optional[int] = None,
             frontend: Optional[np.ndarray] = None,
             timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Greedy generation for a batch of equal-length prompts, on the
    model's device; returns (B, S0 + max_new_tokens) int32 tokens.
    ``timings``, where given, receives ``prefill_s`` (the cross cache and
    the prompt) and ``decode_s`` (the new tokens), each on the host clock
    after the device has finished."""
    B, S0 = prompts.shape
    max_len = max_len or (S0 + max_new_tokens)
    device = model.device
    t0 = _wait(device)
    cache = dec.init_cache(model, B, max_len)
    if model.cfg.enc_dec:
        if frontend is None:
            raise ValueError(f"{model.cfg.name} needs the frontend frames")
        cache["xk"], cache["xv"] = dec.encdec_prefill_cross(
            model, torch.as_tensor(frontend, device=device))
    logits, cache = prefill_into_cache(
        model, cache, torch.as_tensor(prompts, device=device))
    tok = _greedy(logits)
    t1 = _wait(device)
    out = [np.asarray(prompts)]
    for _ in range(max_new_tokens):
        out.append(tok.cpu().numpy())
        logits, cache = dec.serve_step(model, cache, tok)
        tok = _greedy(logits)
    t2 = _wait(device)
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=t2 - t1)
    return np.concatenate(out, axis=1)
