"""train_step / prefill_step / serve_step factories; the train step with
gradient accumulation over microbatches."""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.models import decode as dec
from repro_torch.models.transformer import LM
from .optimizer import AdamW

Tensors = Dict[str, torch.Tensor]


def value_and_grad(model: LM, params: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Tensors]:
    """(loss, grads by name) of ``model.loss`` at ``params``: the port of
    ``jax.value_and_grad(model.loss)``.  The params are not modified, and
    the model's own ``.grad`` fields are not touched."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = model.loss(batch, leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(model: LM, opt: AdamW, n_micro: int = 1):
    """n_micro > 1: gradient accumulation over microbatches — divides the
    activation live set by n_micro; the loss and the float32 gradients are
    the means over the microbatches."""
    if n_micro == 1:
        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(model, params, batch)
            params, opt_state = opt.apply(params, grads, opt_state)
            return params, opt_state, loss
        return train_step

    def train_step(params, opt_state, batch):
        micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        gacc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
        lacc = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        for i in range(n_micro):
            loss, grads = value_and_grad(
                model, params, {k: v[i] for k, v in micro.items()})
            for k, g in grads.items():
                gacc[k] = gacc[k] + g.float() / n_micro
            lacc = lacc + loss / n_micro
        params, opt_state = opt.apply(params, gacc, opt_state)
        return params, opt_state, lacc
    return train_step


def make_prefill_step(model: LM):
    """prefill_step(batch) -> the full forward's logits."""
    def prefill_step(batch):
        logits, _ = model(batch)
        return logits
    return prefill_step


def make_serve_step(model: LM):
    """serve_step(cache, tokens) -> (logits, cache): one decode step."""
    def serve_step(cache, tokens):
        return dec.serve_step(model, cache, tokens)
    return serve_step
