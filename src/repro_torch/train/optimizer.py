"""AdamW + cosine schedule + global-norm clipping: the reference's own update
over a dict of tensors (not ``torch.optim.AdamW``).

State mirrors the params: ``{'m': {...}, 'v': {...}, 'step': int32 scalar}``.
Float32 moments by default; params are float32 masters (bf16 compute
happens in the model).  The math follows the reference step for step: clip
by the global norm, bias correction, ``eps`` outside the square root and
weight decay inside the step.  The reference returns new arrays; this port
updates the params and moments in place, which saves a copy of each, and
returns them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # storage dtype for the Adam moments (math stays fp32): "f32" | "bf16"
    moment_dtype: str = "f32"


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0, in float32."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


class AdamW:
    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        self.cfg = cfg

    def init(self, params: Tensors) -> Dict:
        mdt = torch.bfloat16 if self.cfg.moment_dtype == "bf16" \
            else torch.float32
        device = next(iter(params.values())).device
        return {
            "m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def apply(self, params: Tensors, grads: Tensors, state: Dict):
        """One AdamW step: updates ``params`` and the moments of ``state``
        in place; returns ``(params, new_state)``."""
        cfg = self.cfg
        step = state["step"] + 1
        if cfg.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
        else:
            scale = None
        lr = cosine_lr(cfg, step)
        stepf = step.float()
        bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device),
                              stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device),
                              stepf)
        for k, p in params.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            m, v = state["m"][k], state["v"][k]
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = p.float()
            upd = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
            p.copy_(p32 - lr * upd)
            m.copy_(m32)
            v.copy_(v32)
        return params, {"m": state["m"], "v": state["v"], "step": step}
