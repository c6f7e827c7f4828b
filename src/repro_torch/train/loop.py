"""Training loop wiring model + optimizer + bitmap data pipeline + fault
tolerance + optional EWAH gradient compression into one entry point."""
from __future__ import annotations

import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.data.pipeline import BitmapDataPipeline
from repro_torch.distributed import grad_compression as gcomp
from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor)
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.transformer import LM
from .optimizer import AdamW, AdamWConfig
from .step import make_train_step, value_and_grad


@dataclass
class TrainConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 256
    # a fresh directory per config unless one is given: a stale checkpoint
    # of another run is never restored
    ckpt_dir: str = field(default_factory=lambda: tempfile.mkdtemp(
        prefix="repro_torch_ckpt_"))
    ckpt_every: int = 50
    grad_compression: Optional[float] = None  # keep_ratio, e.g. 0.1
    lr: float = 3e-4


def make_compressed_train_step(model: LM, opt: AdamW, keep_ratio: float):
    """train_step with EWAH block-sparsified gradients + error feedback.
    The wire stats are not computed here; ``compressed_allreduce`` gives
    them on demand."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        kept, new_err_flat, _, _ = gcomp.sparsify(
            grads, opt_state["error"], keep_ratio)
        del grads
        grads_s = gcomp._unflatten(params, kept)
        new_err = gcomp._unflatten(params, new_err_flat)
        params, inner = opt.apply(params, grads_s, opt_state["inner"])
        return params, {"inner": inner, "error": new_err}, loss
    return train_step


def train(model: LM, cfg: TrainConfig, pipeline: BitmapDataPipeline,
          generator: Optional[torch.Generator] = None,
          inject_failure_at: Optional[int] = None,
          params: Optional[Mapping[str, torch.Tensor]] = None,
          device: Union[str, torch.device] = "cuda"):
    """Train ``model`` for ``cfg.steps`` steps under the supervisor; returns
    (params, report).  The model must live on ``device``.  ``params`` is the
    starting point (copied into the model); without it the model draws
    fresh weights from ``generator`` (default: seed 0 on ``device``)."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, training was "
                         f"asked for on {device}")
    if params is not None:
        state_params = model.load_params(params)
    else:
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        state_params = model.init(generator)
    opt = AdamW(AdamWConfig(lr=cfg.lr, warmup_steps=max(cfg.steps // 20, 1),
                            total_steps=cfg.steps))
    if cfg.grad_compression:
        step_fn = make_compressed_train_step(model, opt, cfg.grad_compression)
        opt_state: Dict[str, Any] = {"inner": opt.init(state_params),
                                     "error": gcomp.init_error(state_params)}
    else:
        step_fn = make_train_step(model, opt)
        opt_state = opt.init(state_params)

    def data_fn(step: int) -> Dict[str, torch.Tensor]:
        b = pipeline.batch(step, cfg.batch_size, cfg.seq_len)
        batch = {"tokens": torch.from_numpy(b["tokens"]).to(device)}
        if model.cfg.enc_dec:
            # the encoder needs frames; the reference's loop feeds none
            # (its whisper cannot train there).  Stub frames from the step,
            # so that a restart replays the same batch.
            shape = (cfg.batch_size, model.cfg.n_frontend_positions,
                     model.cfg.d_model)
            frames = np.random.default_rng(step).standard_normal(
                shape, dtype=np.float32)
            batch["frontend"] = torch.from_numpy(frames).to(device)
        return batch

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=cfg.ckpt_dir, ckpt_every=cfg.ckpt_every),
        step_fn, {"params": state_params, "opt": opt_state}, data_fn)
    if inject_failure_at is not None:
        sup.inject_failure_at = inject_failure_at
    report = sup.run(cfg.steps)
    return sup.state["params"], report
