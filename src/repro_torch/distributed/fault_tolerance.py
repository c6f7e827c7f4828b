"""Fault tolerance: checkpoint/restart supervision and straggler detection.

``TrainSupervisor`` owns the run loop around a train_step:
  * periodic async checkpoints (params + opt + data cursor);
  * crash recovery: any step exception triggers restore-from-latest and
    replay (the data pipeline is seekable, so no sample is lost/repeated);
  * straggler detection: steps slower than ``straggler_factor`` × the median
    are logged and counted; on real fleets the launcher would re-balance the
    slow host's shard (here the hook records the event and the decision).

A step's time is taken after ``float(loss)``, which waits for the device,
so ``step_times`` are whole-step times on a CUDA device.  Checkpoints are
in the reference's layout (``checkpoint.py``), so a supervisor of either
package resumes from the other's.  The reference's elastic re-sharding on
restore is not ported (the state is restored whole onto each leaf's
device).

Failure injection for tests/examples: ``inject_failure_at`` raises inside
the loop at a chosen step, exactly once.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import checkpoint as ckpt


@dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 5


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_events: List[int] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)


class SimulatedFailure(RuntimeError):
    pass


class TrainSupervisor:
    def __init__(self, cfg: SupervisorConfig, step_fn: Callable,
                 state: Dict[str, Any], data_fn: Callable[[int], Any]):
        """state: {'params': .., 'opt': ..}; data_fn(step) -> batch (seekable)."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.data_fn = data_fn
        self.ckpt = ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep)
        self.report = SupervisorReport()
        self.inject_failure_at: Optional[int] = None
        self._injected = False

    # -- crash recovery ----------------------------------------------------
    def _restore(self, start_step: int) -> int:
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return start_step
        step, tree, extra = ckpt.load(self.cfg.ckpt_dir,
                                      {"params": self.state["params"],
                                       "opt": self.state["opt"]})
        self.state["params"] = tree["params"]
        self.state["opt"] = tree["opt"]
        return int(extra.get("next_step", step + 1))

    def run(self, n_steps: int, start_step: int = 0) -> SupervisorReport:
        step = start_step
        restarts = 0
        while step < n_steps:
            try:
                step = self._run_from(step, n_steps)
            except Exception:  # noqa: BLE001 — any failure: restore & retry
                restarts += 1
                self.report.restarts = restarts
                if restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                step = self._restore(start_step)
        self.ckpt.wait()
        return self.report

    def _run_from(self, step: int, n_steps: int) -> int:
        while step < n_steps:
            if self.inject_failure_at == step and not self._injected:
                self._injected = True
                raise SimulatedFailure(f"injected node failure at step {step}")
            batch = self.data_fn(step)
            t0 = time.time()
            self.state["params"], self.state["opt"], loss = self.step_fn(
                self.state["params"], self.state["opt"], batch)
            loss = float(loss)
            dt = time.time() - t0
            self.report.step_times.append(dt)
            self.report.losses.append(loss)
            self.report.steps_run += 1
            # straggler detection on the rolling median
            times = self.report.step_times[-50:]
            if len(times) >= 10:
                med = float(np.median(times))
                if dt > self.cfg.straggler_factor * med:
                    self.report.straggler_events.append(step)
            step += 1
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step, {"params": self.state["params"],
                                            "opt": self.state["opt"]},
                                     extra={"next_step": step})
        return step
