"""Measured EWAH-vs-kernel crossover: the executor's physical cost model.

The executor picks a physical path per n-ary node: the compressed EWAH
run-list path (cost ~ O(compressed words), Lemma 2) or the dense device
``logical_reduce`` path (cost ~ O(uncompressed words), flat in density).
The crossover density between the two is a property of the *machine* —
the card, its link to the host, the NumPy build — not of the data, so a
guessed constant (the old ``DENSE_THRESHOLD = 0.5``) is wrong on any box
it was not tuned on.

``calibrate()`` measures both paths on synthetic operand stacks across a
density sweep (density = compressed words / uncompressed words, the same
ratio ``Executor._use_kernel`` computes from live index stats), finds the
smallest density at which the kernel path wins, and returns a ``CostModel``
whose ``dense_threshold`` is the midpoint of the bracketing samples.  The
model persists as JSON (``save``/``load``); ``get_default()`` serves a
process-wide instance loaded from ``$REPRO_TORCH_COST_MODEL`` (or
``~/.cache/repro_torch/cost_model.json``; the reference package keeps its
own file, so the two never overwrite each other's crossover) so the executor and planner read the
calibrated value without re-measuring, falling back to the static default
when no calibration has ever run on this machine.
"""
from __future__ import annotations

import json
import logging
import os
import platform
import threading
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_DENSE_THRESHOLD = 0.5
DEFAULT_ARRAY_CUTOFF = 4096  # Roaring size crossover: 2B/position vs dense
ENV_PATH = "REPRO_TORCH_COST_MODEL"

log = logging.getLogger(__name__)


def default_path() -> Path:
    env = os.environ.get(ENV_PATH)
    if env:
        return Path(env)
    cache = os.environ.get("XDG_CACHE_HOME") or (Path.home() / ".cache")
    return Path(cache) / "repro_torch" / "cost_model.json"


@dataclass
class CostModel:
    """EWAH-vs-kernel decision parameters (possibly machine-calibrated)."""

    dense_threshold: float = DEFAULT_DENSE_THRESHOLD
    calibrated: bool = False
    source: str = "default"           # "default" | "calibrated" | file path
    machine: str = ""
    n_words: int = 0                  # calibration operand size
    n_operands: int = 0
    samples: List[dict] = field(default_factory=list)
    # per-chunk container selection (Roaring-style array/dense/run):
    # fields default so pre-container JSON files keep loading unchanged
    array_cutoff: int = DEFAULT_ARRAY_CUTOFF
    containers_calibrated: bool = False
    container_samples: List[dict] = field(default_factory=list)

    @property
    def machine_match(self) -> bool:
        """Whether the calibration was measured on *this* host.  Uncalibrated
        models (no machine recorded) trivially match; a loaded calibration
        from another box is stale — the crossover is a machine property."""
        return (not self.machine or self.machine == "?"
                or self.machine == (platform.node() or "?"))

    def choose_container(self, chunk_stats: dict) -> str:
        """Pick a container for one 2^16-bit chunk from its stats.

        ``chunk_stats`` needs ``count`` (set bits), ``n_words`` (chunk
        words) and ``run_words`` (exact serialized run-list words).
        Returns 'empty' | 'full' | 'run' | 'array' | 'dense' — the same
        decision the conversion paths in ``core/containers.py`` apply,
        exposed so planners/tools can predict the encoding.
        """
        count = int(chunk_stats["count"])
        n_words = int(chunk_stats["n_words"])
        if count == 0:
            return "empty"
        if count == 32 * n_words:
            return "full"
        run_words = int(chunk_stats["run_words"])
        array_words = (count + 1) // 2
        if run_words <= array_words and run_words <= n_words:
            return "run"
        if count <= self.array_cutoff and array_words < n_words:
            return "array"
        return "dense"

    def save(self, path: Optional[os.PathLike] = None) -> Path:
        p = Path(path) if path is not None else default_path()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(asdict(self), indent=2))
        return p

    @classmethod
    def load(cls, path: Optional[os.PathLike] = None) -> "CostModel":
        p = Path(path) if path is not None else default_path()
        data = json.loads(p.read_text())
        cm = cls(**{k: v for k, v in data.items()
                    if k in cls.__dataclass_fields__})
        cm.source = str(p)
        return cm


_lock = threading.Lock()
_default: Optional[CostModel] = None


def get_default(refresh: bool = False) -> CostModel:
    """Process-wide cost model: persisted calibration if present, else the
    static default.  ``refresh=True`` re-reads the file (tests, re-calibration)."""
    global _default
    with _lock:
        if _default is None or refresh:
            p = default_path()
            try:
                _default = CostModel.load(p) if p.exists() else CostModel()
            except (OSError, ValueError, TypeError):
                _default = CostModel()
            if _default.calibrated and not _default.machine_match:
                # still applied — thresholds from a similar box beat the
                # static default — but flagged, and /stats exposes
                # machine_match so operators can see the staleness
                log.warning(
                    "cost model %s was calibrated on machine %r, this host "
                    "is %r — thresholds may be stale; re-run calibrate()",
                    _default.source, _default.machine,
                    platform.node() or "?")
    return _default


def set_default(model: Optional[CostModel]) -> None:
    """Install (or with ``None`` reset) the process-wide model directly."""
    global _default
    with _lock:
        _default = model


def _synthetic_stack(n_words: int, n_operands: int, density: float,
                     rng: np.random.Generator):
    """Operand stack whose compressed/uncompressed ratio ~= ``density``:
    a fraction ``density`` of words are random dirty literals, the rest are
    clean-zero runs — the word-level structure of a sorted fact table."""
    from .ewah import EWAH
    bms = []
    for _ in range(n_operands):
        words = np.zeros(n_words, dtype=np.uint32)
        n_dirty = int(density * n_words)
        if n_dirty:
            pos = rng.choice(n_words, size=n_dirty, replace=False)
            vals = rng.integers(1, 0xFFFFFFFF, size=n_dirty, dtype=np.uint32)
            words[pos] = vals
        bms.append(EWAH.from_words(words, n_words * 32))
    return bms


def _best_of(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate(n_words: int = 1 << 14, n_operands: int = 8,
              densities: Sequence[float] = (0.02, 0.05, 0.1, 0.2, 0.35,
                                            0.5, 0.7, 0.9),
              repeats: int = 3, device="cuda",
              seed: int = 0) -> CostModel:
    """Measure the EWAH-vs-kernel crossover on *this* machine.

    For each density, times the vectorized host EWAH ``and_many`` against
    the fused ``logical_reduce`` on ``device`` (``"cuda"`` by default;
    raises when CUDA is absent — ``"cpu"`` times the plain versions, and
    only when asked for).  Operands are on the device before timing, as in
    the executor's operand cache; the timed kernel path includes bringing
    the result row back to the host, which ends in a synchronisation.
    Warm: one reduction runs before timing.  Brackets the smallest density
    where the kernel wins and returns an uninstalled ``CostModel``; call
    ``.save()`` + ``set_default`` (or ``get_default(refresh=True)`` after
    saving) to put it into effect.
    """
    from .ewah import and_many
    from repro_torch.kernels import ops as kops

    dev = kops.resolve_device(device)
    rng = np.random.default_rng(seed)
    samples: List[dict] = []
    crossover: Optional[float] = None
    prev_density: Optional[float] = None
    for d in densities:
        bms = _synthetic_stack(n_words, n_operands, d, rng)
        mat = kops.to_device_words(np.stack([bm.to_words() for bm in bms]),
                                   dev)
        for bm in bms:
            bm.runlist()  # decode outside the timed region, like the executor cache
        kernel = lambda: kops.to_numpy_words(  # noqa: E731
            kops.logical_reduce(mat, op="and"))
        kernel()  # warm: first launch (and, once per process, the build)
        ewah_s = _best_of(lambda: and_many(bms), repeats)
        kern_s = _best_of(kernel, repeats)
        samples.append({"density": d, "ewah_us": ewah_s * 1e6,
                        "kernel_us": kern_s * 1e6})
        if crossover is None and kern_s < ewah_s:
            crossover = d if prev_density is None else (prev_density + d) / 2
        prev_density = d
    if crossover is None:
        # the kernel never won: only an explicit backend="kernel" uses it.
        # Must be infinite, not ~1.0 — marker overhead pushes the measured
        # density of incompressible bitmaps slightly *above* 1.0, which
        # would dispatch exactly the slow case calibration excluded.
        # (json round-trips float inf as Infinity.)
        threshold = float("inf")
    else:
        threshold = float(crossover)
    source = "calibrated" if dev.type == "cuda" else "calibrated-cpu"
    return CostModel(dense_threshold=threshold, calibrated=True,
                     source=source, machine=platform.node() or "?",
                     n_words=n_words, n_operands=n_operands, samples=samples)


def calibrate_containers(counts: Sequence[int] = (256, 512, 1024, 2048,
                                                  4096, 6144, 8192),
                         repeats: int = 5, seed: int = 0,
                         base: Optional[CostModel] = None) -> CostModel:
    """Measure the array-vs-dense container crossover on *this* machine.

    For each per-chunk population, times the array path (sorted-position
    membership intersect) against the dense path (word AND + popcount
    re-normalization) on one 2^16-bit chunk.  The Roaring size crossover
    (4096: above it an array is bigger than the dense words) is the
    primary criterion — below it an array container is at least 2x
    smaller — so the measured latency only *lowers* the cutoff where the
    dense path is decisively (>4x) faster, i.e. where giving up the size
    win is clearly paid back.  Micro-timing noise at small populations
    (both paths are fixed-overhead-dominated microseconds) therefore
    cannot flip chunks to the larger encoding.  Returns an uninstalled
    model (merged over ``base`` or the current default); ``.save()`` +
    ``get_default(refresh=True)`` puts it into effect.
    """
    from .containers import (CHUNK_BITS, CHUNK_WORDS, _membership,
                             _norm_words, _scatter, T_ARRAY)

    rng = np.random.default_rng(seed)
    samples: List[dict] = []
    crossover: Optional[int] = None
    prev: Optional[int] = None
    for count in counts:
        pa = np.unique(rng.integers(0, CHUNK_BITS, count)).astype(np.uint16)
        pb = np.unique(rng.integers(0, CHUNK_BITS, count)).astype(np.uint16)
        wa, wb = _scatter(pa, CHUNK_WORDS), _scatter(pb, CHUNK_WORDS)
        arr_s = _best_of(lambda: pa[_membership(pa, T_ARRAY, pb)], repeats)
        dense_s = _best_of(
            lambda: _norm_words(np.bitwise_and(wa, wb), 1 << 30), repeats)
        samples.append({"count": count, "array_us": arr_s * 1e6,
                        "dense_us": dense_s * 1e6})
        if crossover is None and dense_s * 4 < arr_s:
            crossover = count if prev is None else (prev + count) // 2
        prev = count
    cutoff = DEFAULT_ARRAY_CUTOFF if crossover is None \
        else min(DEFAULT_ARRAY_CUTOFF, int(crossover))
    model = base if base is not None else get_default()
    return CostModel(
        dense_threshold=model.dense_threshold, calibrated=model.calibrated,
        source="calibrated", machine=platform.node() or "?",
        n_words=model.n_words, n_operands=model.n_operands,
        samples=model.samples, array_cutoff=cutoff,
        containers_calibrated=True, container_samples=samples)
