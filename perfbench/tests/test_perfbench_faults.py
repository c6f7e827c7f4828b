"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of a cell at a tiny scale on the CPU (the
harness's look for a card skipped): build, store, service over HTTP, the
client's window, and the judgement against the reference.  The faults a
served bitmap cell can have: an answer altered where it is produced (the
service's finalisation, or the kernel path's result row), and half of the
work left out (half of the shards' partials dropped at the merge); and
the control, the program's measure sums in float32.  A sound run of the
same cell comes out correct."""
import numpy as np

from perfbench import run as harness
from perfbench.control import float32_sums
from perfbench.tests.tiny import tiny_run
from repro_torch.core import measures
from repro_torch.kernels import logical_reduce as lr

CELL = harness.load_bench()["workloads"][0]["name"]


def test_sound_run_is_correct():
    out = tiny_run(CELL)
    assert out["correct"], out["checks"]
    assert out["checks"]["answers_judged"]["value"] > 0
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(harness.load_bench(),
                                                    CELL, "end_to_end")}
    assert set(out["metrics"]) == want and {"setup_s",
                                            "queries_per_s"} <= want


def test_answer_altered_in_the_service(monkeypatch):
    real = measures.finalize_group

    def off_by_one(op, agg):
        out = np.array(real(op, agg), copy=True)
        out[np.flatnonzero(agg["counts"])[:1]] += 1
        return out
    monkeypatch.setattr(measures, "finalize_group", off_by_one)
    out = tiny_run(CELL)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def test_kernel_result_altered(monkeypatch):
    real = lr.fold_plain
    calls = []

    def flipped(rows, flags, n_pos, op):
        out, out_flags = real(rows, flags, n_pos, op)
        calls.append(1)
        out = out.clone()
        out[0] ^= 1
        return out, lr.row_flags(out[None])[0]
    monkeypatch.setattr(lr, "fold_plain", flipped)
    out = tiny_run(CELL)
    assert calls, "the run never reached the kernel path"
    assert not out["correct"]


def test_half_the_shards_left_out(monkeypatch):
    for name in ("merge_group_aggs", "merge_scalar_aggs"):
        real = getattr(measures, name)
        monkeypatch.setattr(measures, name,
                            lambda parts, real=real:
                            real(parts[:max(len(parts) // 2, 1)]))
    out = tiny_run(CELL)
    assert not out["correct"]


def test_float32_sums_control():
    with float32_sums():
        out = tiny_run(CELL)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0
    assert out["failed"] == 0
    # and the program's own sums are back afterwards
    assert tiny_run(CELL)["correct"]
