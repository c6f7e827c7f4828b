"""The port's five examples (``examples/torch_*.py``) on the CPU, each with
``--device cpu``, against the reference's examples where their output is
deterministic.

* ``torch_sort_study`` at its default 100,000 rows: the ``words`` column
  equals the reference example's, printed by its ``main()`` here.
* ``torch_quickstart`` at 3,000 rows: its self-checks (``assert``s
  against the NumPy oracle) pass, and every line it prints equals the
  reference's at the same size but the one with a path and a time.  Both
  run as scripts in fresh interpreters (their services fork shard
  workers); the reference's ``examples/quickstart.py`` is loaded as a
  module with its ``synth.census_like_table`` sized to 3,000 rows.
* ``torch_cluster_quickstart`` at 20,000 rows, in a fresh interpreter: it
  spawns its workers, and exits 0 with every answer asserted against a
  single-process service.
* ``torch_serve_lm`` and ``torch_train_lm``, tiny; the training example's
  ``[data]`` lines equal those that the reference's
  ``BitmapDataPipeline(...).index_stats()`` and ``select(...)`` give.
* Without CUDA each example raises unless ``--device cpu`` is given, and
  none imports ``jax`` or the reference package.
"""
import ast
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PORTED = ["torch_sort_study", "torch_quickstart", "torch_cluster_quickstart",
          "torch_serve_lm", "torch_train_lm"]
SORT_STUDY_WORDS = [362_891, 354_957, 249_738, 199_662, 197_580]
QUICKSTART_ROWS = 3000
TIMEOUT_S = 240


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name: str):
    return _load(EXAMPLES / f"{name}.py", name)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="2")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs several workers side by
    side."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _words(text: str):
    """The ``words`` column of a sort-study table."""
    return [int(line.split()[3]) for line in text.splitlines()[1:]]


def test_sort_study_words_equal_the_reference():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load(EXAMPLES / "sort_study.py", "ref_sort_study").main()
    want = _words(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = _example("torch_sort_study").main(["--device", "cpu"])
    assert want == SORT_STUDY_WORDS
    assert [r["words"] for r in rows] == want
    assert _words(out.getvalue()) == want
    assert [r["method"] for r in rows] == [
        "random-shuffle", "random-sort", "block-sort(10)", "lex", "gray"]


REFERENCE_QUICKSTART = r"""
import importlib.util, sys, types
sys.path.insert(0, "src")
n = int(sys.argv[1])
spec = importlib.util.spec_from_file_location("ref_quickstart",
                                              "examples/quickstart.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
synth = mod.synth
mod.synth = types.SimpleNamespace(
    census_like_table=lambda _n, rng: synth.census_like_table(n, rng),
    factorize=synth.factorize)
mod.main()
"""


def _without_path_and_time(text: str):
    """The printed lines but the one that names the store's path and the
    time it took to open."""
    return [line for line in text.splitlines()
            if not line.startswith("saved to ")]


def test_quickstart_lines_equal_the_reference():
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=_env(), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in (
                 [sys.executable, "-c", REFERENCE_QUICKSTART,
                  str(QUICKSTART_ROWS)],
                 [sys.executable, str(EXAMPLES / "torch_quickstart.py"),
                  "--device", "cpu", "--rows", str(QUICKSTART_ROWS)])]
    (ref_out, ref_err), (out, err) = [p.communicate(timeout=TIMEOUT_S)
                                      for p in procs]
    assert procs[0].returncode == 0, ref_err[-3000:]
    assert procs[1].returncode == 0, err[-3000:]
    assert f"fact table: {QUICKSTART_ROWS} rows" in out
    assert "compacted -> epoch 1" in out.splitlines()[-1]
    assert len(out.splitlines()) > 20
    assert _without_path_and_time(out) == _without_path_and_time(ref_out)


def test_cluster_quickstart_in_a_fresh_interpreter():
    res = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_cluster_quickstart.py"),
         "--device", "cpu", "--rows", "20000"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("store: 20000 rows in 3 shards")
    assert any(re.match(r"count: \d+ \(exact=True, covered 20000 rows\)", s)
               for s in lines)
    assert any(s.startswith("killed worker 2 mid-workload") for s in lines)
    assert lines[-1].startswith("counters: ")
    assert "'degraded_queries': 0" in lines[-1]


def test_serve_lm_generates_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tokens = _example("torch_serve_lm").main(
            ["--device", "cpu", "--batch", "2", "--new-tokens", "4"])
    from repro_torch.configs import get_config
    vocab = get_config("qwen2-0.5b").reduced().vocab
    assert tokens.shape == (2, 20)
    assert ((tokens >= 0) & (tokens < vocab)).all()
    lines = out.getvalue().splitlines()
    assert re.match(r"\[serve:qwen2-0.5b-smoke\] generated 8 tokens in ",
                    lines[0])
    assert lines[1].startswith("sample continuation ids: [")


def test_train_lm_data_lines_equal_the_reference(tmp_path):
    from repro.data.pipeline import BitmapDataPipeline, Corpus
    pipe = BitmapDataPipeline(Corpus.synthetic(n_docs=2048, doc_len=256,
                                               vocab=8_000), sort=True)
    stats = pipe.index_stats()
    want = [f"[data] bitmap index: {stats['index_words']:.0f} words "
            f"(unsorted would be {stats['index_words_unsorted']:.0f}; "
            f"sorting gain {stats['compression_gain']:.2f}x)",
            f"[data] selected {pipe.select(conj={'quality': 2})} docs via "
            f"bitmap predicate quality==2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        params, report = _example("torch_train_lm").main(
            ["--device", "cpu", "--steps", "2", "--compress", "0.25",
             "--ckpt-dir", str(tmp_path)])
    lines = out.getvalue().splitlines()
    assert lines[:2] == want
    assert report.steps_run == 2 and report.restarts == 0
    assert np.isfinite(report.losses).all()
    assert lines[2].startswith("[train] 2 steps in ")
    assert lines[3].startswith("[train] loss ")


def test_train_lm_checkpoints_apart_from_the_reference():
    """Both packages write one checkpoint layout and resume from what they
    find, so the port's default directory is not the reference's."""
    src = (EXAMPLES / "train_lm.py").read_text()
    ref_default = re.search(r'"--ckpt-dir", default="([^"]+)"', src).group(1)
    default = _example("torch_train_lm").CKPT_DIR
    assert default != ref_default
    assert os.path.dirname(default) == tempfile.gettempdir()


@pytest.mark.parametrize("name", PORTED)
def test_example_raises_without_cuda_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="--device cpu"):
        _example(name).main([])


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_neither_jax_nor_reference(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    bad = {m for m in mods if m.split(".")[0] in ("jax", "repro")}
    assert not bad, bad
    code = (f"import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location("
            f"'m', {str(EXAMPLES / (name + '.py'))!r})\n"
            f"spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'repro')]\n"
            f"assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
