"""repro_torch training vs the reference package: AdamW, the train step,
the compressed training loop, checkpoints and the supervisor.

Tolerances: AdamW updates in float32, rtol=1e-6 (the same float32 ops;
the global norm sums leaves in another order, so the clip scale may differ
in its last bit: moments get an absolute floor of 1e-6 x the leaf's
largest moment); the compressed training
run's losses, 2e-2 absolute (bfloat16 compute in both, three steps from
the same weights and batches); checkpoints restore bit for bit.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.data.pipeline import BitmapDataPipeline as RPipe, Corpus as RCorpus
from repro.models.transformer import LM as RLM
from repro.train import loop as r_loop
from repro.train import optimizer as r_opt
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.data.pipeline import BitmapDataPipeline as TPipe
from repro_torch.data.pipeline import Corpus as TCorpus
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import grad_compression as t_gc
from repro_torch.kernels import grad_compress as t_kgc
from repro_torch.models.transformer import LM as TLM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.train import loop as t_loop
from repro_torch.train import optimizer as t_opt
from repro_torch.train.step import make_train_step

ARCH = "qwen2-0.5b"


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs several workers side by side: two intra-op threads a
    test keep these models from starving other files' timing-sensitive
    tests of cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((6, 10)) * scale).astype(np.float32),
            "b": (rng.standard_normal(33) * scale).astype(np.float32),
            "c": (rng.standard_normal((2, 3, 4)) * scale).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture()
def tiny():
    return TLM(T_ARCHS[ARCH].reduced(), device="cpu")


# -- optimizer -------------------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_apply_matches_reference(clip, moments):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
               moment_dtype=moments)
    r = r_opt.AdamW(r_opt.AdamWConfig(**cfg))
    t = t_opt.AdamW(t_opt.AdamWConfig(**cfg))
    params = _tree(0)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = _t(params)
    rs, ts = r.init(rp), t.init(tp)
    # three steps: warm-up, the peak, then cosine decay; grads above the
    # clip norm
    for i in range(3):
        g = _tree(10 + i, scale=3.0)
        rp, rs = r.apply(rp, {k: jnp.asarray(v) for k, v in g.items()}, rs)
        tp, ts = t.apply(tp, _t(g), ts)
        assert int(ts["step"]) == int(rs["step"]) == i + 1
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                want = np.asarray(rs[mom][k], np.float32)
                np.testing.assert_allclose(
                    ts[mom][k].float().numpy(), want, rtol=1e-6,
                    atol=1e-6 * np.abs(want).max())


def test_cosine_lr_and_global_norm_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=40)
    for s in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        np.testing.assert_allclose(
            float(t_opt.cosine_lr(t_opt.AdamWConfig(**cfg), torch.tensor(s))),
            float(r_opt.cosine_lr(r_opt.AdamWConfig(**cfg), jnp.asarray(s))),
            rtol=1e-6)
    tree = _tree(3)
    np.testing.assert_allclose(
        float(t_opt.global_norm(_t(tree))),
        float(r_opt.global_norm({k: jnp.asarray(v) for k, v in tree.items()})),
        rtol=1e-6)


# -- train step ---------------------------------------------------------------

def test_train_step_updates_and_loss_drops(tiny):
    params = tiny.init(torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in params.items()}
    opt = t_opt.AdamW(t_opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=10))
    state = opt.init(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, tiny.cfg.vocab, (2, 32)).astype(np.int32))}
    step = make_train_step(tiny, opt)
    p1, s1, loss1 = step(params, state, batch)
    p2, s2, loss2 = step(p1, s1, batch)
    assert np.isfinite(float(loss1)) and float(loss2) < float(loss1)
    assert max(float((before[k] - p2[k].detach()).abs().max())
               for k in p2) > 0
    assert all(p.grad is None for p in tiny.parameters())


def test_train_step_microbatches_average_the_gradient(tiny):
    params = tiny.init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, tiny.cfg.vocab, (4, 16)).astype(np.int32))}
    cfg = t_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                            clip_norm=None)
    one = {k: v.detach().clone() for k, v in params.items()}
    two = {k: v.detach().clone() for k, v in params.items()}
    opt = t_opt.AdamW(cfg)
    _, _, l1 = make_train_step(tiny, opt, 1)(one, opt.init(one), batch)
    _, _, l2 = make_train_step(tiny, opt, 2)(two, opt.init(two), batch)
    # the mean loss over equal microbatches is the loss of the whole batch
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-2)
    # Adam's first step is about lr * sign(g) per entry: bfloat16 rounding
    # may flip the sign of a gradient entry near zero, so the two updates
    # lie within two learning rates of each other
    for k in one:
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(),
                                   atol=2 * cfg.lr + 1e-6, rtol=0)


# -- the compressed training loop against the reference ------------------------

@pytest.mark.parametrize("arch", [ARCH, "mamba2-780m"])
def test_compressed_train_matches_reference(tmp_path, arch):
    # mamba2: the flat leaf order, and so the keep mask, of a non-dense tree
    r_cfg = R_ARCHS[arch].reduced()
    corpus = RCorpus.synthetic(n_docs=64, doc_len=64, vocab=r_cfg.vocab,
                               seed=1)
    r_model = RLM(r_cfg)
    r_params = r_model.init(jax.random.PRNGKey(0))
    tc = dict(steps=3, batch_size=2, seq_len=32, ckpt_every=100,
              grad_compression=0.25, lr=1e-3)
    _, r_report = r_loop.train(
        r_model, r_loop.TrainConfig(ckpt_dir=str(tmp_path / "r"), **tc),
        RPipe(corpus), rng=jax.random.PRNGKey(0))

    t_model = TLM(T_ARCHS[arch].reduced(), device="cpu")
    t_corpus = TCorpus(tokens=corpus.tokens, fact_table=corpus.fact_table,
                       cards=corpus.cards)
    before = t_kgc.launches
    params, t_report = t_loop.train(
        t_model, t_loop.TrainConfig(ckpt_dir=str(tmp_path / "t"), **tc),
        TPipe(t_corpus, device="cpu"),
        params=params_from_numpy(t_model.cfg,
                                 jax.tree.map(np.asarray, r_params),
                                 device="cpu"),
        device="cpu")
    assert t_kgc.launches == before       # the CPU takes the plain version
    assert t_report.restarts == 0 and t_report.steps_run == 3
    np.testing.assert_allclose(t_report.losses, r_report.losses, atol=2e-2,
                               rtol=0)


def test_training_loss_decreases(tmp_path, tiny):
    pipe = TPipe(TCorpus.synthetic(n_docs=32, doc_len=64,
                                   vocab=tiny.cfg.vocab), device="cpu")
    cfg = t_loop.TrainConfig(steps=30, batch_size=4, seq_len=32,
                             ckpt_dir=str(tmp_path), ckpt_every=100, lr=1e-3)
    params, report = t_loop.train(tiny, cfg, pipe, device="cpu")
    assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5])


def test_train_rejects_a_model_on_another_device(tiny):
    pipe = TPipe(TCorpus.synthetic(n_docs=32, doc_len=16,
                                   vocab=tiny.cfg.vocab), device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lives on"):
            t_loop.train(tiny, t_loop.TrainConfig(steps=1), pipe)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_loop.train(tiny, t_loop.TrainConfig(steps=1), pipe)


# -- checkpointing (ports of tests/test_distributed.py) --------------------------

def test_checkpoint_roundtrip(tmp_path, tiny):
    params = tiny.init(torch.Generator().manual_seed(0))
    opt = t_opt.AdamW()
    state = {"params": params, "opt": {"inner": opt.init(params),
                                       "error": t_gc.init_error(params)}}
    state["opt"]["inner"]["m"]["embed"].normal_()
    ckpt.save(str(tmp_path), 7, state, extra={"next_step": 7})
    like = {"params": {k: torch.empty_like(v) for k, v in params.items()},
            "opt": state["opt"]}
    step, restored, extra = ckpt.load(str(tmp_path), like)
    assert step == 7 and extra["next_step"] == 7
    flat_a, flat_b = ckpt._leaf_paths(state), ckpt._leaf_paths(restored)
    assert list(flat_a) == list(flat_b)
    for k in flat_a:
        assert flat_b[k].dtype == flat_a[k].dtype
        assert torch.equal(flat_a[k], flat_b[k]), k


def test_checkpoint_keeps_bf16_moments(tmp_path):
    params = _t(_tree(0))
    opt = t_opt.AdamW(t_opt.AdamWConfig(moment_dtype="bf16"))
    state = opt.init(params)
    for v in state["m"].values():
        v.normal_()
    ckpt.save(str(tmp_path), 1, state)
    manifest = (tmp_path / "step_00000001" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest
    _, restored, _ = ckpt.load(str(tmp_path), opt.init(params))
    for k, v in state["m"].items():
        assert restored["m"][k].dtype == torch.bfloat16
        assert torch.equal(restored["m"][k], v)


def test_checkpoint_atomic_and_gc(tmp_path):
    params = {"w": torch.arange(10.0)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, params, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path)) == 5
    # a half-written step never counts
    (tmp_path / "step_00000009.tmp").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_checkpoint_checksum_detects_corruption(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.arange(4.0)})
    shard = next((tmp_path / "step_00000001").glob("shard_*.npz"))
    data = dict(np.load(shard))
    key = list(data)[0]
    data[key] = data[key] + 1
    np.savez(shard, **data)
    with pytest.raises(IOError):
        ckpt.load(str(tmp_path), {"w": torch.arange(4.0)})


def test_async_snapshot_is_taken_before_returning(tmp_path):
    w = torch.zeros(1000)
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save_async(1, {"w": w})
    w.add_(1.0)                  # an in-place update right after the call
    saver.wait()
    _, restored, _ = ckpt.load(str(tmp_path), {"w": w})
    assert float(restored["w"].abs().max()) == 0.0


# -- fault tolerance ---------------------------------------------------------------

def _pipe(tiny, n_docs=64):
    return TPipe(TCorpus.synthetic(n_docs=n_docs, doc_len=64,
                                   vocab=tiny.cfg.vocab), device="cpu")


def test_train_restarts_after_injected_failure(tmp_path, tiny):
    cfg = t_loop.TrainConfig(steps=9, batch_size=2, seq_len=32,
                             ckpt_dir=str(tmp_path), ckpt_every=3)
    params, report = t_loop.train(tiny, cfg, _pipe(tiny),
                                  inject_failure_at=5, device="cpu")
    assert report.restarts == 1
    # restart replays from step 3 checkpoint: 5 pre-crash + (9-3) post
    assert report.steps_run >= 9
    assert np.isfinite(report.losses).all()


def test_compressed_restart_replays_the_same_losses(tmp_path, tiny):
    """The error-feedback buffer and the moments are restored with the
    params, so the replayed steps give the uninterrupted run's losses."""
    cfg = dict(steps=6, batch_size=2, seq_len=32, ckpt_every=2,
               grad_compression=0.25, lr=1e-3)
    start = tiny.init(torch.Generator().manual_seed(2))
    start = {k: v.detach().clone() for k, v in start.items()}
    _, ref = t_loop.train(tiny, t_loop.TrainConfig(
        ckpt_dir=str(tmp_path / "a"), **cfg), _pipe(tiny), params=start,
        device="cpu")
    _, rep = t_loop.train(tiny, t_loop.TrainConfig(
        ckpt_dir=str(tmp_path / "b"), **cfg), _pipe(tiny), params=start,
        inject_failure_at=3, device="cpu")
    assert rep.restarts == 1 and rep.steps_run == 7
    # steps 0, 1, 2, then the restore from the step-2 checkpoint: 2, 3, 4, 5
    want = ref.losses[:3] + ref.losses[2:]
    np.testing.assert_allclose(rep.losses, want, rtol=1e-6)


def test_default_ckpt_dir_is_fresh():
    a, b = t_loop.TrainConfig(), t_loop.TrainConfig()
    assert a.ckpt_dir != b.ckpt_dir
    assert a.ckpt_dir.startswith(tempfile.gettempdir())


@pytest.mark.parametrize("arch", sorted(T_ARCHS))
def test_launch_train_cli_on_cpu(tmp_path, arch):
    from repro_torch.launch import train as launch
    model, params, report = launch.main([
        "--arch", arch, "--device", "cpu", "--steps", "2", "--compress",
        "0.25", "--batch-size", "2", "--seq-len", "32", "--ckpt-dir",
        str(tmp_path)])
    assert model.cfg.name == f"{arch}-smoke"
    assert report.steps_run == 2 and report.restarts == 0
    assert np.isfinite(report.losses).all()
    assert list(params) == list(model.params())
