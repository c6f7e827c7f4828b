"""End-to-end training on the PyTorch port: train a ~100M-param LM for a few
hundred steps on the card with the bitmap-indexed data pipeline,
fault-tolerant supervision, checkpointing, and (optionally) EWAH gradient
compression, whose block norms the ``block_sqnorms`` kernel computes once a
step.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
        [--compress 0.25] [--full-100m] [--device cpu]

The counterpart of ``examples/train_lm.py``, with the same lines.  The
default model is ~14M params (same qwen2 family, scaled); ``--full-100m``
trains the 100M variant.  Weights are drawn from seed 0 on the device.
``--device`` defaults to ``cuda`` and raises without CUDA; ``--device
cpu`` runs the kernels' plain versions.  Checkpoints go to ``--ckpt-dir``
(default ``repro_torch_train_lm`` in the temporary directory, apart from
the reference's: both packages write one layout, and a run resumes from
the checkpoint it finds there).
"""
import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data.pipeline import BitmapDataPipeline, Corpus
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.train.loop import TrainConfig, train

# a run resumes from the checkpoint it finds here (not the reference's
# directory: both packages write one layout)
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def main(argv=None):
    """Trains and prints; returns (params, report)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--compress", type=float, default=None,
                    help="gradient keep-ratio (e.g. 0.25); off by default")
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = get_config("qwen2-0.5b")
    if args.full_100m:
        cfg = dataclasses.replace(base, name="qwen2-100m", n_layers=12,
                                  d_model=512, n_heads=8, n_kv_heads=2,
                                  head_dim=64, d_ff=2048, vocab=32_000)
    else:
        cfg = dataclasses.replace(base, name="qwen2-14m", n_layers=4,
                                  d_model=256, n_heads=4, n_kv_heads=2,
                                  head_dim=64, d_ff=1024, vocab=8_000)
    model = LM(cfg, device=device)

    corpus = Corpus.synthetic(n_docs=2048, doc_len=256, vocab=cfg.vocab)
    pipe = BitmapDataPipeline(corpus, sort=True, device=device)
    stats = pipe.index_stats()
    print(f"[data] bitmap index: {stats['index_words']:.0f} words "
          f"(unsorted would be {stats['index_words_unsorted']:.0f}; "
          f"sorting gain {stats['compression_gain']:.2f}x)")
    n = pipe.select(conj={"quality": 2})          # bitmap-filtered training set
    print(f"[data] selected {n} docs via bitmap predicate quality==2")

    tcfg = TrainConfig(steps=args.steps, batch_size=8, seq_len=128,
                       ckpt_dir=args.ckpt_dir, ckpt_every=100,
                       grad_compression=args.compress, lr=3e-4)
    t0 = time.time()
    params, report = train(model, tcfg, pipe,
                           inject_failure_at=args.inject_failure,
                           device=device)
    dt = time.time() - t0
    losses = np.asarray(report.losses)
    print(f"[train] {report.steps_run} steps in {dt:.0f}s "
          f"({dt / max(report.steps_run, 1):.2f}s/step), "
          f"restarts={report.restarts}, stragglers={len(report.straggler_events)}")
    print(f"[train] loss {losses[:10].mean():.3f} -> {losses[-10:].mean():.3f}")
    return params, report


if __name__ == "__main__":
    main()
