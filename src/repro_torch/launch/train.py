"""Training launcher: arch selection + bitmap data pipeline + supervision.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 100 [--reduced | --full] [--compress 0.25] [--ckpt-dir DIR] \\
        [--device cuda]

Runs on the card by default (``--device cuda``, which raises without
CUDA); ``--device cpu --reduced`` runs the same code path on the arch's
reduced config on the CPU, with the kernels' plain versions.  Weights are
drawn from seed 0 on the device, the corpus from seed 0 on the host.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--compress", type=float, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv``, train, print a summary; returns (model, params,
    report)."""
    args = parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import BitmapDataPipeline, Corpus
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models.transformer import LM
    from repro_torch.train.loop import TrainConfig, train

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = LM(cfg, device=device)
    corpus = Corpus.synthetic(n_docs=1024, doc_len=max(args.seq_len, 64),
                              vocab=cfg.vocab)
    pipe = BitmapDataPipeline(corpus, sort=True, device=device)
    print(f"[launch.train] {cfg.name}: index stats {pipe.index_stats()}",
          flush=True)
    where = {"ckpt_dir": args.ckpt_dir} if args.ckpt_dir else {}
    tcfg = TrainConfig(steps=args.steps, batch_size=args.batch_size,
                       seq_len=args.seq_len, ckpt_every=args.ckpt_every,
                       grad_compression=args.compress, lr=args.lr, **where)
    params, report = train(model, tcfg, pipe, device=device)
    losses = np.asarray(report.losses)
    print(f"[launch.train] {report.steps_run} steps; restarts="
          f"{report.restarts}; loss {losses[:5].mean():.3f} -> "
          f"{losses[-5:].mean():.3f}", flush=True)
    return model, params, report


if __name__ == "__main__":
    main()
