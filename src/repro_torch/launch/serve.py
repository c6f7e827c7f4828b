"""Serving launcher: batched greedy decoding for any --arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        [--reduced | --full] --batch 4 --new-tokens 32 [--device cuda]

Runs on the card by default (``--device cuda``, which raises without
CUDA); ``--device cpu --reduced`` runs the same code path on the arch's
reduced config on the CPU.  Weights are drawn from seed 0 on the device;
prompts (and an encoder-decoder's frames) from seed 0 on the host.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_inputs(cfg, batch: int, prompt_len: int, seed: int = 0):
    """(prompts (B, S) int32, frontend frames (B, P, D) float32 or None),
    drawn from ``seed`` as the reference's launcher draws them."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab,
                           size=(batch, prompt_len)).astype(np.int32)
    frontend = None
    if cfg.n_frontend_positions:
        frontend = rng.standard_normal(
            (batch, cfg.n_frontend_positions, cfg.d_model)).astype(np.float32)
    return prompts, frontend


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv``, build the model, generate, print a summary; returns
    (model, tokens, report)."""
    args = parse_args(argv)

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models.transformer import LM
    from repro_torch.serve.loop import generate

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = LM(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen)
    prompts, frontend = make_inputs(cfg, args.batch, args.prompt_len)
    timings = {}
    out = generate(model, prompts, args.new_tokens,
                   max_len=args.prompt_len + args.new_tokens + 1,
                   frontend=frontend, timings=timings)
    n = args.batch * args.new_tokens
    dt = timings["prefill_s"] + timings["decode_s"]
    report = {"arch": cfg.name, "params": sum(p.numel()
                                              for p in params.values()),
              "layers": cfg.n_layers, "reduced": args.reduced,
              "batch": args.batch, "prompt_len": args.prompt_len,
              "new_tokens": args.new_tokens, **timings, "tok_s": n / dt,
              "decode_tok_s": n / timings["decode_s"],
              "shape": list(out.shape), "device": str(device)}
    print(f"[launch.serve:{cfg.name}] {n} tokens in {dt:.1f}s "
          f"({n / dt:.1f} tok/s); shape {out.shape}; " + json.dumps(report),
          flush=True)
    return model, out, report


if __name__ == "__main__":
    main()
