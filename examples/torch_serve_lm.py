"""Serving example on the PyTorch port: batched greedy decoding with KV
caches, on the card.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen2-0.5b]
        [--device cpu]

The counterpart of ``examples/serve_lm.py``: the reduced config of the
chosen arch, weights drawn from a ``torch.Generator`` seeded 0 on the
device (where the reference draws them from ``jax.random.PRNGKey(0)``),
prompts from NumPy seed 0; the decode path is the same ``serve_step`` the
dry-run counts for the 256/512-device meshes.  ``--device`` defaults to
``cuda`` and raises without CUDA; ``--device cpu`` runs on the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.serve.loop import generate


def main(argv=None):
    """Generates and prints; returns the (batch, prompt + new) tokens."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = LM(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model.init(gen)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    frontend = None
    if cfg.n_frontend_positions:
        frontend = rng.standard_normal(
            (args.batch, cfg.n_frontend_positions, cfg.d_model)).astype(np.float32)

    t0 = time.time()
    out = generate(model, prompts, args.new_tokens,
                   max_len=args.prompt_len + args.new_tokens + 1,
                   frontend=frontend)
    dt = time.time() - t0
    total_new = args.batch * args.new_tokens
    print(f"[serve:{cfg.name}] generated {total_new} tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s batched greedy)")
    print("sample continuation ids:", out[0, args.prompt_len:][:16].tolist())
    return out


if __name__ == "__main__":
    main()
