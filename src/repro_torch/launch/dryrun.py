"""Dry-run of every (arch × shape × mesh) cell on the meta device.

For each cell the dry-run:
  1. builds the production mesh descriptor (16×16 single-pod / 2×16×16
     multi-pod);
  2. builds the model, the AdamW state and the inputs on ``meta`` (shapes
     and dtypes; nothing is allocated anywhere);
  3. runs the right step once (``make_train_step`` / ``make_prefill_step``
     / ``make_serve_step``) under the op counter (``launch/op_analysis.py``);
  4. writes the reference's record keys to a JSON file: ``status``,
     ``n_devices``, ``mesh_shape``, ``memory_analysis``, the counter's
     totals under ``ops`` (where the reference has ``hlo``),
     ``link_bytes`` and ``seconds``.

Per-device numbers: ``argument_size_in_bytes`` is exact, from the sharding
rules (``distributed/sharding.py``); ``temp_size_in_bytes`` is the one-card
trace's peak live bytes less its arguments.  FLOPs and bytes are the
global step's divided evenly over the mesh, labelled ``even_split``: a
one-card trace cannot see the redundant and collective work of an SPMD
program, so ``collectives`` are empty and ``link_bytes`` is 0.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
Optional knobs, the reference's:
  --no-remat            disable activation checkpointing
  --remat-policy P      full | dots_nb | none
  --no-act-constraints  no mesh rules (the bf16-score switch is off)
  --capacity-factor F   MoE capacity factor override
  --variant V           sharding rules: baseline | opt | opt_attn | opt_ep
  --bf16-scores         attention scores in bfloat16
  --microbatches N      gradient accumulation
  --opt-dtype/--param-dtype f32 | bf16
  --tag NAME            suffix for the result file
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

DEFAULT_OUT = "build/repro_torch/dryrun"


def configure(cfg, args):
    """The config under the run's knobs."""
    if getattr(args, "no_remat", False):
        cfg = dataclasses.replace(cfg, remat=False)
    if getattr(args, "remat_policy", None):
        cfg = dataclasses.replace(cfg, remat_policy=args.remat_policy)
    if getattr(args, "capacity_factor", None) and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=cfg.moe._replace(capacity_factor=args.capacity_factor))
    return cfg


def prepare(cfg, shape, device="meta", args=None):
    """(model, step, step arguments) of one step of ``cfg`` at ``shape`` on
    ``device``.  On ``meta`` every tensor is a stand-in; elsewhere the
    weights are drawn from seed 0 and the inputs are ``concrete_batch``'s
    or, for a decode step, a zeroed cache and tokens from seed 1."""
    from repro_torch.configs import input_specs as ispec
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import LM
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                        make_train_step)
    meta = torch.device(device).type == "meta"
    model = LM(cfg, device=device)
    if not meta:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(0)
        model.init(gen)
    if shape.kind != "decode":
        batch = (ispec.materialize(ispec.batch_specs(cfg, shape), device)
                 if meta else ispec.concrete_batch(cfg, shape,
                                                   device=device))
    if shape.kind == "train":
        params = model.params()
        if getattr(args, "param_dtype", "f32") == "bf16":
            params = {k: v.detach().to(torch.bfloat16)
                      if v.dtype == torch.float32 else v
                      for k, v in params.items()}
        opt = AdamW(AdamWConfig(moment_dtype=getattr(args, "opt_dtype",
                                                     "f32")))
        step = make_train_step(model, opt,
                               n_micro=getattr(args, "microbatches", 1) or 1)
        return model, step, (params, opt.init(params), batch)
    if shape.kind == "prefill":
        return model, make_prefill_step(model), (batch,)
    cache_spec, tok_spec = ispec.decode_specs(model, shape)
    if meta:
        cache = {"length": 0, **ispec.materialize(cache_spec, device)}
        tokens = ispec.materialize({"tokens": tok_spec}, device)["tokens"]
    else:
        cache = dec.init_cache(model, shape.global_batch, shape.seq_len)
        gen = torch.Generator(device=model.device)
        gen.manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, tok_spec[0], generator=gen,
                               device=model.device, dtype=torch.int32)
    return model, make_serve_step(model), (cache, tokens)


def trace(step, step_args):
    """Run ``step(*step_args)`` once under a fresh ``OpCounter`` that
    counts the arguments as live from the start; returns the counter and
    the arguments' bytes."""
    from repro_torch.launch.op_analysis import OpCounter
    counter = OpCounter()
    counter.track(step_args)
    arg_bytes = counter.live_bytes
    with counter:
        out = step(*step_args)
        del out
    return counter, arg_bytes


def argument_bytes(model, shape, step_args, mesh, variant) -> int:
    """Per-device bytes of the step's arguments under the sharding rules."""
    from repro_torch.distributed import sharding as shd
    if shape.kind == "train":
        params, opt_state, batch = step_args
        pspec = shd.param_shardings(params, mesh, variant)
        n = sum(shd.device_bytes(t, pspec, mesh)
                for t in (params, opt_state["m"], opt_state["v"]))
        return n + opt_state["step"].element_size() + shd.device_bytes(
            batch, shd.batch_shardings(batch, mesh), mesh)
    params = model.params()
    n = shd.device_bytes(params, shd.param_shardings(params, mesh, variant),
                         mesh)
    if shape.kind == "prefill":
        (batch,) = step_args
        return n + shd.device_bytes(batch, shd.batch_shardings(batch, mesh),
                                    mesh)
    cache, tokens = step_args
    # tokens go in replicated, as the reference's unspecified sharding
    return n + shd.device_bytes(cache, shd.cache_shardings(cache, mesh),
                                mesh) + tokens.numel() * tokens.element_size()


def run_cell(arch: str, shape_name: str, mesh_kind: str, args,
             traces=None) -> dict:
    """One cell's record.  ``traces`` (a dict the caller keeps) reuses the
    trace of a cell already run at another mesh: the one-card step does not
    depend on the mesh."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import link_bytes

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "tag": getattr(args, "tag", "baseline")}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    cfg = configure(cfg, args)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    variant = getattr(args, "variant", "baseline")
    bf16 = getattr(args, "bf16_scores", False)
    if getattr(args, "no_act_constraints", False):
        shd.use_mesh_rules(None)
    else:
        shd.use_mesh_rules(mesh, variant, bf16_scores=bf16,
                           moe_buf=getattr(args, "moe_buf", "on") != "off")
    try:
        t0 = time.time()
        model, step, step_args = prepare(cfg, shape, "meta", args)
        t_build = time.time() - t0
        args_dev = argument_bytes(model, shape, step_args, mesh, variant)
        key = (arch, shape_name)
        t0 = time.time()
        if traces is not None and key in traces:
            counter, arg_bytes = traces[key]
        else:
            counter, arg_bytes = trace(step, step_args)
            if traces is not None:
                traces.clear()      # one trace kept: meshes run in turn
                traces[key] = (counter, arg_bytes)
        t_trace = time.time() - t0
    finally:
        shd.use_mesh_rules(None)

    n = mesh.size
    tot = counter.totals()
    ops = {"flops": tot["flops"] / n, "bytes": tot["bytes"] / n,
           "matmul_flops": tot["matmul_flops"] / n,
           "collectives": {}, "collective_counts": {},
           "split": "even_split",
           "global": {"flops": tot["flops"], "bytes": tot["bytes"],
                      "matmul_flops": tot["matmul_flops"],
                      "peak_bytes": counter.peak_bytes,
                      "argument_bytes": arg_bytes, "n_ops": counter.n_ops}}
    mem = {"argument_size_in_bytes": args_dev,
           "temp_size_in_bytes": counter.peak_bytes - arg_bytes}
    rec.update(
        status="ok",
        n_devices=n,
        mesh_shape=dict(mesh.shape),
        memory_analysis=mem,
        ops=ops,
        link_bytes=link_bytes(ops["collectives"]),
        seconds={"build": t_build, "trace": t_trace},
    )
    if variant == "opt_ep" and cfg.moe is not None:
        rec["note"] = ("opt_ep traces moe_block: the expert-parallel "
                       "moe_block_ep is not ported (ROADMAP Queue 1 item 16)")
    print(f"[dryrun] {arch} {shape_name} {mesh_kind}: "
          f"flops/dev={ops['flops']:.3e} bytes/dev={ops['bytes']:.3e} "
          f"link_bytes/dev={rec['link_bytes']:.3e} "
          f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
          f"args={args_dev / 2**30:.2f}GiB trace={t_trace:.1f}s (even_split)",
          flush=True)
    return rec


def cell_name(arch: str, shape: str, mesh: str, tag: str = "baseline") -> str:
    return f"{arch}__{shape}__{mesh}" + ("" if tag == "baseline"
                                          else f"__{tag}")


def error_record(arch, shape, mesh, tag, exc) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
            "status": "error", "error": f"{type(exc).__name__}: {exc}"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-act-constraints", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt", "opt_attn", "opt_ep"])
    ap.add_argument("--bf16-scores", action="store_true")
    ap.add_argument("--moe-buf", default="on", choices=["on", "off"])
    ap.add_argument("--remat-policy", default=None,
                    choices=["full", "dots_nb", "none"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--param-dtype", default="f32", choices=["f32", "bf16"])
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    from repro_torch.configs import ARCHS, SHAPES
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = 0
    traces: dict = {}
    for a in archs:
        for s in shapes:
            for m in meshes:
                path = out_dir / f"{cell_name(a, s, m, args.tag)}.json"
                try:
                    rec = run_cell(a, s, m, args, traces)
                except Exception as e:  # noqa: BLE001 — record and go on
                    traceback.print_exc()
                    rec = error_record(a, s, m, args.tag, e)
                    failures += 1
                path.write_text(json.dumps(rec, indent=1))
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
