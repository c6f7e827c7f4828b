"""The collectives of the port's ``moe_block_ep``, counted by the cost
counter on ``meta`` under a fake process group, against the reference's
HLO counts, and the dry-run's ``opt_ep`` records that carry them.

The reference's ``moe_block_ep`` is compiled alone under its
``shard_map`` over 8 forced host devices, in one JAX subprocess, and its
compiled HLO read by ``repro.launch.hlo_analysis.analyze_text``: per
device, each collective's larger of operand and result bytes by kind,
the largest replica group, and the count.  The port's runs on rank 0's
block and shards of a fake group of 8 (``launch.mesh.fake_process_mesh``)
under ``OpCounter``, in its ``moe_block_ep`` scope.  Meshes, widths and
cases are those of ``tests/test_torch_moe_ep.py``: the (2, 4) and
(2, 2, 2) meshes, D 16, E 8, top-2, FF 32; sequences that split over
``model`` (8) and do not (6); capacity factors 8 and 1.0.

The forward's collectives are equal in every field, and so is
``link_bytes``.  With the backward, the all-to-alls (3 + 2), all-gathers
(1 + 1) and reduce-scatters (1 + 1) are equal; the all-reduces are not,
by the amount each side's own parts account for exactly: the reference's
backward psums the gradients of its replicated inputs (the router, and
the tokens where the sequence does not split over ``model``) inside the
``shard_map`` transpose, and transposes ``pmean`` locally; the port sums
those gradients in its replication glue (``_ShardIn``'s backward, outside
the body) and all-reduces the aux loss's cotangent (``_Mean``'s
backward, 4 bytes).
"""
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, fake_process_mesh
from repro_torch.launch.op_analysis import OpCounter, link_bytes
from repro_torch.models import layers as t_layers
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parent.parent
D, E, K, FF = 16, 8, 2, 32
AUX_BYTES = 4                       # the float32 aux loss
CASES = [(4, 8, 8.0), (4, 8, 1.0), (4, 6, 8.0), (4, 6, 1.0)]
MESHES = {"2x4": (("data", "model"), (2, 4)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
SHAPES = {"router": (D, E), "wi": (E, D, FF), "wg": (E, D, FF),
          "wo": (E, FF, D)}
KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce")

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.launch.hlo_analysis import analyze_text
from repro.models import layers
from repro.models.moe import MoESpec, moe_block_ep
layers.COMPUTE_DTYPE = jnp.float32
meshes, cases, shapes = eval(sys.argv[1]), eval(sys.argv[2]), eval(sys.argv[3])
params = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
out = {}
for mname, (names, shape) in meshes.items():
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(shape), names)
    for b, s, cf in cases:
        spec = MoESpec(n_experts=%d, top_k=%d, d_ff=%d, capacity_factor=cf)
        x = jax.ShapeDtypeStruct((b, s, %d), jnp.float32)
        def forward(p, x):
            return moe_block_ep(p, spec, x, mesh)
        def objective(p, x):
            y, aux = moe_block_ep(p, spec, x, mesh)
            return y.sum() + aux
        with mesh:
            for which, fn in (("fwd", forward),
                              ("bwd", jax.grad(objective, argnums=(0, 1)))):
                text = jax.jit(fn).lower(params, x).compile().as_text()
                h = analyze_text(text)
                out[f"{mname} {b} {s} {cf:g} {which}"] = {
                    "collectives": h["collectives"],
                    "collective_counts": h["collective_counts"]}
print(json.dumps(out))
""" % (E, K, FF, D)


@pytest.fixture(scope="module")
def reference():
    """The reference's counts, by "mesh b s cf fwd|bwd"."""
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE, repr(MESHES), repr(CASES),
         repr(SHAPES)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _port(mesh_name, b, s, cf, backward):
    """The port's body scope totals on meta under a fake group of 8."""
    names, shape = MESHES[mesh_name]
    spec = moe.MoESpec(E, K, FF, cf)
    with fake_process_mesh(Mesh(names, shape)) as pm:
        params = {k: torch.empty(v, device="meta", requires_grad=backward)
                  for k, v in SHAPES.items()}
        x = torch.empty((b, s, D), device="meta", requires_grad=backward)
        counter = OpCounter()
        with counter:
            shards = moe.ep_shards(params, pm)
            x_l = moe._ShardIn.apply(x, moe._token_spec(pm, s), pm)
            y, aux = moe.moe_block_ep(shards, spec, x_l, pm)
            if backward:
                torch.autograd.grad(y.sum() + aux, [x_l, *shards.values()])
    assert not dist_up()
    return counter.totals(moe.EP_SCOPE), x_l.shape


def dist_up() -> bool:
    return torch.distributed.is_initialized()


@pytest.fixture(autouse=True)
def _float32(monkeypatch):
    """float32 compute, as the reference's subprocess sets it."""
    monkeypatch.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)


def _kind(totals, kind):
    return (totals["collectives"].get(kind, 0.0),
            totals["collectives"].get(kind + ":group", 0.0),
            totals["collective_counts"].get(kind, 0.0))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"b{c[0]}s{c[1]}cf{c[2]:g}")
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_forward_collectives_equal_the_reference_hlo(reference, mesh_name,
                                                     case):
    b, s, cf = case
    want = reference[f"{mesh_name} {b} {s} {cf:g} fwd"]
    got, _ = _port(mesh_name, b, s, cf, backward=False)
    for kind in KINDS:
        assert _kind(got, kind) == _kind(want, kind), kind
    assert got["collectives"] == want["collectives"]
    assert got["collective_counts"] == want["collective_counts"]
    assert link_bytes(got["collectives"]) == link_bytes(want["collectives"])
    assert link_bytes(got["collectives"]) > 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"b{c[0]}s{c[1]}cf{c[2]:g}")
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_backward_collectives_against_the_reference_hlo(reference,
                                                        mesh_name, case):
    b, s, cf = case
    want = reference[f"{mesh_name} {b} {s} {cf:g} bwd"]
    got, x_block = _port(mesh_name, b, s, cf, backward=True)
    for kind in ("all-to-all", "all-gather", "reduce-scatter"):
        assert _kind(got, kind) == _kind(want, kind), kind
    assert got["collective_counts"]["all-to-all"] == 5
    # the all-reduces: what each side's own parts account for
    M = dict(zip(*MESHES[mesh_name]))["model"]
    replicated = D * E * 4                                  # the router
    if s % M:                       # the tokens too, replicated on model
        replicated += x_block.numel() * 4
    ref_bytes, ref_group, ref_count = _kind(want, "all-reduce")
    port_bytes, port_group, port_count = _kind(got, "all-reduce")
    assert ref_bytes == AUX_BYTES + replicated, (ref_bytes, replicated)
    assert ref_count == 2 + bool(s % M)
    assert port_bytes == 2 * AUX_BYTES and port_count == 2
    assert port_group == ref_group == 8
    gap = link_bytes(want["collectives"]) - link_bytes(got["collectives"])
    assert gap == pytest.approx(2 * 7 / 8 * (ref_bytes - port_bytes)), (
        f"link bytes differ by {gap}: the reference's all-reduces carry "
        f"{ref_bytes} bytes, the port's body {port_bytes}")


def _reduced_arctic(monkeypatch):
    """``run_cell``'s configs with arctic-480b reduced, its 4 experts made
    16 so that they split over the 16 model ranks of the single mesh."""
    real = t_configs.get_config

    def get_config(arch):
        cfg = real(arch)
        if arch != "arctic-480b":
            return cfg
        cfg = cfg.reduced()
        return replace(cfg, moe=cfg.moe._replace(n_experts=16))

    monkeypatch.setattr(t_configs, "get_config", get_config)
    return get_config("arctic-480b")


def test_dryrun_opt_ep_record_counts_the_ep_bodies(monkeypatch):
    cfg = _reduced_arctic(monkeypatch)
    ep = dryrun.run_cell("arctic-480b", "train_4k", "single",
                         SimpleNamespace(variant="opt_ep", tag="opt_ep"))
    assert not dist_up()        # the fake group is gone after the trace
    ops, L = ep["ops"], cfg.n_layers
    assert ep["status"] == "ok" and ep["link_bytes"] > 0
    assert ops["collectives"]["all-to-all:group"] == 16
    assert ops["collectives"]["all-gather:group"] == 16
    # per layer: forward, its recomputation (remat "full") and backward
    assert ops["collective_counts"] == {"all-gather": 3.0 * L,
                                        "all-reduce": 3.0 * L,
                                        "all-to-all": 8.0 * L,
                                        "reduce-scatter": 3.0 * L}
    assert ep["link_bytes"] == link_bytes(ops["collectives"])
    n, glob, body = ep["n_devices"], ops["global"], ops["per_device"]
    for k in ("flops", "bytes", "matmul_flops"):
        assert ops[k] == pytest.approx(glob[k] / n + body[k])
    assert body["matmul_flops"] > 0
    assert ops["replication"]["collective_counts"]["all-gather"] > 0
    assert "note" not in ep


def test_dryrun_baseline_record_keeps_its_keys(monkeypatch):
    _reduced_arctic(monkeypatch)
    base = dryrun.run_cell("arctic-480b", "train_4k", "single",
                           SimpleNamespace(variant="baseline",
                                           tag="baseline"))
    assert base["status"] == "ok" and base["link_bytes"] == 0.0
    ops = base["ops"]
    assert set(ops) == {"flops", "bytes", "matmul_flops", "collectives",
                        "collective_counts", "split", "global"}
    assert ops["collectives"] == {} and ops["collective_counts"] == {}
    assert ops["flops"] * base["n_devices"] == pytest.approx(
        ops["global"]["flops"])
