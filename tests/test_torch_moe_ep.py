"""The expert-parallel MoE over ``gloo`` ranks on the CPU against the
reference's ``moe_block_ep`` (a ``shard_map`` over 8 forced host devices).

The same parameters and tokens, made from a seed with NumPy, go through the
reference in one JAX subprocess and through the port's
``moe_block_ep_replicated`` in one process a rank, spawned once per job:
8 ranks for the 2 x 4 (data, model) mesh of ``tests/test_ep_dispatch.py``
and a 2 x 2 x 2 (pod, data, model) mesh, 4 ranks for a 1 x 4 mesh.  Each
rank joins the job through a file store under the test's ``tmp_path``
and runs one torch thread.  Cases: the sequence split over ``model`` (8
positions) and not (6: every model rank of an F row routes the same
tokens); capacity factor 8 (nothing dropped) and 1.0 (tokens dropped at
both capacities).

Tolerances, float32 compute in both packages: outputs rtol 1e-5 (float32
products in another order), the aux loss rtol 1e-6, the tokens that lose a
slot equal as sets, every gradient (``wi``'s among them) rtol 1e-4 with
an absolute floor of 1e-4 x its largest entry.  A reduced arctic LM under
``opt_ep`` on the 4 ranks gives the single-process logits, and where every
rank routes the whole batch the single-process loss and gradients, at rtol
1e-4 (a capacity factor at which neither path drops a token).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 240
D, E, K, FF = 16, 8, 2, 32
CASES = [(b, s, cf) for b, s in ((4, 8), (4, 6)) for cf in (8.0, 1.0)]
MESHES = {"2x4": (("data", "model"), (2, 4)),
          "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
          "1x4": (("data", "model"), (1, 4))}
JOBS = {8: ["2x4", "2x2x2"], 4: ["1x4"]}


def _case_name(b, s, cf):
    return f"b{b}s{s}cf{cf:g}"


def _inputs(path):
    rng = np.random.default_rng(0)
    arrays = {
        "router": rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5,
        "wi": rng.standard_normal((E, D, FF)).astype(np.float32) * D ** -0.5,
        "wg": rng.standard_normal((E, D, FF)).astype(np.float32) * D ** -0.5,
        "wo": rng.standard_normal((E, FF, D)).astype(np.float32) * FF ** -0.5,
    }
    for b, s, cf in CASES:
        arrays["x_" + _case_name(b, s, cf)] = rng.standard_normal(
            (b, s, D)).astype(np.float32)
    np.savez(path, **arrays)


REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.models import layers
from repro.models.moe import MoESpec, moe_block_ep
layers.COMPUTE_DTYPE = jnp.float32
inp = dict(np.load(sys.argv[1]))
meshes, cases = eval(sys.argv[3]), eval(sys.argv[4])
params = {k: jnp.asarray(inp[k]) for k in ("router", "wi", "wg", "wo")}
out = {}
for mname, (names, shape) in meshes.items():
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
    for b, s, cf in cases:
        case = f"b{b}s{s}cf{cf:g}"
        spec = MoESpec(n_experts=%d, top_k=%d, d_ff=%d, capacity_factor=cf)
        x = jnp.asarray(inp["x_" + case])
        def objective(p, x):
            y, aux = moe_block_ep(p, spec, x, mesh)
            return y.sum() + aux, (y, aux)
        with mesh:
            (_, (y, aux)), (g, gx) = jax.jit(jax.value_and_grad(
                objective, argnums=(0, 1), has_aux=True))(params, x)
        key = f"{mname}_{case}"
        out[key + "_y"] = np.asarray(y)
        out[key + "_aux"] = np.asarray(aux)
        for k in params:
            out[key + "_g" + k] = np.asarray(g[k])
        out[key + "_gx"] = np.asarray(gx)
np.savez(sys.argv[2], **out)
print("OK")
""" % (E, K, FF)


RANK = r"""
import json, os, sys
sys.path.insert(0, "src")
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.models import layers
from repro_torch.models.moe import MoESpec, moe_block_ep_replicated
from repro_torch.launch.mesh import Mesh, process_mesh
layers.COMPUTE_DTYPE = torch.float32
rank = int(sys.argv[1])
inp, store, out_dir = sys.argv[2], sys.argv[3], sys.argv[4]
meshes, cases, lm = eval(sys.argv[5]), eval(sys.argv[6]), sys.argv[7] == "1"
inp = dict(np.load(inp))
out = {}
for mname, (names, shape) in meshes.items():
    pm = process_mesh(Mesh(names, shape), "cpu",
                      init_method="file://" + store, rank=rank)
    for b, s, cf in cases:
        case = f"b{b}s{s}cf{cf:g}"
        spec = MoESpec(n_experts=%d, top_k=%d, d_ff=%d, capacity_factor=cf)
        params = {k: torch.from_numpy(inp[k]).requires_grad_(True)
                  for k in ("router", "wi", "wg", "wo")}
        x = torch.from_numpy(inp["x_" + case]).requires_grad_(True)
        y, aux = moe_block_ep_replicated(params, spec, x, pm)
        (y.sum() + aux).backward()
        key = f"{mname}_{case}"
        out[key + "_y"] = y.detach().numpy()
        out[key + "_aux"] = aux.detach().numpy()
        for k, v in params.items():
            out[key + "_g" + k] = v.grad.numpy()
        out[key + "_gx"] = x.grad.numpy()
if lm:
    # a reduced arctic LM (4 experts, capacity factor 2: nothing drops),
    # single process and then under opt_ep
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import LM
    from repro_torch.train.step import value_and_grad
    cfg = get_config("arctic-480b").reduced()
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    model.load_params(params)
    for s in (15, 16):
        tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, s))
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
        with torch.no_grad():
            logits, _ = model(batch)
        loss, grads = value_and_grad(model, params, batch)
        sharding.use_mesh_rules(pm, "opt_ep")
        with torch.no_grad():
            logits_ep, _ = model(batch)
        loss_ep, grads_ep = value_and_grad(model, params, batch)
        sharding.use_mesh_rules(None)
        out[f"lm{s}_logits"] = logits.numpy()
        out[f"lm{s}_logits_ep"] = logits_ep.numpy()
        out[f"lm{s}_loss"] = loss.numpy()
        out[f"lm{s}_loss_ep"] = loss_ep.numpy()
        for k in grads:
            out[f"lm{s}_g_" + k] = grads[k].numpy()
            out[f"lm{s}_gep_" + k] = grads_ep[k].numpy()
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
dist.destroy_process_group()
""" % (E, K, FF)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    return env


def _spawn(world, meshes, inputs, tmp, lm):
    """One process a rank; every rank's results, by rank."""
    out = tmp / f"ranks{world}"
    out.mkdir()
    store = tmp / f"store{world}"
    spec = {m: MESHES[m] for m in meshes}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(inputs), str(store),
         str(out), repr(spec), repr(CASES), "1" if lm else "0"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks {bad} failed:\n" + "\n".join(
        log[-3000:] for log in logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and every rank's, per job."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = tmp / "inputs.npz"
    _inputs(inputs)
    env = dict(_env(), JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH")
    ref_out = tmp / "reference.npz"
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inputs), str(ref_out),
         repr(MESHES), repr(CASES)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = {world: _spawn(world, meshes, inputs, tmp, lm=world == 4)
                 for world, meshes in JOBS.items()}
        log = ref.communicate(timeout=SPAWN_TIMEOUT_S)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in log, log[-3000:]
    return dict(np.load(ref_out)), ranks


def _ranks_of(mesh):
    return next(w for w, meshes in JOBS.items() if mesh in meshes)


@pytest.mark.parametrize("case", [_case_name(*c) for c in CASES])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_outputs_and_aux_match_reference(runs, mesh, case):
    ref, ranks = runs
    key = f"{mesh}_{case}"
    want_y, want_aux = ref[key + "_y"], ref[key + "_aux"]
    for r, got in enumerate(ranks[_ranks_of(mesh)]):
        np.testing.assert_allclose(got[key + "_y"], want_y, rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[key + "_aux"], want_aux, rtol=1e-6,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dropped_tokens_match_reference(runs, mesh):
    """At capacity factor 1.0 both packages drop slots, and the same ones:
    the tokens whose output leaves the drop-free one's, and those that
    lose every slot (an output of zeros), are equal as sets."""
    ref, ranks = runs
    got = ranks[_ranks_of(mesh)][0]
    for b, s in {(b, s) for b, s, _ in CASES}:
        full, tight = (f"{mesh}_{_case_name(b, s, cf)}_y" for cf in (8.0, 1.0))
        changed = {}
        for who, res in (("reference", ref), ("port", got)):
            y_full = res[full].reshape(b * s, D)
            y = res[tight].reshape(b * s, D)
            changed[who] = (
                set(np.flatnonzero(~np.isclose(y, y_full, rtol=1e-4,
                                               atol=1e-6).all(-1))),
                set(np.flatnonzero((y == 0).all(-1))))
        assert changed["port"] == changed["reference"]
        assert changed["reference"][0], "capacity 1.0 dropped nothing"


@pytest.mark.parametrize("case", [_case_name(*c) for c in CASES])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_reference(runs, mesh, case):
    """The gradients of ``y.sum() + aux`` in every parameter and in x,
    whole on every rank, against ``jax.grad`` of the reference's
    ``shard_map`` (``wi`` among them)."""
    ref, ranks = runs
    for leaf in ("wi", "wg", "wo", "router", "x"):
        key = f"{mesh}_{case}_g{leaf}"
        want = ref[key]
        for r, got in enumerate(ranks[_ranks_of(mesh)]):
            np.testing.assert_allclose(got[key], want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"rank {r}: {leaf}")


@pytest.mark.parametrize("seq", [15, 16])
def test_arctic_lm_under_opt_ep_matches_single_process(runs, seq):
    """At 15 positions every model rank routes the whole batch, so the aux
    loss is the single process's and the loss and every gradient match.
    At 16 the sequence splits over the 4 ranks and each routes a quarter:
    the logits match, and the aux loss is the mean of the four quarters'
    (as the reference's ``pmean`` makes it), not the whole batch's."""
    _, ranks = runs
    for r, got in enumerate(ranks[4]):
        pre = f"lm{seq}_"
        np.testing.assert_allclose(got[pre + "logits_ep"], got[pre + "logits"],
                                   rtol=1e-4, atol=1e-5, err_msg=f"rank {r}")
        if seq == 16:
            continue
        np.testing.assert_allclose(got[pre + "loss_ep"], got[pre + "loss"],
                                   rtol=1e-4, err_msg=f"rank {r}")
        names = [k[len(pre + "g_"):] for k in got
                 if k.startswith(pre + "g_")]
        assert any(".moe.wi" in k for k in names)
        for k in names:
            want = got[pre + "g_" + k]
            np.testing.assert_allclose(
                got[pre + "gep_" + k], want, rtol=1e-4,
                atol=1e-4 * np.abs(want).max(), err_msg=f"rank {r}: {k}")


SMOKE = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
import chip_smoke as s
s.DEVICE, s.EP_FULL = "cpu", False
print("LINE " + json.dumps(s.ep_phase(torch)))
"""


def test_smoke_ep_phase_on_cpu():
    """The smoke's EP phase at the reduced width over 2 gloo ranks, in a
    fresh interpreter (it spawns its ranks): every gate passes, no kernel
    of the port is launched, and the aux loss and outputs equal
    ``moe_block``'s."""
    res = subprocess.run([sys.executable, "-c", SMOKE, str(ROOT)], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.split("LINE ", 1)[1])
    assert line["world_size"] == 2 and line["experts"] == 4
    assert line["rel_err"] < 2e-2 and line["aux_ep"] == line["aux_ref"]
    assert line["bwd_experts"] == 4 and line["wi_grad_norm"] > 0
    assert not any(line["launches"].values())
