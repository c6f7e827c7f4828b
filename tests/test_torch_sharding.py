"""The port's sharding rules and meshes against the reference's.

Every parameter of the ten archs at full size (the reference's
``LM(cfg).abstract_params()`` against ``LM(cfg, device="meta")``), on both
production meshes and under all four variants, takes the reference's
``spec_for`` without its stacked axes; per-device bytes are equal; the
cache and batch rules agree.  The reference's rules read only a mesh's
``shape`` and ``axis_names``, so they are given JAX's ``AbstractMesh`` (no
512 devices); the reference's ``make_production_mesh`` itself runs in a
subprocess over 512 placeholder host devices, as its dry-run does.
"""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.configs import input_specs as r_ispec
from repro.distributed import sharding as r_shd
from repro.models.transformer import LM as RLM
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs import get_config
from repro_torch.configs import input_specs as t_ispec
from repro_torch.distributed import sharding as t_shd
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models.transformer import LM, reference_path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("baseline", "opt", "opt_attn", "opt_ep")
MESHES = {"single": False, "multi": True}


def _abstract(mesh: Mesh) -> AbstractMesh:
    return AbstractMesh(mesh.axis_sizes, mesh.axis_names)


def _norm(spec):
    """A spec's entries as tuples of axis names (None: replicated)."""
    return tuple(None if a is None else (a,) if isinstance(a, str)
                 else tuple(a) for a in spec)


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """{reference path: (stacked shape, itemsize)} of the full-size tree."""
    tree = RLM(r_get_config(arch)).abstract_params()
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {r_shd._path_str(p): (tuple(v.shape), v.dtype.itemsize)
            for p, v in leaves}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_and_device_bytes_match_reference(arch, mesh_kind):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_kind])
    amesh = _abstract(mesh)
    ref = _ref_leaves(arch)
    params = LM(get_config(arch), device="meta").params()
    # every reference leaf is covered by its port leaves, index for index
    covered = {}
    for name, p in params.items():
        path, idx = reference_path(name)
        shape, _ = ref[path]
        assert tuple(p.shape) == shape[len(idx):], name
        covered.setdefault(path, set()).add(idx)
    assert set(covered) == set(ref)
    for path, idxs in covered.items():
        lead = ref[path][0][:len(next(iter(idxs)))]
        assert len(idxs) == math.prod(lead), path
    for variant in VARIANTS:
        specs = t_shd.param_shardings(params, mesh, variant)
        port_bytes = t_shd.device_bytes(params, specs, mesh)
        for name, p in params.items():
            path, idx = reference_path(name)
            want = r_shd.spec_for(path, ref[path][0], amesh, variant)
            assert _norm(specs[name]) == _norm(tuple(want)[len(idx):]), \
                (variant, name)
        ref_bytes = 0
        for path, (shape, itemsize) in ref.items():
            want = r_shd.spec_for(path, shape, amesh, variant)
            block = NamedSharding(amesh, want).shard_shape(shape)
            ref_bytes += math.prod(block) * itemsize
        assert port_bytes == ref_bytes, variant


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_and_cache_specs_match_reference(arch, shape_name, mesh_kind):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_kind])
    amesh = _abstract(mesh)
    cfg, rcfg = get_config(arch), r_get_config(arch)
    shape, rshape = SHAPES[shape_name], R_SHAPES[shape_name]
    if shape.kind != "decode":
        got = t_shd.batch_shardings(t_ispec.batch_specs(cfg, shape), mesh)
        want = r_shd.batch_shardings(r_ispec.batch_specs(rcfg, rshape),
                                     amesh)
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v.spec) for k, v in want.items()}
        return
    cache, _ = t_ispec.decode_specs(LM(cfg, device="meta"), shape)
    got = t_shd.cache_shardings(cache, mesh)
    rcache, _ = r_ispec.decode_specs(RLM(rcfg), rshape)
    want = r_shd.cache_shardings(rcache, amesh)
    assert set(want) == set(got) | {"length"}
    for k in got:
        assert _norm(got[k]) == _norm(want[k].spec), k
        sh, dt = cache[k]
        block = NamedSharding(amesh, want[k].spec).shard_shape(sh)
        assert t_shd.shard_shape(sh, got[k], mesh) == block, k
    assert t_shd.cache_shardings({"length": 0}, mesh) == {"length": ()}


def test_production_meshes_match_reference():
    """The reference's meshes over 512 placeholder host devices (in a
    subprocess: the device count is fixed at JAX's first use) have the
    port's descriptors' shapes and axis names."""
    code = ("import json; from repro.launch.mesh import "
            "make_production_mesh as m; print(json.dumps([[dict(x.shape), "
            "list(x.axis_names)] for x in (m(multi_pod=False), "
            "m(multi_pod=True))]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = [[m.shape, list(m.axis_names)] for m in (
        make_production_mesh(multi_pod=False),
        make_production_mesh(multi_pod=True))]
    assert got == want
    assert [m.size for m in (make_production_mesh(),
                             make_production_mesh(multi_pod=True))] \
        == [256, 512]


def test_host_mesh_and_rule_context():
    mesh = make_host_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    with pytest.raises(ValueError):
        make_host_mesh(2, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_host_mesh(1, 1)
    try:
        t_shd.use_mesh_rules(mesh, "opt", bf16_scores=True, moe_buf=False)
        assert t_shd.current_mesh() is mesh
        assert t_shd.current_variant() == "opt"
        assert t_shd.want_bf16_scores() and not t_shd.want_moe_buf_constraint()
        x = torch.ones(2, 3)
        assert t_shd.constrain(x, "activation") is x
        assert t_shd.constrain_moe_buf(x) is x
        assert all(a is b for a, b in zip(t_shd.constrain_qkv(x, x, x),
                                          (x, x, x)))
    finally:
        t_shd.use_mesh_rules(None)
    assert t_shd.current_mesh() is None and not t_shd.want_bf16_scores()
    assert t_shd.want_moe_buf_constraint()


@pytest.mark.parametrize("name,path,idx", [
    ("embed", "embed", ()),
    ("blocks.3.layers.1.attn.wq", "blocks/layers/1/attn/wq", (3,)),
    ("groups.2.4.ssm.in_proj", "groups/ssm/in_proj", (2, 4)),
    ("rest.1.ln1", "rest/ln1", (1,)),
    ("enc_blocks.5.mlp.wi", "enc_blocks/mlp/wi", (5,)),
    ("shared.attn.wo", "shared/attn/wo", ()),
])
def test_reference_path(name, path, idx):
    assert reference_path(name) == (path, idx)
