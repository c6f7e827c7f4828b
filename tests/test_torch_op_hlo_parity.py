"""The product FLOPs that the op counter finds in the port's steps against
the ``dot`` FLOPs that the reference's ``HloAnalysis`` finds in the same
step compiled for the CPU, weighted by trip count as ``breakdown.py``
weights them: prefill, decode, and train under each remat policy, for a
reduced dense, moe, ssm, hybrid and encoder-decoder config.

Convolutions are compared apart: the reference's CPU HLO lowers the
depthwise filter gradient of the SSM's conv as a dense C x C convolution,
which its parser costs at C times the depthwise work; the counter costs
the depthwise work (``test_torch_op_analysis.py``).  The ssm and hybrid
training steps differ by 0.13-0.17% (the reference's backward contracts a
few more products): the tolerance is 1%.
"""
import dataclasses
import re

import jax
import pytest

from repro.configs import ShapeConfig as RShape
from repro.configs import get_config as r_get_config
from repro.configs import input_specs as r_ispec
from repro.launch import hlo_analysis as H
from repro.models.transformer import LM as RLM
from repro.train.optimizer import AdamW as RAdamW
from repro.train.step import make_prefill_step, make_serve_step, \
    make_train_step
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun

# the hybrid and the encoder-decoder, the slowest to compile, are in
# test_torch_op_hlo_parity_hybrid.py
ARCHS = ["qwen2-0.5b", "arctic-480b", "mamba2-780m"]
CASES = [("train", "full"), ("train", "dots_nb"), ("train", "none"),
         ("prefill", "full"), ("decode", "full")]
B, S = 2, 32
PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")


def hlo_flops(text: str):
    """(dot FLOPs, convolution FLOPs) of a compiled module, each
    instruction weighted by the trip counts of the loops around it (the
    walk of ``repro.launch.breakdown``)."""
    a = H.HloAnalysis(text)
    weights, order = {a.entry: 1.0}, [a.entry]
    for name in order:
        w = weights[name]
        for line in a.computations.get(name, []):
            if " while(" in line:
                tm = H._TRIP_RE.search(line)
                trips = float(tm.group(1)) if tm else 1.0
                for pat in (H._BODY_RE, H._COND_RE):
                    m = pat.search(line)
                    if m and m.group(1) in a.computations:
                        weights[m.group(1)] = weights.get(m.group(1), 0) \
                            + w * trips
                        order.append(m.group(1))
            for m in H._CALLS_RE.finditer(line):
                if m.group(1) in a.computations and m.group(1) not in weights:
                    weights[m.group(1)] = w
                    order.append(m.group(1))
    out = {"dot": 0.0, "convolution": 0.0}
    for name, w in weights.items():
        for line in a.computations.get(name, []):
            op = re.search(r"\s([a-z][a-z0-9\-]*)\(", line)
            if op and op.group(1) in out:
                out[op.group(1)] += a._instr_cost(name, line).flops * w
    return out["dot"], out["convolution"]


def reference(arch, kind, policy):
    cfg = dataclasses.replace(r_get_config(arch).reduced(),
                              remat_policy=policy)
    shape = RShape("t", S, B, kind)
    model = RLM(cfg)
    params = model.abstract_params()
    if kind == "train":
        opt = RAdamW()
        lowered = jax.jit(make_train_step(model, opt)).lower(
            params, jax.eval_shape(opt.init, params),
            r_ispec.batch_specs(cfg, shape))
    elif kind == "prefill":
        lowered = jax.jit(make_prefill_step(model)).lower(
            params, r_ispec.batch_specs(cfg, shape))
    else:
        cache, tokens = r_ispec.decode_specs(model, shape)
        lowered = jax.jit(make_serve_step(model)).lower(params, cache,
                                                        tokens)
    # the HLO passes that decide the products run at every level; level 0
    # only makes the CPU code generation cheaper
    return hlo_flops(lowered.compile(compiler_options={
        "xla_backend_optimization_level": 0}).as_text())


def port(arch, kind, policy):
    """(product FLOPs, forward convolution FLOPs) of the port's step."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              remat_policy=policy)
    _, step, args = dryrun.prepare(cfg, ShapeConfig("t", S, B, kind),
                                   "meta")
    counter, _ = dryrun.trace(step, args)
    flops = {}
    for (op, _), (_, f, _) in counter.records.items():
        flops[op] = flops.get(op, 0.0) + f
    return sum(flops.get(op, 0.0) for op in PRODUCTS), \
        flops.get("convolution", 0.0)


def check(arch, kind, policy):
    ref_dot, ref_conv = reference(arch, kind, policy)
    got, conv = port(arch, kind, policy)
    assert ref_dot > 0
    assert abs(got - ref_dot) <= 0.01 * ref_dot, (got, ref_dot)
    if kind == "prefill":
        # the forward's depthwise convolutions: the same work
        assert conv == ref_conv


@pytest.mark.parametrize("kind,policy", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_product_flops_match_reference_hlo(arch, kind, policy):
    check(arch, kind, policy)
