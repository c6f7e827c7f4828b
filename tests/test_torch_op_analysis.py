"""The op counter (``repro_torch.launch.op_analysis``): exact product
FLOPs, views counting no bytes, peak live bytes, a kernel wrapper's
reported launch, the reference's ``link_bytes``, the backward and the
recomputation against ``torch.utils.flop_counter.FlopCounterMode``, and
what each remat policy adds.  (The steps' product FLOPs against the
reference's compiled HLO are in ``test_torch_op_hlo_parity.py``.)"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as H
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels import grad_compress
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpCounter, link_bytes


def _count(fn, *args):
    c = OpCounter()
    c.track(args)
    with c:
        fn(*args)
    return c


def test_mm_bmm_addmm_einsum_flops():
    a, b = torch.randn(4, 8), torch.randn(8, 16)
    assert _count(torch.mm, a, b).matmul_flops == 2 * 4 * 16 * 8
    bias = torch.randn(16)
    assert _count(torch.addmm, bias, a, b).matmul_flops == 2 * 4 * 16 * 8
    x, y = torch.randn(3, 4, 8), torch.randn(3, 8, 16)
    assert _count(torch.bmm, x, y).matmul_flops == 2 * 3 * 4 * 16 * 8
    c = _count(lambda x, y: torch.einsum("bij,bjk->bik", x, y), x, y)
    assert c.matmul_flops == 2 * 3 * 4 * 16 * 8
    # (B, S, D) @ (D, F) folds to one mm
    c = _count(torch.matmul, torch.randn(2, 5, 8), b)
    assert c.matmul_flops == 2 * 2 * 5 * 16 * 8
    assert [op for op, _ in c.records if op in ("mm", "bmm")] == ["mm"]
    # depthwise conv: 2 x output x window
    u, w = torch.randn(2, 6, 10), torch.randn(6, 1, 4)
    c = _count(lambda u, w: torch.nn.functional.conv1d(u, w, groups=6), u, w)
    assert c.matmul_flops == 2 * (2 * 6 * 7) * 4
    # an elementwise op is 1 FLOP an output element, not a product
    c = _count(torch.add, a, a)
    assert c.flops == 32 and c.matmul_flops == 0
    assert c.bytes == 3 * 32 * 4


def test_views_count_no_bytes():
    x = torch.randn(4, 8)
    c = _count(lambda x: (x.view(8, 4), x.t(), x.reshape(32),
                          x[None].expand(3, 4, 8), x.detach(),
                          x.as_strided((2, 2), (1, 1)), x[1:3]), x)
    assert c.bytes == 0 and c.flops == 0 and c.n_ops == 0
    # a copy is bytes and no FLOPs; an in-place op counts its output
    c = _count(lambda x: x.clone(), x)
    assert c.bytes == 2 * 32 * 4 and c.flops == 0
    c = _count(lambda x: x.add_(1.0), x)
    assert c.bytes == 2 * 32 * 4 and c.flops == 32


def test_peak_follows_frees_and_the_autograd_graph():
    n = 1000
    x = torch.randn(n)
    c = OpCounter()
    c.track(x)
    with c:
        y = x * 2
        z = y * 2
        del y
        w = z * 2
        del z, w
    assert c.peak_bytes == 3 * 4 * n
    assert c.live_bytes == 4 * n
    # a tensor the graph saved lives until the graph lets it go
    a = torch.randn(n, requires_grad=True)
    c = OpCounter()
    c.track(a)
    with c:
        b = a * 2
        d = b.exp()          # saves its result
        del b
        mid = c.live_bytes   # a and d (mul by a number saves nothing)
        loss = d.sum()
        del d
        held = c.live_bytes
        loss.backward()
        del loss
    assert held >= 2 * 4 * n   # a and exp's saved result
    assert c.live_bytes <= mid
    assert c.peak_bytes >= 3 * 4 * n


def test_kernel_wrapper_reports_its_launch():
    """``block_sqnorms`` on a meta tensor launches nothing and reports the
    launch the card would make: one op, its bytes, no FLOPs."""
    n = 256 * 40 + 17
    g = torch.empty(n, device="meta")
    before = grad_compress.launches
    c = _count(grad_compress.block_sqnorms, g)
    assert grad_compress.launches == before
    recs = {k: v for k, v in c.records.items() if k[0] == "block_sqnorms"}
    assert list(recs) == [("block_sqnorms", "kernels.grad_compress._launch")]
    count, flops, n_bytes = recs[("block_sqnorms",
                                  "kernels.grad_compress._launch")]
    n_pad = 256 * 41
    assert (count, flops, n_bytes) == (1, 0.0, n_pad * 4 + 41 * 4)
    out = grad_compress.block_sqnorms(g)
    assert out.is_meta and out.shape == (41,)


@pytest.mark.parametrize("coll", [
    {},
    {"all-reduce": 1000.0, "all-reduce:group": 4, "all-gather": 800.0,
     "all-gather:group": 2, "collective-permute": 100.0},
    {"reduce-scatter": 512.0, "reduce-scatter:group": 16,
     "all-to-all": 64.0, "all-to-all:group": 1},
    {"all-reduce": 7.0},
])
def test_link_bytes_equals_reference(coll):
    assert link_bytes(coll) == H.link_bytes(coll)


def test_totals_have_the_reference_keys():
    c = _count(torch.mm, torch.randn(2, 3), torch.randn(3, 4))
    t = c.totals()
    assert {"flops", "bytes", "collectives", "collective_counts"} <= set(t)
    assert t["collectives"] == {} and t["collective_counts"] == {}


def _train(arch, policy, S=32, B=2):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              remat_policy=policy)
    _, step, args = dryrun.prepare(cfg, ShapeConfig("t", S, B, "train"),
                                   "meta")
    return step, args


@pytest.mark.parametrize("policy", ["full", "dots_nb", "none"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m"])
def test_backward_and_recompute_match_flop_counter_mode(arch, policy):
    """The counter sees the backward and the recomputation: its FLOPs of
    every product op equal FlopCounterMode's over the same step.  The one
    exception is the depthwise convolution's backward, where
    FlopCounterMode costs the weight gradient as a dense convolution
    (channels times too much); the counter's is the depthwise work, the
    forward's FLOPs for each of the two gradients."""
    step, args = _train(arch, policy)
    c = OpCounter()
    c.track(args)
    with FlopCounterMode(display=False) as f, c:
        step(*args)
    theirs = {str(k).split(".")[-1]: v
              for k, v in f.get_flop_counts()["Global"].items()}
    ours = {}
    for (op, _), (_, flops, _) in c.records.items():
        if op in theirs:
            ours[op] = ours.get(op, 0) + flops
    assert {"mm", "bmm"} <= set(ours)
    conv_bwd = ours.pop("convolution_backward", 0)
    theirs.pop("convolution_backward", None)
    assert ours == theirs
    cfg = get_config(arch).reduced()
    if cfg.ssm is not None:
        forward = 2 * 2 * 32 * cfg.ssm.conv_channels * cfg.ssm.d_conv
        assert conv_bwd == 2 * forward * cfg.n_layers
    else:
        assert conv_bwd == 0


def _mm(arch, policy, kind="train", early_stop=True):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              remat_policy=policy)
    _, step, args = dryrun.prepare(cfg, ShapeConfig("t", 32, 2, kind),
                                   "meta")
    with set_checkpoint_early_stop(early_stop):
        c, _ = dryrun.trace(step, args)
    return c.matmul_flops


def test_full_remat_adds_one_forward_of_the_regions():
    """qwen2 (every product but the logits inside a block): ``full`` adds
    exactly one forward's products of the blocks when the recomputation
    runs whole; by default it stops after the last saved tensor, so each
    block's last product (the MLP's ``wo``) is not recomputed, as XLA
    drops it from the reference's recomputation."""
    cfg = get_config("qwen2-0.5b").reduced()
    B, S, D, V = 2, 32, cfg.d_model, cfg.vocab
    forward = _mm("qwen2-0.5b", "full", "prefill")
    regions = forward - 2 * B * S * D * V        # less the logits
    none = _mm("qwen2-0.5b", "none")
    assert _mm("qwen2-0.5b", "full", early_stop=False) - none == regions
    wo = 2 * B * S * cfg.d_ff * D * cfg.n_layers
    assert _mm("qwen2-0.5b", "full") - none == regions - wo
    assert none < _mm("qwen2-0.5b", "dots_nb") < _mm("qwen2-0.5b", "full")


def test_counts_do_not_depend_on_the_device():
    """The same step on meta and on the CPU dispatches the same ops."""
    cfg = get_config("qwen2-0.5b").reduced()
    shape = ShapeConfig("d", 16, 2, "decode")
    counts = []
    for device in ("meta", "cpu"):
        _, step, args = dryrun.prepare(cfg, shape, device)
        c, arg_bytes = dryrun.trace(step, args)
        counts.append((c.totals_outside(), c.peak_bytes, arg_bytes))
    assert counts[0] == counts[1]
    assert np.isfinite(counts[0][0]["flops"])
