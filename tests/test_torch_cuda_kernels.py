"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import grad_compress as t_kgc
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import word_logical as t_wl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 256 * 100, 256 * 100 + 17, 256 * 20001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_block_sqnorms_matches_plain(cuda_device, n, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n)
    g = torch.randn(n, generator=gen, device=cuda_device).to(dtype)
    before = t_kgc.launches
    got = t_ops.block_sqnorms(g)
    torch.cuda.synchronize()
    assert t_kgc.launches == before + 1
    gp = torch.nn.functional.pad(g.float(), (0, -n % 256))
    want = t_kgc.block_sqnorms_plain(gp)
    # float32 sums of 256 positive squares in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    mask = t_ops.topk_block_mask(g, 0.25)
    assert mask.device.type == "cuda" and mask.dtype == torch.bool
    assert int(mask.sum()) >= max(int(got.numel() * 0.25), 1)


@pytest.mark.cuda
def test_block_sqnorms_rejects_other_block_widths(cuda_device):
    with pytest.raises(ValueError, match="256"):
        t_ops.block_sqnorms(torch.ones(512, device=cuda_device), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
def test_word_logical_matches_plain_and_numpy(cuda_device, op):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**32, size=(16, 8192), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(16, 8192), dtype=np.uint32)
    a[:8, :2048] = 0
    b[8:, 2048:4096] = 0xFFFFFFFF
    ta = t_ops.to_device_words(a, cuda_device)
    tb = t_ops.to_device_words(b, cuda_device)
    fa, fb = t_wl.tile_flags(ta), t_wl.tile_flags(tb)
    got = t_wl.word_logical(ta, tb, fa, fb, op)
    torch.cuda.synchronize()
    assert torch.equal(got, t_wl.word_logical_plain(ta, tb, fa, fb, op))
    want = {"and": a & b, "or": a | b, "xor": a ^ b, "andnot": a & ~b}[op]
    assert np.array_equal(t_ops.to_numpy_words(got), want)
