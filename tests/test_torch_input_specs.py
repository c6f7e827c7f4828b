"""The port's dry-run input stand-ins against the reference's, for every
arch x shape, and ``concrete_batch`` token for token."""
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.configs import input_specs as r_ispec
from repro.models.transformer import LM as RLM
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.configs import input_specs as t_ispec
from repro_torch.models.transformer import LM

DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
          "float32": torch.float32}


def _pairs(tree):
    return {k: (tuple(v.shape), DTYPES[str(v.dtype)]) for k, v in tree.items()
            if k != "length"}


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_match_reference(arch, shape_name):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    shape, rshape = SHAPES[shape_name], R_SHAPES[shape_name]
    assert t_ispec.text_len(cfg, shape) == r_ispec.text_len(rcfg, rshape)
    assert t_ispec.batch_specs(cfg, shape) == \
        _pairs(r_ispec.batch_specs(rcfg, rshape))
    cache, tokens = t_ispec.decode_specs(LM(cfg, device="meta"), shape)
    rcache, rtokens = r_ispec.decode_specs(RLM(rcfg), rshape)
    assert cache == _pairs(rcache)
    assert tokens == (tuple(rtokens.shape), torch.int32)
    # stand-ins on meta allocate nothing and have the specs' shapes
    meta = t_ispec.materialize(cache, "meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in meta.items()} == cache
    assert all(v.is_meta for v in meta.values())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-26b",
                                  "whisper-small"])
def test_concrete_batch_draws_the_reference_tokens(arch):
    """Tokens identical; the bfloat16 frames within one bfloat16 rounding
    (the reference casts float64 through JAX, the port through torch)."""
    shape = ShapeConfig("small", 300, 2, "train")
    cfg = get_config(arch)
    got = t_ispec.concrete_batch(cfg, shape, np.random.default_rng(7),
                                 device="cpu")
    want = r_ispec.concrete_batch(r_get_config(arch), shape,
                                  np.random.default_rng(7))
    assert set(got) == set(want)
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    if "frontend" in want:
        assert got["frontend"].dtype == torch.bfloat16
        np.testing.assert_allclose(
            got["frontend"].float().numpy(),
            np.asarray(want["frontend"], dtype=np.float32),
            rtol=2 ** -8, atol=0)
    # the default generator is the reference's default_rng(0)
    again = t_ispec.concrete_batch(cfg, shape, device="cpu")
    np.testing.assert_array_equal(again["tokens"].numpy(), np.asarray(
        r_ispec.concrete_batch(r_get_config(arch), shape)["tokens"]))


def test_concrete_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ispec.concrete_batch(get_config("qwen2-0.5b"), SHAPES["train_4k"])
