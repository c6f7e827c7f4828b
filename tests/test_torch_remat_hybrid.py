"""``test_torch_remat.py``'s loss and gradient parity under each remat
policy for the hybrid (each group with its shared block one region) and
the encoder-decoder (each encoder and decoder layer one region)."""
import pytest

from test_torch_remat import POLICIES, _check_loss_and_grads, _two_threads  # noqa: F401
from test_torch_remat import float32  # noqa: F401


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["zamba2-1.2b", "whisper-small"])
def test_loss_and_grads_match_reference_under_each_policy_hybrid(
        float32, name, policy):  # noqa: F811
    _check_loss_and_grads(name, policy)
