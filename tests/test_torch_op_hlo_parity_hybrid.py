"""``test_torch_op_hlo_parity.py``'s comparison for the hybrid and the
encoder-decoder (their reference steps take the longest to compile)."""
import pytest

from test_torch_op_hlo_parity import CASES, check


@pytest.mark.parametrize("kind,policy", CASES)
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small"])
def test_product_flops_match_reference_hlo_hybrid(arch, kind, policy):
    check(arch, kind, policy)
