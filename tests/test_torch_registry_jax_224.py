"""test_torch_registry_jax.py at K = 7 (the JAX package's K = 17): kernel
1's plain version under P-224's p and q and secp224k1's 225-bit q (the
port's K = 8) against the JAX package's relaxed product; kernels 2 and
3's plain versions for a = -3, generic a and a = 0 against its point_add
and point_dbl; and the JAX verify_core on P-224, lane for lane (secp224k1
in test_torch_registry_jax_224k1.py). Exact."""

import pytest

from test_torch_registry import _one_torch_thread
from test_torch_registry_jax import (check_add_dbl, check_mont,
                                     verify_core_case)

assert _one_torch_thread                # the module's autouse fixture
K7 = ["SECP224R1", "BRAINPOOLP224R1", "SECP224K1"]


@pytest.mark.parametrize("name,which", [("SECP224R1", "p"),
                                        ("SECP224R1", "q"),
                                        ("SECP224K1", "q")])
def test_plain_mont_mul_sqr_against_jax(name, which):
    check_mont(name, which)


@pytest.mark.parametrize("name", K7)
def test_plain_point_add_dbl_against_jax(name):
    check_add_dbl(name)


def test_verify_core_matches_jax_lane_for_lane():
    got, jax_acc, want = verify_core_case("SECP224R1", 332)
    assert got == jax_acc == want
    assert want[10]                     # x(W) = r + q: the second candidate
