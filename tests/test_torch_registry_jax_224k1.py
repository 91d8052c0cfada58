"""test_torch_registry_jax.py on secp224k1 (a = 0; p has 224 bits, K = 7,
and q 225, K = 8 in the port, both K = 17 in the JAX package): the JAX
verify_core called eagerly on the 16 lanes of
test_torch_registry.ecdsa_lanes, lane for lane. q > p, so the projective
test has no second candidate; lane 10 holds r in [p, q) with r - p = x(W),
and both packages reject it. Exact."""

from test_torch_registry import _one_torch_thread
from test_torch_registry_jax import verify_core_case

assert _one_torch_thread                # the module's autouse fixture


def test_verify_core_matches_jax_lane_for_lane():
    got, jax_acc, want = verify_core_case("SECP224K1", 333)
    assert got == jax_acc == want
    assert not want[10]
