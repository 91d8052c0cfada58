"""ECDSA verify on the cofactor > 1 curves (WEI25519, GOST R 34.10-2012
256 paramSetA and 512 paramSetC, WEI448 under SHA-512's 512 bits
truncated to its 446-bit q), on the CPU, against the host oracle on the
16 adversarial lanes of test_torch_cofactor.cofactor_lanes a curve. On
these curves ceil(p/q) > 2, so verify_core takes its affine accept test,
x(W) mod q == r: lanes whose x(W) is at or above q (in [q, 2q) and in
[2q, p)) accept with r = x(W) mod q and reject with the unreduced x(W) as
r. Exact."""

import pytest

from libecc_tpu_torch.curves import params
from libecc_tpu_torch.sig import ecdsa

from test_torch_cofactor import CURVES, cofactor_lanes, sigs_of
from test_torch_registry import _one_torch_thread, key_batch

assert _one_torch_thread                # the module's autouse fixture


@pytest.mark.parametrize("name", list(CURVES))
def test_ecdsa_verify_matches_the_host_oracle(name):
    """verify_batch on cofactor_lanes equals the host oracle on every lane
    (the keys imported unchecked: lane 8 is off the curve, lane 13 outside
    the subgroup)."""
    c = params.get_curve(name)
    hash_name = CURVES[name]
    _, lanes, want = cofactor_lanes(c, hash_name, 402)
    kb = key_batch(c, "ECDSA", [ln[0] for ln in lanes], validate=False)
    got = ecdsa.verify_batch(kb, [ln[1] for ln in lanes], sigs_of(c, lanes),
                             hash_name)
    assert got.tolist() == want
