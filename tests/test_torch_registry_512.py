"""The port's ECDSA verify on BIGN512V1 and GOST R 34.10-2012 512
paramSetA and paramSetB (K = 16, a = -3: the kernels of BrainpoolP512t1,
test_torch_registry_wide.py), on the CPU, against the host oracle: the 16
lanes of test_torch_registry.ecdsa_lanes a curve through verify_batch
(SHA-256). Exact."""

import pytest

from test_torch_registry import WIDE, _one_torch_thread, check_ecdsa_curve

assert _one_torch_thread                # the module's autouse fixture


@pytest.mark.parametrize("name", WIDE[4:])
def test_ecdsa_verify_matches_the_host_oracle(name):
    c = check_ecdsa_curve(name, 304)
    assert (c.fp_ctx.k, c.a_is_m3, c.h) == (16, True, 1)
