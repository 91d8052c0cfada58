"""ECFSDSA batch verification on the cofactor-1 curves at K = 16 with
a = -3 (BrainpoolP512t1 under SHA-512, BIGN512V1 and GOST R 34.10-2012 512
paramSetA and paramSetB under SHA-256), on the CPU, as
test_torch_registry_fsdsa.py does at K = 6 and 7: 12 host-signed
signatures a curve accept as a batch; s = 0 and x(R) = p reject while
parsing; on BrainpoolP512t1, which leads the instance, one flipped bit of
s rejects in the combined check. Exact."""

import pytest

from test_torch_registry import HASH, WIDE, _one_torch_thread, \
    check_fsdsa_curve

assert _one_torch_thread                # the module's autouse fixture


@pytest.mark.parametrize("name", WIDE[3:])
def test_ecfsdsa_batches(name):
    c = check_fsdsa_curve(name, HASH.get(name, "SHA256"), 313,
                          name == "BRAINPOOLP512T1")
    assert (c.fp_ctx.k, c.a_is_m3) == (16, True)
