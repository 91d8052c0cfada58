"""ECFSDSA batch verification on BrainpoolP320r1/t1 (K = 10),
BrainpoolP384r1 (K = 12, generic a) and P-521 (K = 17, a = -3), on the
CPU, as test_torch_registry_fsdsa.py does at K = 6 and 7: 12 host-signed
signatures a curve accept as a batch; s = 0 and x(R) = p reject while
parsing; one flipped bit of s rejects in the combined check.
BrainpoolP384r1 (SHA-384) and P-521 (SHA-512) carry their ECFSDSA KAT
rows (kats_full.jsonl) in the batch, and the row under another message
rejects it. Exact."""

import pytest

from test_torch_registry import HASH, _one_torch_thread, check_fsdsa_curve
from test_torch_registry_fsdsa import fsdsa_kat

assert _one_torch_thread                # the module's autouse fixture


@pytest.mark.parametrize("name", ["BRAINPOOLP320T1", "BRAINPOOLP320R1",
                                  "BRAINPOOLP384R1", "SECP521R1"])
def test_ecfsdsa_batches(name):
    kat = None
    if name in ("BRAINPOOLP384R1", "SECP521R1"):
        kat = fsdsa_kat(name)
    hash_name = kat[3] if kat else HASH.get(name, "SHA256")
    assert hash_name == {"SECP521R1": "SHA512"}.get(name, "SHA384")
    c = check_fsdsa_curve(name, hash_name, 312, True, kat and kat[:3])
    assert c.fp_ctx.k in (10, 12, 17)
