"""ECFSDSA batch verification on the cofactor-1 curves at K = 6 and 7, on
the CPU: 12 host-signed signatures a curve (the keys G and -G and the
nonces 1 and q - 1 among them) accept as a batch; s = 0 on one lane and
x(R) = p on another reject while parsing; and, on the curve that leads
each (K, a) instance of kernel 6, one flipped bit of s rejects in the
combined check (test_torch_registry.check_fsdsa_curve). secp224k1's
signatures are 28 + 28 + 29 bytes (p has 224 bits, q 225). P-224's batch
runs under SHA-224 with its ECFSDSA KAT row (kats_full.jsonl) appended,
whose signature the host signer reproduces; under another message that
row rejects the batch. Exact."""

import json
import os

import pytest

from libecc_tpu_torch.curves import params
from libecc_tpu_torch.ref import hostref as H
from test_torch_registry import (HASH, K6_K7, VEC, _one_torch_thread,
                                 check_fsdsa_curve, host, pub_affine)

assert _one_torch_thread                # the module's autouse fixture
# the curves that lead a (K, a) instance (the others share one)
LEADS = K6_K7[:6]


def fsdsa_kat(name):
    """The curve's ECFSDSA row of kats_full.jsonl as (affine key, message,
    signature, hash), the signature reproduced by the host signer."""
    c = params.get_curve(name)
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        (r,) = [r for r in map(json.loads, f)
                if r.get("alg") == "ECFSDSA" and r.get("curve") == name]
    msg, sig = bytes.fromhex(r["msg_hex"]), bytes.fromhex(r["sig"])
    assert H.ecfsdsa_sign_ref(host(c), int(r["priv"], 16),
                              int(r["nonce"], 16), msg, r["hash"]) == sig
    return pub_affine(c, bytes.fromhex(r["pub"])), msg, sig, r["hash"]


@pytest.mark.parametrize("name", K6_K7)
def test_ecfsdsa_batches(name):
    kat = fsdsa_kat(name) if name == "SECP224R1" else None
    hash_name = HASH.get(name, "SHA256")
    if kat is not None:
        assert kat[3] == hash_name
    c = check_fsdsa_curve(name, hash_name, 311, name in LEADS,
                          kat and kat[:3])
    if name == "SECP224K1":
        assert ((c.fp_ctx.bits + 7) // 8, (c.q.bit_length() + 7) // 8) == (
            28, 29)
