"""test_torch_registry_jax.py at K = 10 (the JAX package's K = 24), and
ECFSDSA against the JAX package, on the CPU: kernel 1's plain version
under BrainpoolP320r1's p and q against the JAX package's relaxed
product; kernels 2 and 3's plain versions on BrainpoolP320t1 (a = -3)
and BrainpoolP320r1 (generic a) against its point_add and point_dbl; and
for ECFSDSA batches on secp224k1 (28 + 28 + 29-byte signatures: p has
224 bits, q 225) and P-521 (66-byte values), the z_i, z_i e_i, c, R and
Y that the port hands its _combined_check equal the JAX package's for the
same seeded rng (the check itself replaced by a spy on both sides: the
JAX package jits it, minutes here; test_torch_registry_jax_wide.py runs
it whole, slow). Exact."""

import jax.numpy as jnp
import pytest
import torch

from libecc_tpu.sig import batch_verify as jbv

from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.sig import batch_verify as bv

from test_torch_batch_verify import _ints15, _jax_keys
from test_torch_registry import _one_torch_thread
from test_torch_registry_jax import check_add_dbl, check_mont
from test_torch_registry_jax_wide import _fsdsa, _rng

assert _one_torch_thread                # the module's autouse fixture


@pytest.mark.parametrize("which", ["p", "q"])
def test_plain_mont_mul_sqr_against_jax(which):
    check_mont("BRAINPOOLP320R1", which)


@pytest.mark.parametrize("name", ["BRAINPOOLP320T1", "BRAINPOOLP320R1"])
def test_plain_point_add_dbl_against_jax(name):
    check_add_dbl(name)


@pytest.mark.parametrize("name,hash_name", [("SECP224K1", "SHA256"),
                                            ("SECP521R1", "SHA512")])
def test_ecfsdsa_combined_check_inputs_match_jax(name, hash_name,
                                                 monkeypatch):
    kb, msgs, sigs = _fsdsa(name, hash_name)
    got, want = [], []

    def port_spy(*a):
        got.append(a)
        return torch.ones(1, dtype=torch.bool)

    def jax_spy(*a):
        want.append(a)
        return jnp.ones(1, bool)
    monkeypatch.setattr(bv, "_combined_check", port_spy)
    monkeypatch.setattr(jbv, "_combined_check", jax_spy)
    assert bv.ecfsdsa_verify_batch(kb, msgs, sigs, hash_name, rng=_rng(5),
                                   device="cpu") is True
    assert jbv.ecfsdsa_verify_batch(_jax_keys(kb), msgs, sigs, hash_name,
                                    rng=_rng(5))
    (c, zs, e2, Y, R, cc), (jc, jzs, je2, jY, jR, jcc) = got[0], want[0]
    assert nn.batch_from_limbs(zs) == _ints15(jzs)
    assert nn.batch_from_limbs(e2) == _ints15(je2)
    assert cc == jcc
    for P, Pj in ((Y, jY), (R, jR)):
        assert [c.fp_ctx.to_ints(t) for t in P] == [
            jc.fp_ctx.to_ints(t) for t in Pj]
