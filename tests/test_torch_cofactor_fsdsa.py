"""ECFSDSA batch verification on a cofactor > 1 curve at K = 8 (GOST R
34.10-2012 256 paramSetA, h = 4), on the CPU: a host-signed batch whose
keys come through the checked import (the q*P subgroup check) accepts,
and one flipped bit of s or one changed message rejects it; and, for the
same seeded rng, the z_i, z_i e_i, c, R and Y that the port hands its
_combined_check equal the JAX package's (the check itself replaced by a
spy on both sides: the JAX package jits it). WEI448 (kernel 6 at K = 14)
is in test_torch_cofactor_fsdsa_wei448.py; the four curves' batches run
on the card in chip_smoke.py. Exact."""

import jax.numpy as jnp
import torch

from libecc_tpu.curves import params as jparams
from libecc_tpu.sig import batch_verify as jbv, keys as jkeys

from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.sig import batch_verify as bv

from test_torch_batch_verify import _ints15
from test_torch_cofactor import (check_accepts_and_rejects, checked_batch,
                                 rng_of)
from test_torch_registry import _one_torch_thread

assert _one_torch_thread                # the module's autouse fixture


def test_ecfsdsa_batch_accepts_and_rejects():
    check_accepts_and_rejects("GOST_R3410_2012_256_PARAMSETA")


def test_combined_check_inputs_match_jax(monkeypatch):
    name = "GOST_R3410_2012_256_PARAMSETA"
    c, kb, msgs, sigs = checked_batch(name)
    xs, ys, _ = kb.pub_affine_ints()
    jkb = jkeys.pubkey_batch_from_affine_ints(
        jparams.get_curve(name), "ECFSDSA", xs, ys, check_order=False)
    got, want = [], []

    def port_spy(*a):
        got.append(a)
        return torch.ones(1, dtype=torch.bool)

    def jax_spy(*a):
        want.append(a)
        return jnp.ones(1, bool)
    monkeypatch.setattr(bv, "_combined_check", port_spy)
    monkeypatch.setattr(jbv, "_combined_check", jax_spy)
    assert bv.ecfsdsa_verify_batch(kb, msgs, sigs, "SHA256", rng=rng_of(5),
                                   device="cpu") is True
    assert jbv.ecfsdsa_verify_batch(jkb, msgs, sigs, "SHA256", rng=rng_of(5))
    (c, zs, e2, Y, R, cc), (jc, jzs, je2, jY, jR, jcc) = got[0], want[0]
    assert nn.batch_from_limbs(zs) == _ints15(jzs)
    assert nn.batch_from_limbs(e2) == _ints15(je2)
    assert cc == jcc
    for P, Pj in ((Y, jY), (R, jR)):
        assert [c.fp_ctx.to_ints(t) for t in P] == [
            jc.fp_ctx.to_ints(t) for t in Pj]
