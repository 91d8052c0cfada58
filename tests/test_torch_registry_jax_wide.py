"""test_torch_registry_jax.py at K = 10, 12 and 16 (the JAX package's
K = 24, 28 and 37), on the CPU: the JAX verify_core on BrainpoolP320r1,
lane for lane (about 65 s here: the JAX package compiles its eager
operations at K = 24; kernels 1-3 at K = 10 and the ECFSDSA comparisons
are in test_torch_registry_jax_k10.py). Slow: kernels 2 and 3 on
BrainpoolP384r1 (K = 12, generic a) and BrainpoolP512t1 (K = 16,
a = -3) against the JAX package's point_add and point_dbl and the JAX
verify_core on both (60-100 s each here), and the JAX package's whole
ECFSDSA P-521 batch (its combined check jitted, minutes here) against
the port's. Exact."""

import random

import pytest

from libecc_tpu.sig import batch_verify as jbv

from libecc_tpu_torch.curves import params
from libecc_tpu_torch.sig import batch_verify as bv

from test_torch_batch_verify import _jax_keys
from test_torch_registry import (_one_torch_thread, fsdsa_batch,
                                 key_batch)
from test_torch_registry_jax import check_add_dbl, verify_core_case

assert _one_torch_thread                # the module's autouse fixture
SLOW = pytest.mark.slow


def _rng(seed):
    r = random.Random(seed)
    return lambda n: bytes(r.randrange(256) for _ in range(n))


@SLOW
@pytest.mark.parametrize("name", ["BRAINPOOLP384R1", "BRAINPOOLP512T1"])
def test_plain_point_add_dbl_against_jax(name):
    check_add_dbl(name)


@pytest.mark.parametrize("name", [
    "BRAINPOOLP320R1", pytest.param("BRAINPOOLP384R1", marks=SLOW),
    pytest.param("BRAINPOOLP512T1", marks=SLOW)])
def test_verify_core_matches_jax_lane_for_lane(name):
    got, jax_acc, want = verify_core_case(name, 334)
    assert got == jax_acc == want


def _fsdsa(name, hash_name, n=4):
    c = params.get_curve(name)
    pts, msgs, sigs = fsdsa_batch(c, hash_name, 341, n)
    return key_batch(c, "ECFSDSA", pts), msgs, sigs


@SLOW
def test_ecfsdsa_p521_batch_matches_jax(monkeypatch):
    """The JAX package's whole ecfsdsa_verify_batch on P-521 (its combined
    check jitted) and the port's give the same answers: a valid batch
    accepts, one flipped bit of s rejects."""
    monkeypatch.setenv("LIBECC_TPU_PALLAS", "0")
    kb, msgs, sigs = _fsdsa("SECP521R1", "SHA512")
    bad = list(sigs)
    bad[2] = bad[2][:-1] + bytes([bad[2][-1] ^ 1])
    for ss, want in ((sigs, True), (bad, False)):
        assert bv.ecfsdsa_verify_batch(kb, msgs, ss, "SHA512", rng=_rng(6),
                                       device="cpu") is want
        assert bool(jbv.ecfsdsa_verify_batch(
            _jax_keys(kb), msgs, ss, "SHA512", rng=_rng(6))) is want
