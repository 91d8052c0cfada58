"""The port's batch verification against the JAX package's entry points, on
the CPU: for the same seeded rng, the z_i, z_i e_i, c, R and Y that the
port hands its _combined_check on Ed448, Ed448ph, ECFSDSA P-384 and
ECFSDSA BrainpoolP512r1 equal the ones the JAX package hands its own
(the JAX package decodes Ed448 eagerly, about 10 s here); ECFSDSA and
BIP0340 batches under the hash names "SHA3_256" and "SHA_256", which the
reference's registry takes, give the reference's inputs too, and a batch
under SHA3-256 accepts and, with a flipped bit, rejects. The JAX
package's whole entry points jit the combined check (minutes here), so
its check itself is replaced by a spy on both sides."""

import jax.numpy as jnp
import pytest
import torch

from libecc_tpu.sig import batch_verify as jbv

from libecc_tpu_torch.curves import params
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import batch_verify as bv, keys

from test_torch_batch_verify import _ints15, _jax_keys
from test_torch_batch_verify_wide import (SCHEMES, fixture, flip_s, rng_of,
                                          verify)

N = 4


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.setenv("LIBECC_TPU_PALLAS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def _spies(monkeypatch):
    """Replace both packages' _combined_check by spies that record their
    inputs and accept."""
    got, want = [], []

    def port_spy(*a):
        got.append(a)
        return torch.ones(1, dtype=torch.bool)

    def jax_spy(*a):
        want.append(a)
        return jnp.ones(1, bool)
    monkeypatch.setattr(bv, "_combined_check", port_spy)
    monkeypatch.setattr(jbv, "_combined_check", jax_spy)
    return got, want


def _same_inputs(got, want):
    (c, zs, e2, Y, R, cc), (jc, jzs, je2, jY, jR, jcc) = got[0], want[0]
    assert nn.batch_from_limbs(zs) == _ints15(jzs)
    assert nn.batch_from_limbs(e2) == _ints15(je2)
    assert cc == jcc
    for P, Pj in ((Y, jY), (R, jR)):
        assert [c.fp_ctx.to_ints(t) for t in P] == [
            jc.fp_ctx.to_ints(t) for t in Pj]


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_combined_check_inputs_match_jax(scheme, monkeypatch):
    got, want = _spies(monkeypatch)
    first, msgs, sigs = fixture(scheme)
    assert verify(scheme, first, msgs, sigs, 5) is True
    what, hash_name = SCHEMES[scheme]
    if scheme.startswith("ed448"):
        assert jbv.eddsa_verify_batch(what, first, msgs, sigs, rng=rng_of(5))
    else:
        assert jbv.ecfsdsa_verify_batch(_jax_keys(first), msgs, sigs,
                                        hash_name, rng=rng_of(5))
    _same_inputs(got, want)


def _k8_fixture(alg, hash_name):
    """N signatures of ECFSDSA on P-256 or BIP0340 on secp256k1 under
    hash_name (the host signers take hashlib's names)."""
    name = "SECP256R1" if alg == "ECFSDSA" else "SECP256K1"
    c = params.get_curve(name)
    wc = H.WCurve(c.fp_ctx.p_int, c.a, c.b, c.gx, c.gy, c.q)
    hl = hash_name.replace("_", "") if hash_name == "SHA_256" else hash_name
    msgs = [bytes([i]) * 20 for i in range(N)]
    ds = [i + 2 for i in range(N)]
    pubs = [H.ec_base_mul(wc, d) for d in ds]
    if alg == "ECFSDSA":
        sigs = [H.ecfsdsa_sign_ref(wc, d, 5 * i + 11, m, hl)
                for i, (d, m) in enumerate(zip(ds, msgs))]
    else:
        sigs = [H.bip0340_sign_ref(wc, d, m, bytes([i]) * 32, hl)
                for i, (d, m) in enumerate(zip(ds, msgs))]
    kb = keys.pubkey_batch_from_affine_ints(c, alg, [P[0] for P in pubs],
                                            [P[1] for P in pubs],
                                            device="cpu")
    return kb, msgs, sigs


def _k8_verify(pkg, alg, kb, msgs, sigs, hash_name, seed):
    if pkg is bv:
        fn = (bv.ecfsdsa_verify_batch if alg == "ECFSDSA"
              else bv.bip0340_verify_batch)
        return fn(kb, msgs, sigs, hash_name, rng=rng_of(seed), device="cpu")
    fn = (jbv.ecfsdsa_verify_batch if alg == "ECFSDSA"
          else jbv.bip0340_verify_batch)
    return fn(_jax_keys(kb), msgs, sigs, hash_name, rng=rng_of(seed))


@pytest.mark.parametrize("hash_name", ["SHA3_256", "SHA_256"])
@pytest.mark.parametrize("alg", ["ECFSDSA", "BIP0340"])
def test_hash_names_match_the_reference(alg, hash_name, monkeypatch):
    """The hash names the reference's registry takes (case, "-", "_" and
    "/" dropped) give the port the reference's challenges."""
    got, want = _spies(monkeypatch)
    kb, msgs, sigs = _k8_fixture(alg, hash_name)
    assert _k8_verify(bv, alg, kb, msgs, sigs, hash_name, 6) is True
    assert _k8_verify(jbv, alg, kb, msgs, sigs, hash_name, 6)
    _same_inputs(got, want)


def test_sha3_batch_accepts_and_rejects():
    """An ECFSDSA P-256 batch signed under SHA3-256 runs the whole check
    under the name "SHA3_256": it accepts, and rejects with one flipped
    bit of s."""
    kb, msgs, sigs = _k8_fixture("ECFSDSA", "SHA3_256")
    assert _k8_verify(bv, "ECFSDSA", kb, msgs, sigs, "SHA3_256", 7) is True
    bad = list(sigs)
    bad[1] = flip_s("ecfsdsa", bad[1])
    assert _k8_verify(bv, "ECFSDSA", kb, msgs, bad, "SHA3_256", 8) is False
