"""The port's ECDSA verify on P-521 (K = 17) against the KAT rows of the
other hashes and against the JAX package (K = 37), on the CPU: the
SECP521R1 rows under SHA-224, SHA-256, SHA-384 and SHA3-512 (one verify
call a hash, 5-10 s each here), 64 rows of 132-byte signatures through
the fused bytes-in path, the scalar e of a digest shorter than q (SHA-512
and SHA3-512 give 512 bits, q has 521: no truncation) against the JAX
package's, and verify_core against the JAX package's verify_core called
eagerly on 16 adversarial lanes, lane for lane (about 100 s at K = 37: the
slow tier)."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import params as jparams
from libecc_tpu.nn import core as jnn
from libecc_tpu.sig import common as jcommon, ecdsa as jecdsa

from libecc_tpu_torch import convert, stages
from libecc_tpu_torch.curves import params
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import common, ecdsa, keys as K

from test_torch_ecdsa_wide import HASHLIB
from test_torch_ecdsa_wide_jax import WANT, _lanes
from test_torch_p521 import (NAME, NB, _range_lanes, _signed, kat_batch,
                             kat_groups)

HASHLIB = {**HASHLIB, "SHA3_512": hashlib.sha3_512}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hash_name", ["SHA224", "SHA256", "SHA384",
                                       "SHA3_512"])
def test_kat_rows_verify(hash_name):
    """The SECP521R1 KAT rows of one hash as one verify_batch call with the
    hash by name: each accepts, and rejects with another message or a
    flipped bit of r; the scalar e also against hashlib."""
    c = params.get_curve(NAME)
    xs, ys, msgs, sigs, want = kat_batch(kat_groups()[hash_name])
    kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", xs, ys, device="cpu")
    e = common.e_from_msgs(msgs, c.q_ctx, "cpu", hash_name)
    assert nn.batch_from_limbs(e) == [
        H.trunc_msb_mod_q(HASHLIB[hash_name](m).digest(), c.q) for m in msgs]
    assert ecdsa.verify_batch(kb, msgs, sigs, hash_name).tolist() == want


def test_fused_bytes_in_132_byte_rows():
    """64 rows of 32-byte messages signed under SHA-256 take the fused
    bytes-in path ("hash" mark: the 132-byte signatures are split into r
    and s on the device); valid rows accept, another message's signature
    and the out-of-range r and s reject."""
    c = params.get_curve(NAME)
    rng = np.random.RandomState(195)
    msgs = [rng.bytes(32) for _ in range(8)]
    kb, sigs = _signed("SHA256", msgs * 8, 196)      # 8 nonces, tiled
    msgs = msgs * 8
    want = [True] * 64
    sigs[5] = sigs[6]
    want[5] = False
    for i, (sig, ok) in enumerate(_range_lanes(sigs[20], c.q)[1:]):
        sigs[21 + i] = sig
        msgs[21 + i] = msgs[20]
        want[21 + i] = ok
    assert ecdsa._fused_applicable(msgs, sigs, NB)
    marks = []
    with stages.on_mark(lambda name, *vals: marks.append(name)):
        acc = ecdsa.verify_batch_async(kb, msgs, sigs, "SHA256")
    assert "hash" in marks
    assert acc.tolist() == want


@pytest.mark.parametrize("hash_name", ["SHA512", "SHA3_512"])
def test_digest_shorter_than_q_matches_jax(hash_name):
    """A 512-bit digest under a 521-bit q: e is the digest itself (below q,
    nothing cut), as the JAX package's e_from_digest_bits gives it; the
    all-ones digest included."""
    c, jc = params.get_curve(NAME), jparams.get_curve(NAME)
    rng = np.random.RandomState(197)
    digs = [HASHLIB[hash_name](rng.bytes(40)).digest() for _ in range(6)]
    digs += [b"\xff" * 64, bytes(64)]
    words = common.digests_to_words(digs)
    got = common.e_from_digest_bits(nn.upload(words, "cpu"), 512, c.q_ctx)
    want = jcommon.e_from_digest_bits(
        jnp.asarray(jcommon.digests_to_words(digs)), 512, jc.q_ctx)
    ints = [int.from_bytes(d, "big") for d in digs]
    assert all(v < c.q for v in ints)
    assert nn.batch_from_limbs(got) == ints
    assert convert.ints_from_limbs15(np.asarray(want)) == ints


@pytest.mark.slow
def test_verify_core_matches_jax_lane_for_lane():
    """verify_core at K = 17 against the JAX package's at K = 37 on the 16
    lanes of test_torch_ecdsa_wide_jax.py (every rejection class, both
    candidates of the projective accept test), and against the host
    oracle."""
    c, jc = params.get_curve(NAME), jparams.get_curve(NAME)
    wc, lanes = _lanes(c)
    pub_j = jc.point_from_affine_ints([ln[0][0] for ln in lanes],
                                      [ln[0][1] for ln in lanes])
    esr = [jnn.batch_to_limbs([ln[i] for ln in lanes], jc.q_ctx.k)
           for i in (1, 2, 3)]
    jax_acc = np.asarray(jecdsa.verify_core(
        jc, pub_j, *[jnp.asarray(v) for v in esr])).tolist()
    kb = convert.keys_from_jax(c, *[np.asarray(v) for v in pub_j],
                               "cpu")
    e, r, s = [convert.scalars_from_jax(v, c.q_ctx.k, "cpu") for v in esr]
    got = ecdsa.verify_core(c, kb.pub, e, r, s).tolist()
    assert got == jax_acc == WANT
    want = [H.ecdsa_verify_ref(wc, ln[0], ln[1], ln[2], ln[3])
            if i != 8 else False for i, ln in enumerate(lanes)]
    assert want == WANT
