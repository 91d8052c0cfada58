"""The port's ECDSA verify on P-521 (SECP521R1: K = 17 limbs of 32 bits,
a = -3, R = 2^544; the JAX package's K = 37 limbs of 15 bits), on the CPU:
kernel 1's plain version under p and q and the plain point add and double
against the JAX package (through convert.py), the plain windowed multiply
(131 windows) against the host oracle, the SHA-512 group of the SECP521R1
KAT rows, and the 66-byte encodings: r and s at or above q or 2^521 are
rejected, never truncated, on both byte-to-limb paths; 130- and 134-byte
signatures raise as in the reference. Exact everywhere.
test_torch_p521_jax.py holds the other hash groups, the fused bytes-in
path, the digest shorter than q and verify_core against the JAX
package's, lane for lane."""

import hashlib
import json
import os
from collections import defaultdict

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import params as jparams, shortw as jshortw
from libecc_tpu.nn import core as jnn
from libecc_tpu.sig import ecdsa as jecdsa, keys as jkeys

from libecc_tpu_torch import convert
from libecc_tpu_torch.curves import params, scalar_mul, shortw
from libecc_tpu_torch.curves.shortw import PrjPoint
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import ecdsa, keys as K

from test_torch_ecdsa_wide import (VEC, _affine, _affine_pairs, _host,
                                   _ints, _jax_point, _pub_xyz)

NAME = "SECP521R1"
NB = 66                                 # bytes of r, s and of q


def kat_groups():
    """The SECP521R1 ECDSA and DECDSA rows of kats_full.jsonl (10) and the
    ECDSA row of sig_kats.jsonl, as (curve, hash, pub, msg, sig) grouped by
    hash name."""
    groups = defaultdict(list)
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        for r in map(json.loads, f):
            if r.get("alg") in ("ECDSA", "DECDSA") and r["curve"] == NAME:
                groups[r["hash"]].append(
                    (bytes.fromhex(r["pub"]), bytes.fromhex(r["msg_hex"]),
                     bytes.fromhex(r["sig"])))
    with open(os.path.join(VEC, "sig_kats.jsonl")) as f:
        for r in map(json.loads, f):
            if r["alg"] in ("ECDSA", "DECDSA") and r["curve"] == NAME:
                groups[r["hash"]].append((bytes.fromhex(r["pub"]),
                                          r["msg"].encode(),
                                          bytes.fromhex(r["sig"])))
    return dict(sorted(groups.items()))


def kat_batch(rows):
    """The rows as one batch: each row, then with another message, then
    with a flipped bit of r; (affine xs, ys, msgs, sigs, wanted mask)."""
    c = params.get_curve(NAME)
    xs, ys, msgs, sigs, want = [], [], [], [], []
    for pub, msg, sig in rows:
        x, y = _pub_xyz(c, pub)
        xs += [x] * 3
        ys += [y] * 3
        msgs += [msg, msg + b"x", msg]
        sigs += [sig, sig, bytes([sig[0] ^ 1]) + sig[1:]]
        want += [True, False, False]
    return xs, ys, msgs, sigs, want


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_p521_contexts():
    """K = 17 for p and q, p' = 1 (p = 2^521 - 1), R = 2^544; the JAX
    package's K = 37."""
    c, jc = params.get_curve("P-521"), jparams.get_curve("P-521")
    assert c.name == NAME and c.a_is_m3
    assert (c.fp_ctx.k, c.q_ctx.k, jc.fp_ctx.k, jc.q_ctx.k) == (17, 17, 37,
                                                                37)
    assert c.fp_ctx.p_int == (1 << 521) - 1 and c.fp_ctx.pinv32 == 1
    assert c.fp_ctx.R == 1 << 544 and c.scalar_bits() == 521
    assert (c.q.bit_length() + 7) // 8 == NB


@pytest.mark.parametrize("which", ["p", "q"])
def test_plain_mont_mul_sqr_against_jax(which):
    """Kernel 1's plain version at K = 17 against the JAX package's relaxed
    product at K = 37, edge operands included (m - 1 squared and times
    m - 2; 2^520 mod m)."""
    c, jc = params.get_curve(NAME), jparams.get_curve(NAME)
    ctx, jctx = (c.fp_ctx, jc.fp_ctx) if which == "p" else (c.q_ctx,
                                                           jc.q_ctx)
    m = ctx.p_int
    rng = np.random.RandomState(191)
    edges = [0, 1, 2, m - 1, m - 2, (1 << (m.bit_length() - 1)) % m]
    xs = edges + _ints(rng, 10, m)
    ys = edges[::-1] + _ints(rng, 10, m)
    aj = jnn.batch_to_limbs([x * jctx.R % m for x in xs], jctx.k)
    bj = jnn.batch_to_limbs([y * jctx.R % m for y in ys], jctx.k)
    pj = np.asarray(jnn.mont_mul_relaxed(jnp.asarray(aj), jnp.asarray(bj),
                                         jctx))
    sj = np.asarray(jnn.mont_sqr_relaxed(jnp.asarray(aj), jctx))
    a = convert.fe_from_jax(aj, ctx, "cpu")
    b = convert.fe_from_jax(bj, ctx, "cpu")
    assert ctx.to_ints(a) == xs and ctx.to_ints(b) == ys
    got = nn.mont_mul(a, b, ctx)
    assert torch.equal(got, convert.fe_from_jax(pj, ctx, "cpu"))
    assert torch.equal(nn.mont_sqr(a, ctx), convert.fe_from_jax(sj, ctx,
                                                                "cpu"))
    assert ctx.to_ints(got) == [x * y % m for x, y in zip(xs, ys)]


def test_plain_point_add_dbl_against_jax():
    """Kernels 2 and 3's plain versions (a = -3) against the JAX package's
    shortw.point_add and point_dbl, as projective values mod p: identity,
    P = Q and P = -Q lanes included."""
    c, jc = params.get_curve(NAME), jparams.get_curve(NAME)
    rng = np.random.RandomState(192)
    A, B = _affine_pairs(c, rng)
    Aj, Bj = _jax_point(jc, A, rng), _jax_point(jc, B, rng)

    def port(Pj):
        return convert.point_from_jax(c, *[np.asarray(v) for v in Pj], "cpu")

    def vals_jax(Pj):
        return [jc.fp_ctx.to_ints(v) for v in Pj]

    want = vals_jax(jshortw.point_add(jc, Aj, Bj))
    got = shortw.point_add(c, port(Aj), port(Bj))
    assert [c.fp_ctx.to_ints(v) for v in got] == want
    assert _affine(c, want) == [H.ec_add(_host(c), a, b)
                                for a, b in zip(A, B)]
    want = vals_jax(jshortw.point_dbl(jc, Aj))
    got = shortw.point_dbl(c, port(Aj))
    assert [c.fp_ctx.to_ints(v) for v in got] == want
    assert _affine(c, want) == [H.ec_add(_host(c), a, a) for a in A]


def test_plain_windowed_mul_against_the_oracle():
    """Kernel 4's plain version at K = 17 (131 windows, the last of one
    bit) through windowed_mul_public: scalars whose last add is T + O,
    -T + T and T + T, 1, q - 1 and a random one, on random points and the
    identity; compared in affine form mod p."""
    c = params.get_curve(NAME)
    wc = _host(c)
    rng = np.random.RandomState(193)
    ms = H.window_edge_scalars(c.q) + _ints(rng, 1, c.q)
    pts = [H.ec_base_mul(wc, 1 + v % (c.q - 1))
           for v in _ints(rng, len(ms), c.q)]
    pts[4] = None
    p = c.fp_ctx.p_int
    lam = [1 + v % (p - 1) for v in _ints(rng, len(ms), p)]
    f = c.fp_ctx.from_ints
    P = PrjPoint(
        f([0 if q is None else q[0] * m % p for q, m in zip(pts, lam)], "cpu"),
        f([m if q is None else q[1] * m % p for q, m in zip(pts, lam)], "cpu"),
        f([0 if q is None else m for q, m in zip(pts, lam)], "cpu"))
    mt = nn.upload(nn.batch_to_limbs(ms, c.q_ctx.k), "cpu")
    assert scalar_mul._window_digits(mt, 521).shape == (131, len(ms))
    R = scalar_mul.windowed_mul_public(c, mt, P)
    got = _affine(c, [c.fp_ctx.to_ints(v) for v in R])
    assert got == [H.ec_mul(wc, m, pt) for m, pt in zip(ms, pts)]
    assert got[:3] == [None, None, H.ec_mul(wc, 2 * ((-c.q) % 16), pts[2])]
    assert shortw.on_curve_mask(c, R).all()


def _signed(hash_name, msgs, seed):
    """Host-signed (keys, signatures) of msgs under hash_name, one
    signature a distinct message."""
    c = params.get_curve(NAME)
    wc = _host(c)
    rng = np.random.RandomState(seed)
    d = 1 + _ints(rng, 1, c.q - 1)[0]
    pub = H.ec_base_mul(wc, d)
    h = getattr(hashlib, hash_name.lower())
    sigs = {}
    for m in msgs:
        if m not in sigs:
            e = H.trunc_msb_mod_q(h(m).digest(), c.q)
            r, s = H.ecdsa_sign_ref(wc, d, e, 1 + _ints(rng, 1, c.q - 1)[0])
            sigs[m] = _sig(r, s)
    kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", [pub[0]] * len(msgs),
                                         [pub[1]] * len(msgs), device="cpu")
    return kb, [sigs[m] for m in msgs]


def _rs(sig):
    return int.from_bytes(sig[:NB], "big"), int.from_bytes(sig[NB:], "big")


def _sig(r, s):
    return r.to_bytes(NB, "big") + s.to_bytes(NB, "big")


def _range_lanes(sig, q):
    """(signature, accepted) lanes around one valid signature: r or s at q,
    above q, at or above 2^521 (byte 0's top bits set) and the valid value
    plus 2^521, 2^524 or 2^527 (what a truncation to 521 bits would
    accept)."""
    r, s = _rs(sig)
    return [(sig, True), (_sig(q, s), False), (_sig(r, q), False),
            (_sig(q + 5, s), False), (_sig(r, q + 5), False),
            (_sig(1 << 521, s), False), (_sig(r, (1 << 528) - 1), False),
            (_sig(r + (1 << 521), s), False),
            (_sig(r + (1 << 524), s), False),
            (_sig(r, s + (1 << 527)), False)]


def test_kat_row_count():
    groups = kat_groups()
    assert {h: len(v) for h, v in groups.items()} == {
        "SHA224": 2, "SHA256": 2, "SHA384": 2, "SHA3_512": 1, "SHA512": 4}


def test_sha512_kat_rows_and_66_byte_ranges():
    """The SHA-512 group of the SECP521R1 KAT rows (the ECDSA and two DECDSA
    rows of kats_full.jsonl, the ECDSA row of sig_kats.jsonl) in one
    verify_batch call: each accepts, and rejects with another message or
    a flipped bit of r. In the same call, lanes whose r or s is at or above
    q or 2^521 reject: the byte-to-limb path keeps all 66 bytes."""
    c = params.get_curve(NAME)
    rows = kat_groups()["SHA512"]
    xs, ys, msgs, sigs, want = kat_batch(rows)
    x, y = _pub_xyz(c, rows[0][0])
    for sig, ok in _range_lanes(rows[0][2], c.q):
        xs.append(x), ys.append(y), msgs.append(rows[0][1])
        sigs.append(sig), want.append(ok)
    kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", xs, ys, device="cpu")
    assert ecdsa.verify_batch(kb, msgs, sigs, "SHA512").tolist() == want


def test_66_byte_values_to_limbs():
    """Both byte-to-limb paths (host numpy for verify_batch, the device one
    of the fused path) read a 66-byte value as 17 whole words, byte 0 in
    bits 520-527 of limb 16: no value is cut to 521 bits."""
    c = params.get_curve(NAME)
    q = c.q
    vals = [0, 1, q - 1, q, q + 5, (1 << 521) - 1, 1 << 521,
            (1 << 528) - 1, 0x1F << 523]
    rows = [v.to_bytes(NB, "big") for v in vals]
    host = nn.bytes_be_to_limbs_np(rows, 17)
    assert host.shape == (17, len(vals))
    assert nn.batch_from_limbs(host) == vals
    u8 = torch.tensor(np.frombuffer(b"".join(rows), np.uint8).reshape(
        len(vals), NB))
    dev = nn.be_rows_to_limbs_dev(u8, 17)
    assert torch.equal(dev, torch.from_numpy(host.view(np.int32)))


def test_signature_lengths_raise_as_the_reference():
    """130- and 134-byte signatures raise ValueError in every entry point,
    as in the reference's _verify_dispatch."""
    c, jc = params.get_curve(NAME), jparams.get_curve(NAME)
    msgs = [b"m" * 32] * 2
    kb, sigs = _signed("SHA512", msgs, 194)
    jkb = jkeys.pubkey_batch_from_affine_ints(
        jc, "ECDSA", *kb.pub_affine_ints()[:2])
    digs = [hashlib.sha512(m).digest() for m in msgs]
    for bad in (sigs[0][:130], sigs[0] + b"\x00\x00"):
        assert len(bad) in (130, 134)
        ss = [sigs[0], bad]
        with pytest.raises(ValueError, match="bad signature length"):
            jecdsa.verify_digests_batch(jkb, digs, ss, "SHA512")
        with pytest.raises(ValueError, match="bad signature length"):
            ecdsa.verify_batch(kb, msgs, ss, "SHA512")
        with pytest.raises(ValueError, match="bad signature length"):
            ecdsa.verify_digests_batch(kb, digs, ss, "SHA512")
        with pytest.raises(ValueError, match="bad signature length"):
            ecdsa.verify_batch_async(kb, msgs, ss, "SHA256")
