"""The port's ECDSA verify (the slice as a whole) against the JAX package's
verify_core, the P-256 Wycheproof rows and the P-256 signature KAT, on the
CPU."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import params as jparams
from libecc_tpu.nn import core as jnn
from libecc_tpu.sig import ecdsa as jecdsa

from libecc_tpu_torch import convert, stages
from libecc_tpu_torch.curves import params
from libecc_tpu_torch.curves.shortw import PrjPoint
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import common, ecdsa, keys as K

from test_torch_cofactor import small_order_point

C = params.get_curve("P-256")
P, Q = C.fp_ctx.p_int, C.q
WC = H.WCurve(P, C.a, C.b, C.gx, C.gy, Q)
VEC = os.path.join(os.path.dirname(__file__), "vectors")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _e(msg):
    return H.trunc_msb_mod_q(hashlib.sha256(msg).digest(), Q)


def test_verify_core_matches_jax():
    """8 lanes: 3 valid, r + 1, s = 0, s = q, another message, and an
    off-curve key placed directly in the point batch (the import path
    raises on such a key)."""
    rng = np.random.RandomState(51)
    privs = [1 + int.from_bytes(rng.bytes(32), "big") % (Q - 1)
             for _ in range(8)]
    pubs = [H.ec_mul(WC, d, (C.gx, C.gy)) for d in privs]
    msgs = [rng.bytes(32) for _ in range(8)]
    es, rs, ss = [], [], []
    for d, m in zip(privs, msgs):
        k = 1 + int.from_bytes(rng.bytes(32), "big") % (Q - 1)
        r, s = H.ecdsa_sign_ref(WC, d, _e(m), k)
        es.append(_e(m)), rs.append(r), ss.append(s)
    rs[3] += 1
    ss[4] = 0
    ss[5] = Q
    es[6] = _e(msgs[6] + b"x")
    xs = [pt[0] for pt in pubs]
    ys = [pt[1] for pt in pubs]
    ys[7] = (ys[7] + 1) % P
    jc = jparams.get_curve("P-256")
    pub_j = jc.point_from_affine_ints(xs, ys)
    e_j, r_j, s_j = [jnn.batch_to_limbs(v, jc.q_ctx.k) for v in (es, rs, ss)]
    want = np.asarray(jecdsa.verify_core(jc, pub_j, jnp.asarray(e_j),
                                         jnp.asarray(r_j), jnp.asarray(s_j)))
    kb = convert.keys_from_jax(C, *[np.asarray(v) for v in pub_j],
                               "cpu")
    e, r, s = [convert.scalars_from_jax(v, C.q_ctx.k, "cpu")
               for v in (e_j, r_j, s_j)]
    got = ecdsa.verify_core(C, kb.pub, e, r, s).numpy()
    assert got.tolist() == want.tolist() == [True] * 3 + [False] * 5
    assert [H.ecdsa_verify_ref(WC, pt, e_, r_, s_) for pt, e_, r_, s_ in zip(
        pubs[:7], es, rs, ss)] == got.tolist()[:7]


def test_q_inv_batched_zero_lanes():
    """The lane tree's zero guard: lanes with s = 0 or s = q give 0 and
    do not poison the other lanes' inverses."""
    rng = np.random.RandomState(52)
    vals = [int.from_bytes(rng.bytes(32), "big") % Q for _ in range(37)]
    vals[0], vals[5], vals[36] = 0, Q, 1
    a = nn.upload(nn.batch_to_limbs(vals, 8), "cpu")
    got = nn.batch_from_limbs(common.q_inv(a, C.q_ctx))
    assert got == [0 if v % Q == 0 else pow(v, -1, Q) for v in vals]
    assert nn.batch_from_limbs(common.q_inv(a[:, :5], C.q_ctx)) == got[:5]
    b = nn.upload(nn.batch_to_limbs(vals[::-1], 8), "cpu")
    assert nn.batch_from_limbs(common.q_mul(a, b, C.q_ctx)) == [
        x * y % Q for x, y in zip(vals, vals[::-1])]
    a, b = a[:, 1:], b[:, 1:]                         # canonical (< q) lanes
    assert nn.batch_from_limbs(common.q_add(a, b, C.q_ctx)) == [
        (x + y) % Q for x, y in zip(vals[1:], vals[::-1][1:])]


def test_wycheproof_p256_rows():
    with open(os.path.join(VEC, "wycheproof_subset.jsonl")) as f:
        rows = [v for v in map(json.loads, f)
                if v["scheme"] == "ECDSA" and v["curve"] == "SECP256R1"]
    assert len(rows) == 36
    assert sum(v["result"] == "valid" for v in rows) == 4
    good = [v for v in rows if len(bytes.fromhex(v["sig"])) == 64]
    kb = K.import_pub_raw(C, "ECDSA", [bytes.fromhex(v["pub"]) for v in good],
                          device="cpu")
    marks = []
    with stages.on_mark(lambda name, *vals: marks.append((name, vals))):
        acc = ecdsa.verify_batch(kb, [bytes.fromhex(v["msg"]) for v in good],
                                 [bytes.fromhex(v["sig"]) for v in good],
                                 good[0]["hash"])
    fails = [(v["tcId"], v["comment"]) for v, a in zip(good, acc)
             if bool(a) != (v["result"] == "valid")]
    assert not fails
    assert [m[0] for m in marks] == ["scalars", "key on curve", "comb",
                                     "table", "windowed", "accept"]
    assert (marks[-1][1][0].numpy() == acc).all()
    bad_len = [v for v in rows if v not in good]
    assert len(bad_len) == 4
    for v in bad_len:             # malformed length: the API raises (rejected)
        one = K.import_pub_raw(C, "ECDSA", [bytes.fromhex(v["pub"])],
                               device="cpu")
        with pytest.raises(ValueError):
            ecdsa.verify_batch(one, [bytes.fromhex(v["msg"])],
                               [bytes.fromhex(v["sig"])])
        assert v["result"] != "valid"


def test_sig_kat_p256_sha256():
    """The reference library's ECDSA SECP256R1 SHA256 signature verifies;
    a changed message and a changed signature do not. Also through the
    digest-level entry point."""
    with open(os.path.join(VEC, "sig_kats.jsonl")) as f:
        kat = [k for k in map(json.loads, f) if (k["alg"], k["curve"],
               k["hash"]) == ("ECDSA", "SECP256R1", "SHA256")][0]
    pub = bytes.fromhex(kat["pub"])
    X, Y, Z = [int.from_bytes(pub[32 * i:32 * (i + 1)], "big")
               for i in range(3)]
    zi = pow(Z, -1, P)
    kb = K.pubkey_batch_from_affine_ints(C, "ECDSA", [X * zi % P] * 3,
                                         [Y * zi % P] * 3, device="cpu")
    msg = kat["msg"].encode()
    sig = bytes.fromhex(kat["sig"])
    bad = bytes([sig[0] ^ 1]) + sig[1:]
    msgs, sigs = [msg, msg + b"x", msg], [sig, sig, bad]
    assert ecdsa.verify_batch(kb, msgs, sigs).tolist() == [True, False,
                                                           False]
    digs = [hashlib.sha256(m).digest() for m in msgs]
    assert ecdsa.verify_digests_batch(kb, digs, sigs).tolist() == [
        True, False, False]


def test_key_import_validates():
    with pytest.raises(ValueError):
        K.pubkey_batch_from_affine_ints(C, "ECDSA", [C.gx], [C.gy + 1],
                                        device="cpu")
    with pytest.raises(ValueError):
        K.pubkey_batch_from_affine_ints(C, "ECDSA", [P], [C.gy],
                                        device="cpu")
    with pytest.raises(ValueError):
        K.import_pub_raw(C, "ECDSA", [b"\x00" * 63], device="cpu")
    kb = K.import_pub_raw(C, "ECDSA", [C.gx.to_bytes(32, "big")
                                       + C.gy.to_bytes(32, "big")],
                          device="cpu")
    assert isinstance(kb.pub, PrjPoint) and kb.pub.x.dtype == torch.int32
    # WEI25519 (h = 8): the default import runs the q*P subgroup check,
    # which passes a clean key and refuses G + T, T of small order
    c25519 = params.get_curve("WEI25519")
    wc = H.WCurve(c25519.fp_ctx.p_int, c25519.a, c25519.b, c25519.gx,
                  c25519.gy, c25519.q, c25519.h)
    bad = H.ec_add(wc, (c25519.gx, c25519.gy), small_order_point(c25519))
    kb = K.pubkey_batch_from_affine_ints(c25519, "ECDSA", [c25519.gx],
                                         [c25519.gy], device="cpu")
    assert kb.n == 1
    with pytest.raises(ValueError, match=r"public key\(s\) \[1\]: point "
                                         "not in the order-q subgroup"):
        K.pubkey_batch_from_affine_ints(c25519, "ECDSA",
                                        [c25519.gx, bad[0]],
                                        [c25519.gy, bad[1]], device="cpu")


def test_affine_accept_path_for_large_cofactor():
    """WEI25519 (h = 8, ceil(p/q) > 2) takes the affine accept test and
    the truncating hash-to-scalar (a 256-bit digest, a 253-bit q). The key
    batch is built without the import checks (test_key_import_validates
    runs the subgroup check)."""
    c = params.get_curve("WEI25519")
    p, q = c.fp_ctx.p_int, c.q
    wc = H.WCurve(p, c.a, c.b, c.gx, c.gy, q, c.h)
    rng = np.random.RandomState(53)
    privs = [1 + int.from_bytes(rng.bytes(32), "big") % (q - 1)
             for _ in range(3)]
    pubs = [H.ec_mul(wc, d, (c.gx, c.gy)) for d in privs]
    msgs = [rng.bytes(20) for _ in range(3)]
    sigs = []
    for d, m in zip(privs, msgs):
        k = 1 + int.from_bytes(rng.bytes(32), "big") % (q - 1)
        r, s = H.ecdsa_sign_ref(wc, d, H.trunc_msb_mod_q(
            hashlib.sha256(m).digest(), q), k)
        sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big"))
    msgs[2] = msgs[2][::-1]
    kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", [pt[0] for pt in pubs],
                                         [pt[1] for pt in pubs],
                                         validate=False, device="cpu")
    want = [H.ecdsa_verify_ref(wc, pt, H.trunc_msb_mod_q(
        hashlib.sha256(m).digest(), q), int.from_bytes(sg[:32], "big"),
        int.from_bytes(sg[32:], "big")) for pt, m, sg in zip(pubs, msgs, sigs)]
    assert want == [True, True, False]
    assert ecdsa.verify_batch(kb, msgs, sigs).tolist() == want
