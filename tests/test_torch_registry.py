"""The port's ECDSA verify on the cofactor-1 curves at K = 6 and 7 (P-192,
BrainpoolP192r1/t1, SM2P192TEST, secp192k1; P-224, BrainpoolP224r1/t1,
secp224k1), on the CPU, against the host oracle: 16 lanes a curve through
verify_batch (valid lanes, the key G and -G, every rejection class, both
candidates of the projective accept test), and the ECDSA and DECDSA KAT
rows of SECP192R1, SECP224R1 and BRAINPOOLP384R1 under every hash they
name. secp224k1 is the one registry curve with q > p (K_q = 8 over K_p =
7): its lane 10 carries r in [p, q) with r - p = x(W), which must reject.
Exact everywhere. The helpers serve the other test_torch_registry*
files: the wider curves (test_torch_registry_wide.py), ECFSDSA batch
verification (test_torch_registry_fsdsa*.py) and the comparisons with
the JAX package (test_torch_registry_jax*.py)."""

import hashlib
import json
import os
from collections import defaultdict

import numpy as np
import pytest
import torch

from libecc_tpu_torch.curves import params
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import batch_verify as bv, common, ecdsa, \
    keys as K

VEC = os.path.join(os.path.dirname(__file__), "vectors")
# one curve for each (K, a) instance of kernels 2-4 and 6 that the
# registry's cofactor-1 curves need beyond the earlier ones, then the
# curves that share an instance
K6_K7 = ["SECP192R1", "BRAINPOOLP192R1", "SECP192K1", "SECP224R1",
         "BRAINPOOLP224R1", "SECP224K1", "BRAINPOOLP192T1", "SM2P192TEST",
         "BRAINPOOLP224T1"]
WIDE = ["BRAINPOOLP320T1", "BRAINPOOLP320R1", "BRAINPOOLP384R1",
        "BRAINPOOLP512T1", "BIGN512V1", "GOST_R3410_2012_512_PARAMSETA",
        "GOST_R3410_2012_512_PARAMSETB"]
# the hash each curve's users pair with it (SHA-256 elsewhere)
HASH = {"SECP224R1": "SHA224", "BRAINPOOLP320T1": "SHA384",
        "BRAINPOOLP320R1": "SHA384", "BRAINPOOLP384R1": "SHA384",
        "BRAINPOOLP512T1": "SHA512"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host(c):
    return H.WCurve(c.fp_ctx.p_int, c.a, c.b, c.gx, c.gy, c.q, c.h)


def ints(rng, n, mod):
    """n random residues mod `mod` from 64 bits more than it has."""
    nb = (mod.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nb), "big") % mod for _ in range(n)]


def digest(hash_name, m):
    return hashlib.new(hash_name.lower().replace("-", ""), m).digest()


def _point_with_x(c, x0):
    """The first curve point whose x is x0 + t (t = 0, 1, ...)."""
    p = c.fp_ctx.p_int
    for t in range(1000):
        y = H.sqrt_mod((x0 + t) ** 3 + c.a * (x0 + t) + c.b, p)
        if y is not None:
            return t, (x0 + t, y)
    raise AssertionError("no point found")


def ecdsa_lanes(c, hash_name, seed):
    """16 lanes of (affine key, message, r, s) covering every rejection
    class of the verifier, as the JAX comparisons' lanes do:
    0, 1, 11, 14 valid (11 under the key G, 14 under -G); 2 r + 1; 3 s = 0;
    4 r = 0; 5 s = q; 6 r = q; 7 another message; 8 an off-curve key;
    9 r = 12345 (r < p - q: the r + q candidate is tried and rejects) or,
    where q > p, r = p + 12345; 12 s = q + 1; 13 r = q + 5; 15 lane 14's
    key. Lane 10: where q < p, a key under which r = x(W) - q verifies
    (accepted through the projective test's second candidate); where
    q > p (secp224k1), r in [p, q) with r - p = x(W) (rejected: x(W) mod
    q is not r). Returns the host curve, the lanes and the wanted mask."""
    p, q = c.fp_ctx.p_int, c.q
    wc = host(c)
    rng = np.random.RandomState(seed)

    def rnd():
        return 1 + ints(rng, 1, q - 1)[0]

    def e_of(m):
        return H.trunc_msb_mod_q(digest(hash_name, m), q)

    lanes = []
    for i in range(16):
        d, m = {11: 1, 14: q - 1}.get(i, rnd()), rng.bytes(32)
        r, s = H.ecdsa_sign_ref(wc, d, e_of(m), rnd())
        lanes.append([H.ec_base_mul(wc, d), m, r, s])
    lanes[2][2] += 1                                         # r + 1
    lanes[3][3] = 0                                          # s = 0
    lanes[4][2] = 0                                          # r = 0
    lanes[5][3] = q                                          # s = q
    lanes[6][2] = q                                          # r = q
    lanes[7][1] = b"another message"
    x, y = lanes[8][0]
    lanes[8][0] = (x, (y + 1) % p)                           # off-curve key
    lanes[9][2] = 12345 if q < p else p + 12345
    assert lanes[9][2] < q and (q > p or 12345 < p - q)
    lanes[12][3] = q + 1                                     # s > q
    lanes[13][2] = q + 5                                     # r > q
    lanes[15][0] = lanes[14][0]                              # another key
    # lane 10: W with x(W) = q + t < p (r = t), or x(W) = t with
    # r = p + t < q; then Y = v^-1 (W - u G)
    t, W = _point_with_x(c, q + 1 if q < p else 1)
    r = W[0] - q if q < p else W[0] + p
    assert 0 < r < q and W[0] < p
    e, s = e_of(lanes[10][1]), rnd()
    si = pow(s, -1, q)
    u, v = e * si % q, r * si % q
    Y = H.ec_mul(wc, pow(v, -1, q), H.ec_add(
        wc, W, H.ec_neg(wc, H.ec_base_mul(wc, u))))
    lanes[10][0], lanes[10][2], lanes[10][3] = Y, r, s
    want = [i in (0, 1, 11, 14) or (i == 10 and q < p) for i in range(16)]
    return wc, lanes, want


def key_batch(c, alg, pts, validate=True):
    return K.pubkey_batch_from_affine_ints(
        c, alg, [P[0] for P in pts], [P[1] for P in pts], validate=validate,
        device="cpu")


def check_ecdsa_curve(name, seed):
    """verify_batch on ecdsa_lanes: the wanted mask, and the host oracle on
    every lane whose key is on the curve."""
    c = params.get_curve(name)
    hash_name = HASH.get(name, "SHA256")
    wc, lanes, want = ecdsa_lanes(c, hash_name, seed)
    nb = (c.q.bit_length() + 7) // 8
    kb = key_batch(c, "ECDSA", [ln[0] for ln in lanes], validate=False)
    sigs = [r.to_bytes(nb, "big") + s.to_bytes(nb, "big")
            for _, _, r, s in lanes]
    got = ecdsa.verify_batch(kb, [ln[1] for ln in lanes], sigs, hash_name)
    assert got.tolist() == want
    oracle = [i != 8 and H.ecdsa_verify_ref(
        wc, Y, H.trunc_msb_mod_q(digest(hash_name, m), c.q), r, s)
        for i, (Y, m, r, s) in enumerate(lanes)]
    assert oracle == want
    return c


def test_the_slice_covers_the_cofactor_1_registry():
    """The 16 curves of this slice are every cofactor-1 short-Weierstrass
    curve of the registry at K = 6, 7 and 10, at K = 12 with generic a and
    at K = 16 with a = -3; one curve of each (K, a) leads its group."""
    names = set(K6_K7 + WIDE)
    assert len(names) == 16
    for key in params._CURVES:
        c = params.get_curve(key)
        k, m3, a0 = c.fp_ctx.k, c.a_is_m3, c.a_is_0
        new = c.h == 1 and (k in (6, 7, 10) or (k, m3, a0) in (
            (12, False, False), (16, True, False)))
        assert new == (c.name in names), c.name
    ks = [(params.get_curve(n).fp_ctx.k, params.get_curve(n).q_ctx.k)
          for n in ("SECP192K1", "SECP224K1", "BRAINPOOLP320R1")]
    assert ks == [(6, 6), (7, 8), (10, 10)]


@pytest.mark.parametrize("name", K6_K7)
def test_ecdsa_verify_matches_the_host_oracle(name):
    c = check_ecdsa_curve(name, 301)
    assert c.fp_ctx.k in (6, 7)


def test_secp224k1_r_in_p_to_q_rejects():
    """secp224k1: q > p, so no second candidate; r in [p, q) with
    r - p = x(W) would pass the projective test mod p, and the guard
    lt(r, p) rejects it (lane 10 of ecdsa_lanes, alone)."""
    c = params.get_curve("SECP224K1")
    p, q = c.fp_ctx.p_int, c.q
    assert q > p and q.bit_length() == 225 and c.scalar_bits() == 225
    wc, lanes, _ = ecdsa_lanes(c, "SHA256", 302)
    Y, m, r, s = lanes[10]
    assert p <= r < q
    e = H.trunc_msb_mod_q(digest("SHA256", m), q)
    si = pow(s, -1, q)
    W = H.ec_add(wc, H.ec_base_mul(wc, e * si % q), H.ec_mul(wc, r * si % q,
                                                             Y))
    assert W[0] == r - p                     # r = x(W) mod p, not mod q
    kb = key_batch(c, "ECDSA", [Y, lanes[0][0]])
    sig0 = lanes[0][2].to_bytes(29, "big") + lanes[0][3].to_bytes(29, "big")
    sig = r.to_bytes(29, "big") + s.to_bytes(29, "big")
    got = ecdsa.verify_batch(kb, [m, lanes[0][1]], [sig, sig0])
    assert got.tolist() == [False, True]


def kat_rows(curve, algs=("ECDSA", "DECDSA")):
    """The curve's rows of kats_full.jsonl and sig_kats.jsonl for algs, as
    (hash, pub X || Y || Z, msg, sig, row)."""
    rows = []
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        for r in map(json.loads, f):
            if r.get("alg") in algs and r.get("curve") == curve:
                rows.append((r["hash"], bytes.fromhex(r["pub"]),
                             bytes.fromhex(r["msg_hex"]),
                             bytes.fromhex(r["sig"]), r))
    with open(os.path.join(VEC, "sig_kats.jsonl")) as f:
        for r in map(json.loads, f):
            if r["alg"] in algs and r["curve"] == curve:
                rows.append((r["hash"], bytes.fromhex(r["pub"]),
                             r["msg"].encode(), bytes.fromhex(r["sig"]), r))
    return rows


def pub_affine(c, pub):
    """A KAT row's projective public key X || Y || Z as affine ints."""
    p, nbp = c.fp_ctx.p_int, len(pub) // 3
    X, Y, Z = [int.from_bytes(pub[nbp * i:nbp * (i + 1)], "big")
               for i in range(3)]
    zi = pow(Z, -1, p)
    return X * zi % p, Y * zi % p


@pytest.mark.parametrize("name,hashes", [
    ("SECP192R1", {"SHA224": 4, "SHA256": 2, "SHA384": 2, "SHA512": 2}),
    ("SECP224R1", {"SHA224": 2, "SHA3_224": 1}),
    ("BRAINPOOLP384R1", {"SHA384": 1})])
def test_ecdsa_kat_rows(name, hashes):
    """Every ECDSA and DECDSA KAT row of the curve, each under its own hash
    (the port's tensor hash of the name, common.e_from_msgs), in one
    verify_core call: each row accepts, and rejects with another message
    or a flipped bit of r."""
    c = params.get_curve(name)
    rows = kat_rows(name)
    counts = defaultdict(int)
    for h, *_ in rows:
        counts[h] += 1
    assert dict(counts) == hashes
    nb = (c.q.bit_length() + 7) // 8
    pts, es, sigs, want = [], [], [], []
    for h, pub, msg, sig, _ in rows:
        assert len(sig) == 2 * nb
        pts += [pub_affine(c, pub)] * 3
        es.append(common.e_from_msgs([msg, msg + b"x", msg], c.q_ctx, "cpu",
                                     h))
        sigs += [sig, sig, bytes([sig[0] ^ 1]) + sig[1:]]
        want += [True, False, False]
    kb = key_batch(c, "ECDSA", pts)
    r = nn.upload(nn.bytes_be_to_limbs_np([s[:nb] for s in sigs],
                                          c.q_ctx.k), "cpu")
    s = nn.upload(nn.bytes_be_to_limbs_np([s[nb:] for s in sigs],
                                          c.q_ctx.k), "cpu")
    got = ecdsa.verify_core(c, kb.pub, torch.cat(es, 1), r, s)
    assert got.tolist() == want


def fsdsa_batch(c, hash_name, seed, n=12):
    """n ECFSDSA lanes from the host signer (keys G and -G, nonces 1 and
    q - 1 among them): (affine keys, messages, signatures)."""
    q = c.q
    wc = host(c)
    rng = np.random.RandomState(seed)
    ds = [1, q - 1] + [1 + v for v in ints(rng, n - 2, q - 1)]
    ks = [3, 5, 1, q - 1] + [1 + v for v in ints(rng, n - 4, q - 1)]
    msgs = [rng.bytes(32) for _ in range(n)]
    sigs = [H.ecfsdsa_sign_ref(wc, d, k, m, hash_name)
            for d, k, m in zip(ds, ks, msgs)]
    return [H.ec_base_mul(wc, d) for d in ds], msgs, sigs


def check_fsdsa_curve(name, hash_name, seed, device_reject, kat=None):
    """ECFSDSA batch verification of fsdsa_batch's lanes (with the KAT row
    kat = (pub, msg, sig) appended): the batch accepts; it rejects with
    s = 0 on one lane and with x(R) = p on one lane (both refused while
    parsing), and, with device_reject, with one flipped bit of s (or, with
    a KAT row, the row under another message), which only the combined
    check on the points finds."""
    c = params.get_curve(name)
    pts, msgs, sigs = fsdsa_batch(c, hash_name, seed)
    p_len = (c.fp_ctx.bits + 7) // 8
    nb = (c.q.bit_length() + 7) // 8
    assert all(len(sg) == 2 * p_len + nb for sg in sigs)
    if kat is not None:
        pts.append(kat[0]), msgs.append(kat[1]), sigs.append(kat[2])
    kb = key_batch(c, "ECFSDSA", pts)

    def verify(ms, ss, seed_=seed):
        return bv.ecfsdsa_verify_batch(
            kb, ms, ss, hash_name, rng=np.random.RandomState(seed_).bytes,
            device="cpu")

    def swap(i, sg):
        return sigs[:i] + [sg] + sigs[i + 1:]

    assert verify(msgs, sigs) is True
    assert verify(msgs, swap(6, sigs[6][:2 * p_len] + bytes(nb))) is False
    x_p = c.fp_ctx.p_int.to_bytes(p_len, "big")
    assert verify(msgs, swap(7, x_p + sigs[7][p_len:])) is False
    if device_reject:
        if kat is None:
            flip = sigs[5][:-1] + bytes([sigs[5][-1] ^ 1])
            assert verify(msgs, swap(5, flip), seed + 1) is False
        else:
            assert verify(msgs[:-1] + [msgs[-1] + b"x"], sigs) is False
    return c
