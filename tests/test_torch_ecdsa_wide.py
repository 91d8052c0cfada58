"""The port's ECDSA verify on P-384 (K = 12 limbs, a = -3) and on the 512-bit
curves BrainpoolP512r1 and GOST512 (K = 16, generic a), on the CPU: kernel
1's plain version under each p and q and the plain point add and double
against the JAX package (K = 28 and 37 limbs of 15 bits, through
convert.py), the plain windowed multiply against the host oracle, the 36
SECP384R1 Wycheproof rows, the P-384 and BrainpoolP512r1 ECDSA and DECDSA
KAT rows under every hash they name (the ECDSA rows also reproduced by the
host signer), and the SHA-224 and SHA-384 tensor code against the hash
KATs. Exact everywhere. test_torch_ecdsa_wide_jax.py holds verify_core
against the JAX package's, lane for lane."""

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

from libecc_tpu_torch import convert, stages
from libecc_tpu_torch.curves import params, scalar_mul, shortw
from libecc_tpu_torch.curves.shortw import PrjPoint
from libecc_tpu_torch.hash import sha2
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import common, ecdsa, keys as K

CURVES = ["SECP384R1", "BRAINPOOLP512R1", "GOST512"]
LIMBS = {"SECP384R1": (12, 28), "BRAINPOOLP512R1": (16, 37),
         "GOST512": (16, 37)}
VEC = os.path.join(os.path.dirname(__file__), "vectors")
HASHLIB = {"SHA224": hashlib.sha224, "SHA256": hashlib.sha256,
           "SHA384": hashlib.sha384, "SHA512": hashlib.sha512,
           "SHA3_384": hashlib.sha3_384}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, n, mod):
    return [int.from_bytes(rng.bytes(80), "big") % mod for _ in range(n)]


def _host(c):
    return H.WCurve(c.fp_ctx.p_int, c.a, c.b, c.gx, c.gy, c.q, c.h)


@pytest.mark.parametrize("which", ["p", "q"])
@pytest.mark.parametrize("name", CURVES)
def test_plain_mont_mul_sqr_against_jax(name, which):
    """Kernel 1's plain version at K = 12 / 16 (R = 2^384 / 2^512) against
    the JAX package's relaxed product at K = 28 / 37, through convert.py,
    edge operands included: m - 1 squared and times m - 2 take the
    reduction's conditional subtraction and carry word at their largest."""
    c, jc = params.get_curve(name), jparams.get_curve(name)
    ctx, jctx = (c.fp_ctx, jc.fp_ctx) if which == "p" else (c.q_ctx,
                                                           jc.q_ctx)
    assert (ctx.k, jctx.k) == LIMBS[name]
    m = ctx.p_int
    rng = np.random.RandomState(91)
    edges = [0, 1, 2, m - 1, m - 2, (1 << (m.bit_length() - 1)) % m]
    xs = edges + _ints(rng, 26, m)
    ys = edges[::-1] + _ints(rng, 26, m)
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


@pytest.mark.parametrize("name", CURVES)
def test_field_add_sub_carry_word(name):
    """mod_add and mod_sub at the edges of each p and q: m - 1 + m - 1 passes
    2^(32K) where the top limb is 0xFFFFFFFF (P-384's p and q) and stays
    below it elsewhere (the 512-bit moduli; GOST512's p has 511 bits)."""
    c = params.get_curve(name)
    for ctx in (c.fp_ctx, c.q_ctx):
        m = ctx.p_int
        xs = [0, 1, m - 1, m - 1, m - 2, 1, m - 1]
        ys = [0, m - 1, m - 1, 1, m - 1, 1, 0]
        a = nn.upload(nn.batch_to_limbs(xs, ctx.k), "cpu")
        b = nn.upload(nn.batch_to_limbs(ys, ctx.k), "cpu")
        assert nn.batch_from_limbs(nn.mod_add(a, b, ctx)) == [
            (x + y) % m for x, y in zip(xs, ys)]
        assert nn.batch_from_limbs(nn.mod_sub(a, b, ctx)) == [
            (x - y) % m for x, y in zip(xs, ys)]
    top = c.fp_ctx.p_int >> (32 * (c.fp_ctx.k - 1))
    assert (top == 0xFFFFFFFF) == (name == "SECP384R1")


def _affine_pairs(c, rng, n=8):
    """n lanes: random, P = Q, P = -Q, O + P, P + O, O + O, random."""
    wc = _host(c)
    A = [H.ec_base_mul(wc, 1 + v % (c.q - 1)) for v in _ints(rng, n, c.q)]
    B = [H.ec_base_mul(wc, 1 + v % (c.q - 1)) for v in _ints(rng, n, c.q)]
    B[1] = A[1]
    B[2] = H.ec_neg(wc, A[2])
    A[3] = None
    B[4] = None
    A[5] = B[5] = None
    return A, B


def _jax_point(jc, pts, rng):
    """Host affine points (None = identity) -> JAX PrjPoint with random Z."""
    p = jc.fp_ctx.p_int
    xs, ys, zs = [], [], []
    for pt, lam in zip(pts, _ints(rng, len(pts), p - 1)):
        lam += 1
        if pt is None:
            xs.append(0), ys.append(lam), zs.append(0)
        else:
            xs.append(pt[0] * lam % p), ys.append(pt[1] * lam % p)
            zs.append(lam)
    f = jc.fp_ctx.from_ints
    return jshortw.PrjPoint(f(xs), f(ys), f(zs))


def _affine(c, vals):
    p = c.fp_ctx.p_int
    X, Y, Z = vals
    return [None if z == 0 else (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)
            for x, y, z in zip(X, Y, Z)]


@pytest.mark.parametrize("name", CURVES)
def test_plain_point_add_dbl_against_jax(name):
    """Kernels 2 and 3's plain versions (a = -3 at K = 12, generic a at
    K = 16) against the JAX package's shortw.point_add and point_dbl, as
    projective values mod p: identity, P = Q and P = -Q lanes included."""
    c, jc = params.get_curve(name), jparams.get_curve(name)
    assert c.a_is_m3 == (name == "SECP384R1") and not c.a_is_0
    rng = np.random.RandomState(92)
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


@pytest.mark.parametrize("name", ["SECP384R1", "BRAINPOOLP512R1"])
def test_plain_windowed_mul_against_the_oracle(name):
    """Kernel 4's plain version at K = 12 (96 windows) and K = 16 (128
    windows, generic a) through windowed_mul_public: scalars whose last
    add is T + O, -T + T and T + T, then 1, q - 1 and a random one, on
    random points and the identity; compared in affine form mod p."""
    c = params.get_curve(name)
    wc = _host(c)
    rng = np.random.RandomState(93)
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
    assert scalar_mul._window_digits(mt, c.scalar_bits()).shape == (
        c.scalar_bits() // 4, len(ms))
    R = scalar_mul.windowed_mul_public(c, mt, P)
    got = _affine(c, [c.fp_ctx.to_ints(v) for v in R])
    assert got == [H.ec_mul(wc, m, pt) for m, pt in zip(ms, pts)]
    assert got[:3] == [None, None, H.ec_mul(wc, 2 * ((-c.q) % 16), pts[2])]
    assert shortw.on_curve_mask(c, R).all()


def test_comb_tables_build_once():
    """The 8-bit comb of G (48 windows at 384 bits, 64 at 512) is built on
    the host once per process and cached."""
    for name, nwin in (("SECP384R1", 48), ("BRAINPOOLP512R1", 64)):
        c = params.get_curve(name)
        tab, n = scalar_mul._comb_table_host(c, c.scalar_bits())
        assert n == nwin and tab.shape == (nwin * 256, 3, c.fp_ctx.k)
        assert scalar_mul._comb_table_host(c, c.scalar_bits())[0] is tab


def _wycheproof_p384():
    with open(os.path.join(VEC, "wycheproof_subset.jsonl")) as f:
        return [v for v in map(json.loads, f) if v.get("scheme") == "ECDSA"
                and v.get("curve") == "SECP384R1"]


def test_wycheproof_p384_rows():
    """The 36 rows: the 32 of the right length as one verify_batch call
    (their stage marks in order, at K = 12), the 4 truncated or extended
    signatures raise ValueError, as the reference's _verify_dispatch."""
    c = params.get_curve("SECP384R1")
    rows = _wycheproof_p384()
    assert len(rows) == 36 and {v["hash"] for v in rows} == {"SHA256"}
    good = [v for v in rows if len(bytes.fromhex(v["sig"])) == 96]
    bad_len = [v for v in rows if v not in good]
    assert sorted(v["tcId"] for v in bad_len) == [50, 51, 68, 69]
    kb = K.import_pub_raw(c, "ECDSA", [bytes.fromhex(v["pub"]) for v in good],
                          device="cpu")
    marks = []
    with stages.on_mark(lambda name, *vals: marks.append((name, vals))):
        acc = ecdsa.verify_batch(kb, [bytes.fromhex(v["msg"]) for v in good],
                                 [bytes.fromhex(v["sig"]) for v in good],
                                 "SHA256")
    fails = [(v["tcId"], v["comment"]) for v, a in zip(good, acc)
             if bool(a) != (v["result"] == "valid")]
    assert not fails
    assert [m[0] for m in marks] == ["scalars", "key on curve", "comb",
                                     "table", "windowed", "accept"]
    table, digs = dict(marks)["table"]
    assert table.shape == (16, 3, 12, 32) and digs.shape == (96, 32)
    for v in bad_len:
        one = K.import_pub_raw(c, "ECDSA", [bytes.fromhex(v["pub"])],
                               device="cpu")
        with pytest.raises(ValueError, match="bad signature length"):
            ecdsa.verify_batch(one, [bytes.fromhex(v["msg"])],
                               [bytes.fromhex(v["sig"])])
        assert v["result"] != "valid"


def _pub_xyz(c, pub: bytes):
    """A KAT's public key X || Y || Z (projective, big-endian) -> affine."""
    nb = len(pub) // 3
    X, Y, Z = [int.from_bytes(pub[nb * i:nb * (i + 1)], "big")
               for i in range(3)]
    p = c.fp_ctx.p_int
    zi = pow(Z, -1, p)
    return X * zi % p, Y * zi % p


KAT_NAMES = {"ECDSA-SHA384/secp384r1", "ECDSA-SHA3_384/secp384r1",
             "ECDSA-SHA512/brainpoolp512r1"}


def _kat_rows():
    """(curve, hash, pub, msg, sig, source row) of the listed kats_full
    rows (the ECDSA ones above and the eight DECDSA SECP384R1 rows) and of
    the SECP384R1 and BRAINPOOLP512R1 ECDSA / DECDSA rows of
    sig_kats.jsonl."""
    out = []
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        for r in map(json.loads, f):
            if r["name"] in KAT_NAMES or (r.get("alg") == "DECDSA"
                                          and r["curve"] == "SECP384R1"):
                out.append((r["curve"], r["hash"], bytes.fromhex(r["pub"]),
                            bytes.fromhex(r["msg_hex"]),
                            bytes.fromhex(r["sig"]), r))
    with open(os.path.join(VEC, "sig_kats.jsonl")) as f:
        for r in map(json.loads, f):
            if r["alg"] in ("ECDSA", "DECDSA") and r["curve"] in (
                    "SECP384R1", "BRAINPOOLP512R1"):
                out.append((r["curve"], r["hash"], bytes.fromhex(r["pub"]),
                            r["msg"].encode(), bytes.fromhex(r["sig"]), r))
    return out


def test_kat_row_count():
    rows = _kat_rows()
    assert len(rows) == 14
    assert sorted({(r[0], r[1]) for r in rows}) == [
        ("BRAINPOOLP512R1", "SHA512"), ("SECP384R1", "SHA224"),
        ("SECP384R1", "SHA256"), ("SECP384R1", "SHA384"),
        ("SECP384R1", "SHA3_384"), ("SECP384R1", "SHA512")]


@pytest.mark.parametrize("row", [r for r in _kat_rows()
                                 if r[5].get("nonce")],
                         ids=lambda r: r[5]["name"])
def test_kat_rows_host_signer(row):
    """hostref.ecdsa_sign_ref with the row's nonce reproduces the ECDSA
    rows' signature byte for byte."""
    name, hash_name, pub, msg, sig, r = row
    c = params.get_curve(name)
    wc = _host(c)
    d = int(r["priv"], 16)
    assert H.ec_base_mul(wc, d) == _pub_xyz(c, pub)
    e = H.trunc_msb_mod_q(HASHLIB[hash_name](msg).digest(), c.q)
    rr, s = H.ecdsa_sign_ref(wc, d, e, int(r["nonce"], 16))
    nb = (c.q.bit_length() + 7) // 8
    assert rr.to_bytes(nb, "big") + s.to_bytes(nb, "big") == sig


def _kat_groups():
    groups = defaultdict(list)
    for row in _kat_rows():
        groups[(row[0], row[1])].append(row)
    return sorted(groups.items())


@pytest.mark.parametrize("group", _kat_groups(),
                         ids=lambda g: f"{g[0][0]}-{g[0][1]}")
def test_kat_rows_verify(group):
    """The KAT rows of one (curve, hash) as one verify_batch call with the
    hash by name: each accepts, and rejects with another message or a
    flipped bit of r. The scalar e is also held against hashlib."""
    (name, hash_name), rows = group
    c = params.get_curve(name)
    xs, ys, msgs, sigs, want = [], [], [], [], []
    for _, _, pub, msg, sig, _ in rows:
        x, y = _pub_xyz(c, pub)
        xs += [x] * 3
        ys += [y] * 3
        msgs += [msg, msg + b"x", msg]
        sigs += [sig, sig, bytes([sig[0] ^ 1]) + sig[1:]]
        want += [True, False, False]
    kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", xs, ys, device="cpu")
    e = common.e_from_msgs(msgs, c.q_ctx, "cpu", hash_name)
    assert nn.batch_from_limbs(e) == [
        H.trunc_msb_mod_q(HASHLIB[hash_name](m).digest(), c.q) for m in msgs]
    assert ecdsa.verify_batch(kb, msgs, sigs, hash_name).tolist() == want


def test_hashes_by_name_and_digest_entry_point():
    """verify_digests_batch takes the digest of the named hash (its length
    sets the truncation); mixed block counts hash bucket by bucket on the
    device; the fused bytes-in path takes SHA-224 and SHA-256 only, and an
    unported name raises."""
    c = params.get_curve("SECP384R1")
    r = next(row for row in _kat_rows()
             if row[5].get("name") == "ECDSA-SHA384/secp384r1")
    _, _, pub, msg, sig, _ = r
    x, y = _pub_xyz(c, pub)
    kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", [x] * 2, [y] * 2,
                                         device="cpu")
    digs = [hashlib.sha384(m).digest() for m in (msg, msg + b"x")]
    assert ecdsa.verify_digests_batch(kb, digs, [sig] * 2,
                                      "SHA-384").tolist() == [True, False]
    rng = np.random.RandomState(94)
    mixed = [rng.bytes(n) for n in (0, 55, 56, 111, 112, 200, 3)]
    for name in ("SHA224", "SHA384", "SHA3_384", "SHA-512"):
        e = common.e_from_msgs(mixed, c.q_ctx, "cpu", name)
        h = HASHLIB[name.replace("-", "")]
        assert nn.batch_from_limbs(e) == [
            H.trunc_msb_mod_q(h(m).digest(), c.q) for m in mixed]
    with pytest.raises(ValueError, match="not ported"):
        ecdsa.verify_batch(kb, [msg] * 2, [sig] * 2, "SM3")
    with pytest.raises(ValueError, match="not ported"):
        ecdsa.verify_batch_async(kb, [msg] * 2, [sig] * 2, "STREEBOG512")
    assert common.hasher("SHA-224").pack is sha2.pack_blocks_sha256
    assert common.hasher("SHA384").pack is sha2.pack_blocks_sha512


def test_verify_batch_async_fused_sha224_and_unfused_sha384():
    """64 lanes of one message length: SHA-224 takes the fused bytes-in path
    ("hash" mark), SHA-384 the unfused one (no "hash" mark); both give the
    host oracle's answers."""
    c = params.get_curve("SECP384R1")
    wc = _host(c)
    rng = np.random.RandomState(95)
    d = 1 + _ints(rng, 1, c.q - 1)[0]
    pub = H.ec_base_mul(wc, d)
    kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", [pub[0]] * 64,
                                         [pub[1]] * 64, device="cpu")
    for hash_name, fused in (("SHA224", True), ("SHA384", False)):
        msgs = [rng.bytes(32) for _ in range(64)]
        sigs = []
        for m in msgs:
            e = H.trunc_msb_mod_q(HASHLIB[hash_name](m).digest(), c.q)
            rr, s = H.ecdsa_sign_ref(wc, d, e, 1 + _ints(rng, 1, c.q - 1)[0])
            sigs.append(rr.to_bytes(48, "big") + s.to_bytes(48, "big"))
        sigs[5] = sigs[6]                            # another message's
        marks = []
        with stages.on_mark(lambda name, *vals: marks.append(name)):
            acc = ecdsa.verify_batch_async(kb, msgs, sigs, hash_name)
        assert ("hash" in marks) == fused
        assert acc.tolist() == [i != 5 for i in range(64)]


LENS = [0, 3, 55, 56, 64, 65, 137, 1000]       # test_hash_parity.py's set


def _kat_msg(ln):
    """The hash KATs' message of each length (as tests/test_hash_parity.py)."""
    if ln == 0:
        return b""
    if ln == 3:
        return b"abc"
    idx = LENS.index(ln)
    return bytes(((j * 7 + idx * 31) & 0xFF) for j in range(ln))


@pytest.mark.parametrize("name", ["SHA224", "SHA384"])
def test_sha224_sha384_against_hash_kats(name):
    """The tensor SHA-224 and SHA-384 against the hash KATs' rows, through
    batch_digests (each block count in one call) and, for the one-block
    messages, the tensor function itself."""
    with open(os.path.join(VEC, "hash_kats.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if r["alg"] == name]
    assert sorted(r["len"] for r in rows) == LENS
    msgs = [_kat_msg(r["len"]) for r in rows]
    got = common.batch_digests(name, msgs, "cpu")
    assert [g.hex() for g in got] == [r["digest"] for r in rows]
    pack = (sha2.pack_blocks_sha256 if name == "SHA224"
            else sha2.pack_blocks_sha512)
    fn = sha2.sha224_device if name == "SHA224" else sha2.sha384_device
    one = [m for m in msgs if len(m) < 50]
    words = fn(nn.upload(pack(one), "cpu"))
    n = 28 if name == "SHA224" else 48
    assert words.shape == (n // 4, len(one))
    raw = nn.to_host(words).T.astype(">u4").tobytes()
    assert [raw[i * n:(i + 1) * n].hex() for i in range(len(one))] == [
        r["digest"] for r in rows if r["len"] < 50]
