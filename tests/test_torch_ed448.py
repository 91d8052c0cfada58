"""The port's Ed448 / Ed448ph verification (K = 14 limbs, a = 1) on the CPU:
kernel 1's plain version under Ed448's p and q and the plain K = 14
windowed multiply against the JAX package and the host oracle, the verify
path against the JAX package's verify_core called eagerly, the ED448
Wycheproof rows and the EDDSA448 / EDDSA448PH KAT rows, and the port's
RFC 8032 Ed448 host signer against the KAT bytes. Exact everywhere."""

import hashlib
import json
import os
from collections import defaultdict

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import edwards as jed
from libecc_tpu.nn import core as jnn
from libecc_tpu.sig import eddsa as jeddsa

from libecc_tpu_torch import convert, stages
from libecc_tpu_torch.curves import edwards as ed, scalar_mul
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import eddsa

C = ed.get_edwards_curve("ED448")
P, Q = C.fp_ctx.p_int, C.q
HC = H.EdCurve(P, C.a, C.d, C.gx, C.gy, Q, C.h)
VEC = os.path.join(os.path.dirname(__file__), "vectors")
VARIANT = {"EDDSA448": "ed448", "EDDSA448PH": "ed448ph"}
SIGN = 1 << 455


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, n, mod):
    return [int.from_bytes(rng.bytes(64), "big") % mod for _ in range(n)]


def _wycheproof():
    with open(os.path.join(VEC, "wycheproof_subset.jsonl")) as f:
        return [v for v in map(json.loads, f)
                if v.get("scheme") == "EDDSA" and v.get("curve") == "ED448"]


def _kats():
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("alg") in VARIANT]


def _ctx(row):
    return bytes.fromhex(row["adata_hex"]) if row["adata_hex"] else b""


def _enc(v):
    return v.to_bytes(57, "little")


def _no_x_y():
    """The least y whose (y^2 - 1)/(d y^2 - 1) is not a square."""
    return next(y for y in range(2, 100) if pow(
        (y * y - 1) * pow(C.d * y * y - 1, -1, P) % P, (P - 1) // 2, P) != 1)


@pytest.mark.parametrize("which", ["p", "q"])
def test_plain_mont_mul_sqr_against_jax(which):
    """Kernel 1's plain version at K = 14 (R = 2^448) against the JAX
    package's relaxed product at K = 32 (15-bit limbs, R = 2^480), through
    convert.py, edge operands included."""
    jc = jed.get_edwards_curve("ED448")
    ctx, jctx = (C.fp_ctx, jc.fp_ctx) if which == "p" else (C.q_ctx,
                                                           jc.q_ctx)
    assert (ctx.k, jctx.k) == (14, 32)
    m = ctx.p_int
    rng = np.random.RandomState(41)
    edges = [0, 1, 2, m - 1, m - 2, (1 << 447) % m]
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
    assert np.array_equal(convert.fe_to_jax(got, ctx, jctx.k),
                          jnn.batch_to_limbs([x * y % m * jctx.R % m
                                              for x, y in zip(xs, ys)],
                                             jctx.k))


def test_convert_scalars_k32_to_k14():
    jc = jed.get_edwards_curve("ED448")
    rng = np.random.RandomState(42)
    vals = [0, 1, Q - 1, (1 << 448) - 1] + _ints(rng, 4, Q)
    sj = jnn.batch_to_limbs(vals, jc.q_ctx.k)
    st = convert.scalars_from_jax(sj, C.q_ctx.k, "cpu")
    assert st.shape == (14, 8) and nn.batch_from_limbs(st) == vals
    assert np.array_equal(convert.scalars_to_jax(st, jc.q_ctx.k), sj)


def _extended(pts, rng):
    lam = [1 + v % (P - 1) for v in _ints(rng, len(pts), P)]
    cols = zip(*[(x * m, y * m, m, x * y * m) for (x, y), m in zip(pts, lam)])
    return ed.ExtPoint(*[C.fp_ctx.from_ints([v % P for v in col], "cpu")
                         for col in cols])


def test_plain_windowed_mul_k14_against_the_oracle():
    """Kernel 7's plain version at K = 14 (112 windows of 4 bits for q's
    446 bits) through windowed_mul_public: zero, one, short, q - 1 and
    random scalars on random and identity points, compared in affine form
    mod p (the JAX package may pick another window or comb)."""
    rng = np.random.RandomState(43)
    pts = [H.ed_base_mul(HC, k) for k in _ints(rng, 6, Q)] + [(0, 1)]
    ms = [0, 1, 5, (1 << 37) + 3, Q - 1] + _ints(rng, 2, Q)
    Pt = _extended(pts, rng)
    m = nn.upload(nn.batch_to_limbs(ms, C.q_ctx.k), "cpu")
    assert scalar_mul._window_digits(m, C.scalar_bits()).shape == (112, 7)
    R = scalar_mul.windowed_mul_public(C, m, Pt)
    x, y = ed.to_affine_plain(C, R)
    got = list(zip(nn.batch_from_limbs(x), nn.batch_from_limbs(y)))
    assert got == [H.ed_mul(HC, k, pt) for k, pt in zip(ms, pts)]
    assert ed.on_curve_mask(C, R).all()


def _lanes():
    """16 lanes of (pub, R, S, message) wire values: valid signatures, every
    rejection class of the verifier, and A = identity."""
    rng = np.random.RandomState(44)
    lanes = []
    for _ in range(16):
        seed, msg = rng.bytes(57), rng.bytes(32)
        pub, sig = H.ed448_sign(HC, seed, msg)
        lanes.append([pub, sig[:57], int.from_bytes(sig[57:], "little"), msg])
    lanes[3][1] = bytes([lanes[3][1][0] ^ 1]) + lanes[3][1][1:]  # R bit flip
    lanes[4][2] += Q                                         # S + q
    lanes[5][2] = Q                                          # S = q
    lanes[6][2] += 1 << 448                  # S >= 2^448 (valid S mod 2^448)
    lanes[7][3] = lanes[7][3][::-1]                          # other message
    lanes[8][0] = _enc(_no_x_y())                            # A: y has no x
    lanes[9][0] = _enc(P + 1)                                # A: y >= p
    a = int.from_bytes(lanes[10][0], "little")               # A: bit 450 set
    lanes[10][0] = _enc(a | 1 << 450)        # (the valid y mod 2^448)
    lanes[11][0] = _enc(1 | SIGN)                            # x = 0, sign 1
    lanes[12][1] = _enc(P + 3)                               # R: y >= p
    r = int.from_bytes(lanes[13][1], "little")               # R: bit 452 set
    lanes[13][1] = _enc(r | 1 << 452)
    r = 12345                                                # A = identity:
    lanes[14][0] = _enc(1)                                   # S*B == R
    lanes[14][1] = H.ed448_encode(H.ed_base_mul(HC, r))
    lanes[14][2] = r
    lanes[15][1] = _enc(_no_x_y() | SIGN)                    # R: y has no x
    return lanes


WANT = [True] * 3 + [False] * 11 + [True, False]


@pytest.fixture(scope="module")
def wire():
    """The 16 lanes as wire bytes and their challenges k = SHAKE256(dom4 ||
    R || A || M, 114) mod q (host hashlib)."""
    lanes = _lanes()
    pubs = [ln[0] for ln in lanes]
    sigs = [ln[1] + ln[2].to_bytes(57, "little") for ln in lanes]
    msgs = [ln[3] for ln in lanes]
    dom = H.ed448_dom("ed448", b"")
    ks = [int.from_bytes(hashlib.shake_256(dom + s[:57] + pk + m).digest(114),
                         "little") % Q for pk, s, m in zip(pubs, sigs, msgs)]
    return pubs, sigs, msgs, ks


@pytest.fixture(scope="module")
def jax_accept(wire):
    """The JAX package's parse_verify_inputs and verify_core (K = 32),
    called eagerly once (its jitted form takes minutes to compile on the
    CPU): the accept mask of the 16 lanes."""
    pubs, sigs, _, ks = wire
    jc = jed.get_edwards_curve("ED448")
    v = jeddsa.get_variant("ed448")
    pr = jeddsa.parse_verify_inputs(jc, v, pubs, sigs)
    fk, qk = jc.fp_ctx.k, jc.q_ctx.k
    acc = np.asarray(jeddsa.verify_core(
        jc, jnp.asarray(jnn.batch_to_limbs(pr["ay"], fk)),
        jnp.asarray(np.array(pr["asign"], np.uint32)),
        jnp.asarray(jnn.batch_to_limbs(pr["ry"], fk)),
        jnp.asarray(np.array(pr["rsign"], np.uint32)),
        jnp.asarray(jnn.batch_to_limbs(pr["S_l"], qk)),
        jnp.asarray(jnn.batch_to_limbs(ks, qk))))
    return (acc & np.array(pr["pre_ok"])).tolist()


def test_verify_matches_jax_lane_for_lane(wire, jax_accept):
    """Lanes 6, 10 and 13 carry a value at or above 2^448 whose low 448
    bits are the valid one: the port rejects them while parsing, as the
    reference rejects y >= p and S >= q, and never truncates them."""
    pubs, sigs, msgs, ks = wire
    parsed = eddsa.parse_verify_inputs(C, eddsa.get_variant("ed448"), pubs,
                                       sigs)
    assert parsed["pre_ok"].tolist() == [i not in (6, 10, 13)
                                         for i in range(16)]
    assert parsed["ay"].shape == (14, 16) and parsed["S"].shape == (14, 16)
    got = eddsa.verify_with_challenges(C, parsed, ks, "cpu").tolist()
    assert got == jax_accept == WANT
    # y's bits 448-454 and S's bits from 448 up cleared: the lanes verify,
    # so truncating the values into 14 limbs would accept them
    high = 0x7F << 448

    def cut(enc):
        return _enc(int.from_bytes(enc, "little") & ~high)

    trunc_pubs = list(pubs)
    trunc_pubs[10] = cut(pubs[10])
    trunc_sigs = list(sigs)
    trunc_sigs[6] = sigs[6][:57] + cut(sigs[6][57:])
    trunc_sigs[13] = cut(sigs[13][:57]) + sigs[13][57:]
    acc = eddsa.verify_batch("ed448", [trunc_pubs[i] for i in (6, 10, 13)],
                             [msgs[i] for i in (6, 10, 13)],
                             [trunc_sigs[i] for i in (6, 10, 13)],
                             device="cpu")
    assert acc.tolist() == [True] * 3


def test_wycheproof_ed448_rows():
    """The 18 rows, one batch per context, give their recorded results;
    the verify passes its stage marks in order, with the K = 14 shapes."""
    rows = _wycheproof()
    assert len(rows) == 18 and sum(v["result"] == "valid" for v in rows) == 9
    groups = defaultdict(list)
    for v in rows:
        groups[bytes.fromhex(v.get("context", ""))].append(v)
    fails, marks = [], []
    for ctx, vs in groups.items():
        with stages.on_mark(lambda name, *vals: marks.append((name, vals))):
            acc = eddsa.verify_batch("ed448", [bytes.fromhex(v["pub"])
                                               for v in vs],
                                     [bytes.fromhex(v["msg"]) for v in vs],
                                     [bytes.fromhex(v["sig"]) for v in vs],
                                     context=ctx, device="cpu")
        fails += [(v["tcId"], v["comment"]) for v, a in zip(vs, acc)
                  if bool(a) != (v["result"] == "valid")]
    assert not fails
    names = ["parse", "challenge", "decode", "comb", "table", "windowed",
             "accept"]
    assert [m[0] for m in marks] == names * len(groups)
    last = dict(marks[-7:])
    table, digs = last["table"]
    n = table.shape[-1]
    assert table.shape == (16, 4, 14, n) and digs.shape == (112, n)
    assert last["decode"][0].x.shape == (14, 2 * n)


@pytest.mark.parametrize("row", _kats(), ids=lambda r: r["name"])
def test_kat_rows_host_signer(row):
    """The host signer reproduces each KAT signature byte for byte (the
    KATs' "pub" is the reference's Weierstrass export, so the key comes
    from "priv")."""
    pub, sig = H.ed448_sign(HC, bytes.fromhex(row["priv"]),
                            bytes.fromhex(row["msg_hex"]),
                            VARIANT[row["alg"]], _ctx(row))
    assert sig.hex() == row["sig"]
    assert pub == H.ed448_public(HC, bytes.fromhex(row["priv"]))


def _kat_groups():
    groups = defaultdict(list)
    for r in _kats():
        groups[(VARIANT[r["alg"]], _ctx(r))].append(r)
    return sorted(groups.items())


@pytest.mark.parametrize("group", _kat_groups(),
                         ids=lambda g: f"{g[0][0]}-ctx{g[0][1].hex()}")
def test_kat_rows_verify(group):
    """The KAT rows of one (variant, context), as one batch: each accepts,
    and rejects with a flipped bit of R or another message."""
    (variant, ctx), rows = group
    pubs, msgs, sigs = [], [], []
    for r in rows:
        msg, sig = bytes.fromhex(r["msg_hex"]), bytes.fromhex(r["sig"])
        pub = H.ed448_public(HC, bytes.fromhex(r["priv"]))
        pubs += [pub] * 3
        msgs += [msg, msg + b"x", msg]
        sigs += [sig, sig, bytes([sig[0] ^ 1]) + sig[1:]]
    acc = eddsa.verify_batch(variant, pubs, msgs, sigs, context=ctx,
                             device="cpu")
    assert acc.tolist() == [True, False, False] * len(rows)


def test_kat_count_and_variants():
    assert sorted((VARIANT[r["alg"]], _ctx(r)) for r in _kats()) == sorted(
        [("ed448", b"")] * 8 + [("ed448", b"foo"), ("ed448ph", b""),
                                ("ed448ph", b"foo")])
    assert H.ed448_dom("ed448ph", b"foo") == b"SigEd448\x01\x03foo"
    assert eddsa._dom(eddsa.get_variant("ed448"), b"") == b"SigEd448\x00\x00"
    assert eddsa._prehash(eddsa.get_variant("ed448ph"), b"abc") == (
        hashlib.shake_256(b"abc").digest(64))
    with pytest.raises(ValueError):
        H.ed448_dom("ed448ctx", b"")
    with pytest.raises(ValueError):
        H.ed448_sign(HC, bytes(32), b"")


def test_parse_rejects_wrong_lengths():
    """A lane whose key or signature is not 57 or 114 bytes is rejected
    and carries zeros; the other lanes parse as usual."""
    rng = np.random.RandomState(45)
    pub, sig = H.ed448_sign(HC, rng.bytes(57), b"m")
    parsed = eddsa.parse_verify_inputs(C, eddsa.get_variant("ed448"),
                                       [pub, pub[:56], pub, pub + b"\0"],
                                       [sig, sig, sig[:113], sig])
    assert parsed["pre_ok"].tolist() == [True, False, False, False]
    y = int.from_bytes(pub, "little")
    assert nn.batch_from_limbs(parsed["ay"])[0] == y % SIGN
    assert parsed["asign"].tolist()[0] == y >> 455
    assert nn.batch_from_limbs(parsed["S"])[0] == int.from_bytes(
        sig[57:], "little")
    assert not parsed["ay"][:, 1:].any() and not parsed["S"][:, 1:].any()
