"""The port's batch signature verification (ECFSDSA on P-256, BIP0340 on
secp256k1, Ed25519), on the CPU: the host signers against the KAT rows, the
three entry points on valid and corrupted batches and on every early-return
class, the arguments they hand to _combined_check against the JAX
package's for the same rng, the check's two sides against the host oracle,
and the lane-tree reduce. Exact: limbs, projective values mod p and bools.

Every valid or corrupted batch runs the whole check (the plain versions of
kernels 6 and 2, or 6-ed and 8a), about 3 s each here. The JAX package's
whole entry points jit the combined check (minutes on the CPU): the test
that compares them is the slow tier."""

import hashlib
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import edwards as jed, params as jparams
from libecc_tpu.curves import shortw as jshortw
from libecc_tpu.sig import batch_verify as jbv, keys as jkeys

from libecc_tpu_torch import convert
from libecc_tpu_torch.curves import edwards as ed, params
from libecc_tpu_torch.curves import shortw
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.sig import batch_verify as bv, keys
from libecc_tpu_torch.ref import hostref as H

VEC = os.path.join(os.path.dirname(__file__), "vectors", "sig_kats.jsonl")

# the oracle's fixed inputs of tests/vectors/sig_kats.jsonl
# (tests/test_sig_parity.py:31-43)
FIXED_K = bytes.fromhex(
    "0a5c1e77239b4d125f60718893a4b5c6d7e8f9011223344556677889"
    "9aabbccddeeff00f1e2d3c4b5a69788796a5b4c3d2e1f01021324354"
    "65768798a9bacbdc1122")
PRIV = bytes.fromhex(
    "009c32453399e126d84215672caf9e84409667834d16290e73615a13"
    "9b072d449275ee88c79f704138533abe129061cd129d9144f677b2a8"
    "2e961c550912ab113344")

SCHEMES = {"ECFSDSA": "SECP256R1", "BIP0340": "SECP256K1"}
N = 4


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """The JAX package on its XLA path; one intra-op thread for the port's
    tiny tensors (several test workers share the machine's cores), in
    inference mode (no autograd bookkeeping)."""
    monkeypatch.setenv("LIBECC_TPU_PALLAS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def _rng(seed):
    r = random.Random(seed)
    return lambda n: bytes(r.randrange(256) for _ in range(n))


def _host(curve_name):
    c = params.get_curve(curve_name)
    return c, H.WCurve(c.fp_ctx.p_int, c.a, c.b, c.gx, c.gy, c.q)


def _ed():
    c = ed.get_edwards_curve("ED25519")
    return c, H.EdCurve(c.fp_ctx.p_int, c.a, c.d, c.gx, c.gy, c.q, c.h)


@pytest.mark.parametrize("alg", sorted(SCHEMES))
def test_host_signer_reproduces_kat(alg):
    """hostref's signer gives the reference library's signature byte for
    byte (row key = PRIV cut to q's length; ECFSDSA nonce = FIXED_K mod q,
    BIP0340 aux = FIXED_K mod 2^256), and its key the row's X/Z, Y/Z."""
    with open(VEC) as f:
        kat = [r for r in map(json.loads, f) if (r["alg"], r["curve"],
               r["hash"]) == (alg, SCHEMES[alg], "SHA256")][0]
    c, wc = _host(SCHEMES[alg])
    q, p = c.q, c.fp_ctx.p_int
    d = int.from_bytes(PRIV[:(q.bit_length() + 7) // 8], "big") % q
    msg = kat["msg"].encode()
    if alg == "ECFSDSA":
        sig = H.ecfsdsa_sign_ref(wc, d, int.from_bytes(FIXED_K, "big") % q,
                                 msg)
    else:
        aux = (int.from_bytes(FIXED_K, "big") % (1 << 256)).to_bytes(32,
                                                                     "big")
        sig = H.bip0340_sign_ref(wc, d, msg, aux)
    assert sig.hex() == kat["sig"]
    pub = bytes.fromhex(kat["pub"])
    X, Y, Z = [int.from_bytes(pub[32 * i:32 * (i + 1)], "big")
               for i in range(3)]
    zi = pow(Z, -1, p)
    assert H.ec_base_mul(wc, d) == (X * zi % p, Y * zi % p)
    assert H.ec_base_mul(wc, d) == H.ec_mul(wc, d, (c.gx, c.gy))


def _fixture(alg):
    """(keys or public-key bytes, messages, signatures, host oracle
    inputs) for N signatures from the host signers."""
    msgs = [bytes([i]) * 20 for i in range(N)]
    if alg == "EDDSA":
        c, hc = _ed()
        seeds = [bytes([i + 1]) * 32 for i in range(N)]
        pairs = [H.ed25519_sign(hc, s, m) for s, m in zip(seeds, msgs)]
        return [a for a, _ in pairs], msgs, [s for _, s in pairs]
    c, wc = _host(SCHEMES[alg])
    ds = [i + 2 for i in range(N)]
    pubs = [H.ec_base_mul(wc, d) for d in ds]
    if alg == "ECFSDSA":
        sigs = [H.ecfsdsa_sign_ref(wc, d, 5 * i + 11, m)
                for i, (d, m) in enumerate(zip(ds, msgs))]
    else:
        sigs = [H.bip0340_sign_ref(wc, d, m, bytes([i]) * 32)
                for i, (d, m) in enumerate(zip(ds, msgs))]
    kb = keys.pubkey_batch_from_affine_ints(c, alg, [P[0] for P in pubs],
                                            [P[1] for P in pubs],
                                            device="cpu")
    return kb, msgs, sigs


def _verify(alg, first, msgs, sigs, seed, **kw):
    if alg == "EDDSA":
        return bv.eddsa_verify_batch("ed25519", first, msgs, sigs,
                                     rng=_rng(seed), device="cpu", **kw)
    fn = (bv.ecfsdsa_verify_batch if alg == "ECFSDSA"
          else bv.bip0340_verify_batch)
    return fn(first, msgs, sigs, "SHA256", rng=_rng(seed), device="cpu",
              **kw)


def _host_sides(alg, first, msgs, sigs, seed):
    """The host oracle's c*G and sum_i (z_i R_i + z_i e_i Y_i), affine, for
    the z_i the seeded rng gives."""
    zs = bv._rand_zs(N, _rng(seed))
    if alg == "EDDSA":
        c, hc = _ed()
        p, q = c.fp_ctx.p_int, c.q

        def dec(b):
            y = int.from_bytes(b, "little") & ((1 << 255) - 1)
            x2 = (y * y - 1) * pow(c.d * y * y + 1, -1, p) % p
            x = pow(x2, (p + 3) // 8, p)
            if x * x % p != x2:
                x = x * pow(2, (p - 1) // 4, p) % p
            if x & 1 != b[31] >> 7:
                x = p - x
            return (x, y)
        acc, cc = (0, 1), 0
        for z, a, m, s in zip(zs, first, msgs, sigs):
            k = int.from_bytes(hashlib.sha512(s[:32] + a + m).digest(),
                               "little") % q
            term = H.ed_add(hc, H.ed_mul(hc, z, dec(s[:32])),
                            H.ed_mul(hc, z * k % q, dec(a)))
            acc = H.ed_add(hc, acc, term)
            cc = (cc + z * int.from_bytes(s[32:], "little")) % q
        return H.ed_mul(hc, cc, (c.gx, c.gy)), acc
    c, wc = _host(SCHEMES[alg])
    p, q = c.fp_ctx.p_int, c.q
    xs, ys, _ = first.pub_affine_ints()
    acc, cc = None, 0
    for z, x, y, m, sg in zip(zs, xs, ys, msgs, sigs):
        if alg == "ECFSDSA":
            R = (int.from_bytes(sg[:32], "big"), int.from_bytes(sg[32:64],
                                                                 "big"))
            e = int.from_bytes(hashlib.sha256(sg[:64] + m).digest(),
                               "big") % q
            Y = (x, y)
        else:
            rx = int.from_bytes(sg[:32], "big")
            ry = pow(rx ** 3 + 7, (p + 1) // 4, p)
            R = (rx, ry if ry % 2 == 0 else p - ry)
            e = int.from_bytes(H.bip0340_tagged_hash(
                "SHA256", b"BIP0340/challenge", sg[:32], x.to_bytes(32, "big"),
                m), "big") % q
            Y = (x, y if y % 2 == 0 else p - y)
        term = H.ec_add(wc, H.ec_mul(wc, z, R), H.ec_mul(wc, z * e % q, Y))
        acc = H.ec_add(wc, acc, term)
        cc = (cc + z * int.from_bytes(sg[-32:], "big")) % q
    return H.ec_mul(wc, cc, (c.gx, c.gy)), acc


def _affine(c, P):
    p = c.fp_ctx.p_int
    x, y, z = [c.fp_ctx.to_ints(v)[0] for v in P[:3]]
    if z == 0:
        return None
    return (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)


@pytest.mark.parametrize("case", ["valid", "sig_bit", "message"])
@pytest.mark.parametrize("alg", ["ECFSDSA", "BIP0340", "EDDSA"])
def test_batch_accept_reject(alg, case, monkeypatch):
    """A valid batch accepts (and the check's two sides equal the host
    oracle's c*G and sum of z_i R_i + z_i e_i Y_i); one flipped signature
    bit, or one changed message, rejects the whole batch."""
    first, msgs, sigs = _fixture(alg)
    sides = []
    real = bv._combined_sides

    def spy(*a):
        out = real(*a)
        sides.append(out)
        return out
    monkeypatch.setattr(bv, "_combined_sides", spy)
    if case == "valid":
        assert _verify(alg, first, msgs, sigs, 1) is True
        c = _ed()[0] if alg == "EDDSA" else first.curve
        lhs, rhs = sides[0]
        want_lhs, want_rhs = _host_sides(alg, first, msgs, sigs, 1)
        if alg == "EDDSA":
            assert [_affine(c, P)[:2] for P in (lhs, rhs)] == [want_lhs,
                                                                 want_rhs]
        else:
            assert [_affine(c, P) for P in (lhs, rhs)] == [want_lhs,
                                                           want_rhs]
    elif case == "sig_bit":
        bad = list(sigs)                 # the lowest bit of s (of S: byte 32)
        i = 32 if alg == "EDDSA" else len(bad[2]) - 1
        bad[2] = bad[2][:i] + bytes([bad[2][i] ^ 1]) + bad[2][i + 1:]
        assert _verify(alg, first, msgs, bad, 2) is False
    else:
        bad = list(msgs)
        bad[0] = b"evil"
        assert _verify(alg, first, bad, sigs, 3) is False
    assert len(sides) == 1


def _early_cases(alg):
    """name -> (keys or public-key bytes, signatures) of each early-return
    class, and the messages."""
    first, msgs, sigs = _fixture(alg)

    def one(i, sig):
        return first, sigs[:i] + [sig] + sigs[i + 1:]
    if alg == "ECFSDSA":
        c = first.curve
        q, p = c.q, c.fp_ctx.p_int
        return {
            "length": one(0, sigs[0][:-1]),
            "s_zero": one(0, sigs[0][:64] + bytes(32)),
            "s_eq_q": one(0, sigs[0][:64] + q.to_bytes(32, "big")),
            "x_ge_p": one(1, p.to_bytes(32, "big") + sigs[1][32:]),
            "y_ge_p": one(1, sigs[1][:32] + p.to_bytes(32, "big")
                          + sigs[1][64:]),
        }, msgs
    if alg == "BIP0340":
        c = first.curve
        q, p = c.q, c.fp_ctx.p_int
        nr = next(x for x in range(1, 100)
                  if pow(x ** 3 + 7, (p - 1) // 2, p) != 1)
        return {
            "length": one(3, sigs[3] + b"\x00"),
            "r_ge_p": one(0, p.to_bytes(32, "big") + sigs[0][32:]),
            "s_eq_q": one(0, sigs[0][:32] + q.to_bytes(32, "big")),
            "s_zero": one(0, sigs[0][:32] + bytes(32)),
            "r_no_y": one(1, nr.to_bytes(32, "big") + sigs[1][32:]),
        }, msgs
    c, _ = _ed()
    p, q = c.fp_ctx.p_int, c.q
    no_x = next(y for y in range(2, 100) if pow(
        (y * y - 1) * pow(c.d * y * y + 1, -1, p) % p, (p - 1) // 2, p) != 1)
    s0 = int.from_bytes(sigs[0][32:], "little")
    return {
        "length": one(1, sigs[1][:63]),
        "key_length": ([first[0][:31]] + first[1:], sigs),
        "s_eq_q": one(0, sigs[0][:32] + q.to_bytes(32, "little")),
        "s_plus_q": one(0, sigs[0][:32] + (s0 + q).to_bytes(32, "little")),
        "a_no_x": ([no_x.to_bytes(32, "little")] + first[1:], sigs),
        "r_y_ge_p": one(2, (p + 1).to_bytes(32, "little") + sigs[2][32:]),
    }, msgs


EARLY = [("ECFSDSA", k) for k in ("length", "s_zero", "s_eq_q", "x_ge_p",
                                  "y_ge_p")] \
    + [("BIP0340", k) for k in ("length", "r_ge_p", "s_eq_q", "s_zero",
                                "r_no_y")] \
    + [("EDDSA", k) for k in ("length", "key_length", "s_eq_q", "s_plus_q",
                              "a_no_x", "r_y_ge_p")]


@pytest.mark.parametrize("alg,case", EARLY)
def test_early_returns(alg, case, monkeypatch):
    """Each early-return class rejects before the combined check."""
    cases, msgs = _early_cases(alg)
    first, sigs = cases[case]

    def never(*a):
        raise AssertionError("the combined check ran")
    monkeypatch.setattr(bv, "_combined_check", never)
    assert _verify(alg, first, msgs, sigs, 4) is False


@pytest.mark.slow
@pytest.mark.parametrize("alg,case", EARLY)
def test_early_returns_match_jax(alg, case, monkeypatch):
    """The JAX package rejects each early-return class before its combined
    check too (its eager lift and decode take seconds each here)."""
    cases, msgs = _early_cases(alg)
    first, sigs = cases[case]

    def never(*a):
        raise AssertionError("the combined check ran")
    monkeypatch.setattr(jbv, "_combined_check", never)
    if alg == "EDDSA":
        want = jbv.eddsa_verify_batch("ed25519", first, msgs, sigs,
                                      rng=_rng(4))
    else:
        fn = (jbv.ecfsdsa_verify_batch if alg == "ECFSDSA"
              else jbv.bip0340_verify_batch)
        want = fn(_jax_keys(first), msgs, sigs, "SHA256", rng=_rng(4))
    assert want is False


def _jax_keys(kb):
    jc = jparams.get_curve(kb.curve.name)
    xs, ys, _ = kb.pub_affine_ints()
    return jkeys.pubkey_batch_from_affine_ints(jc, kb.alg, xs, ys)


def _ints15(arr):
    return convert.ints_from_limbs15(np.asarray(arr))


@pytest.mark.parametrize("alg", ["ECFSDSA", "BIP0340", "EDDSA"])
def test_combined_check_inputs_match_jax(alg, monkeypatch):
    """For the same seeded rng, the port hands its _combined_check the
    same z_i, z_i e_i, c, R and Y as the JAX package hands its own."""
    first, msgs, sigs = _fixture(alg)
    got, want = [], []

    def port_spy(curve, zs, e2, Y, R, c_int):
        got.append((curve, zs, e2, Y, R, c_int))
        return torch.ones(1, dtype=torch.bool)

    def jax_spy(curve, zs, e2, Y, R, c_int):
        want.append((curve, zs, e2, Y, R, c_int))
        return jnp.ones(1, bool)
    monkeypatch.setattr(bv, "_combined_check", port_spy)
    monkeypatch.setattr(jbv, "_combined_check", jax_spy)
    assert _verify(alg, first, msgs, sigs, 5) is True
    if alg == "EDDSA":
        assert jbv.eddsa_verify_batch("ed25519", first, msgs, sigs,
                                      rng=_rng(5))
    else:
        fn = (jbv.ecfsdsa_verify_batch if alg == "ECFSDSA"
              else jbv.bip0340_verify_batch)
        assert fn(_jax_keys(first), msgs, sigs, "SHA256", rng=_rng(5))
    (c, zs, e2, Y, R, cc), (jc, jzs, je2, jY, jR, jcc) = got[0], want[0]
    assert nn.batch_from_limbs(zs) == _ints15(jzs)
    assert nn.batch_from_limbs(e2) == _ints15(je2)
    assert cc == jcc
    for P, Pj in ((Y, jY), (R, jR)):
        assert [c.fp_ctx.to_ints(t) for t in P] == [
            jc.fp_ctx.to_ints(t) for t in Pj]


def _tree_case(name, n):
    """n points of one curve: (port curve, JAX curve, affine points, host
    sum)."""
    rng = np.random.RandomState(111)
    ks = [1 + int.from_bytes(rng.bytes(32), "big") % 1000 for _ in range(n)]
    if name == "ED25519":
        c, hc = _ed()
        jc = jed.get_edwards_curve(name)
        pts = [H.ed_base_mul(hc, k) for k in ks]
        total = (0, 1)
        for a in pts:
            total = H.ed_add(hc, total, a)
    else:
        c, wc = _host(name)
        jc = jparams.get_curve(name)
        pts = [H.ec_base_mul(wc, k) for k in ks]
        total = None
        for a in pts:
            total = H.ec_add(wc, total, a)
    return c, jc, pts, total


TREE = [("P-256", 5), ("ED25519", 8)]


@pytest.mark.parametrize("name,n", TREE)
def test_point_tree_reduce(name, n):
    """The lane-tree sum at an odd width (one identity pad per odd round)
    and at a power of two: the host sum, and round by round the pairwise
    adds of the reference's schedule."""
    c, _, pts, total = _tree_case(name, n)
    P = c.point_from_affine_ints([a[0] for a in pts], [a[1] for a in pts],
                                 "cpu")
    got = bv.point_tree_reduce(c, P)
    assert tuple(got.x.shape) == (c.fp_ctx.k, 1)
    assert _affine(c, got)[:2] == total
    cls, arr = type(P), list(P)
    while arr[0].shape[-1] > 1:
        if arr[0].shape[-1] % 2:
            pad = c.pinf(batch_shape=(1,), device="cpu")
            arr = [torch.cat([a, b], -1) for a, b in zip(arr, pad)]
        arr = list(c.padd(cls(*[a[:, 0::2].contiguous() for a in arr]),
                          cls(*[a[:, 1::2].contiguous() for a in arr])))
    assert [c.fp_ctx.to_ints(t) for t in got] == [c.fp_ctx.to_ints(t)
                                                 for t in arr]


@pytest.mark.slow
@pytest.mark.parametrize("name,n", TREE)
def test_point_tree_reduce_matches_jax(name, n):
    """Against the JAX package's point_tree_reduce (its eager adds compile
    once per width: about half a minute here)."""
    c, jc, pts, _ = _tree_case(name, n)
    Pj = jc.point_from_affine_ints([a[0] for a in pts], [a[1] for a in pts])
    cv = (convert.ext_point_from_jax if name == "ED25519"
          else convert.point_from_jax)
    got = bv.point_tree_reduce(c, cv(c, *[np.asarray(t) for t in Pj], "cpu"))
    want = jbv.point_tree_reduce(jc, Pj)
    assert [c.fp_ctx.to_ints(t) for t in got] == [jc.fp_ctx.to_ints(t)
                                                 for t in want]


def test_y_from_x_matches_jax():
    """lift_x on secp256k1: on-curve x values and x values with no y."""
    c, wc = _host("SECP256K1")
    jc = jparams.get_curve("SECP256K1")
    p = c.fp_ctx.p_int
    xs = [H.ec_base_mul(wc, k)[0] for k in (1, 2, 3, 99)]
    xs += [x for x in range(1, 40) if pow(x ** 3 + 7, (p - 1) // 2, p) != 1][:3]
    y, ok = shortw.y_from_x(c, c.fp_ctx.from_ints(xs, "cpu"))
    yj, okj = jshortw.y_from_x(jc, jc.fp_ctx.from_ints(xs))
    assert ok.tolist() == np.asarray(okj).tolist() == [True] * 4 + [False] * 3
    assert c.fp_ctx.to_ints(y)[:4] == jc.fp_ctx.to_ints(yj)[:4]
    assert all(v * v % p == (x ** 3 + 7) % p
               for v, x in zip(c.fp_ctx.to_ints(y)[:4], xs))


def test_hash_and_scheme_refusals():
    kb, msgs, sigs = _fixture("ECFSDSA")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        bv.ecfsdsa_verify_batch(kb, msgs, sigs, "SM3", device="cpu")
    # a hash outside SHA-2 and SHA-3 is still refused (Ed448 no longer is:
    # its malformed batch just rejects)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        bv.bip0340_verify_batch(kb, msgs, sigs, "STREEBOG512", device="cpu")
    assert bv.eddsa_verify_batch("ed448", [b""], [b""], [b""],
                                 device="cpu") is False
    with pytest.raises(NotImplementedError):
        bv.unsupported_verify_batch()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bv.ecfsdsa_verify_batch(kb, msgs, sigs)
    assert bv.Z_BITS == 128
    zs = bv._rand_zs(3, _rng(9))
    assert all(z % 2 == 1 and z < 1 << 128 for z in zs)


IMPORT_ALL = r"""
import pkgutil, sys
import libecc_tpu_torch
for m in pkgutil.walk_packages(libecc_tpu_torch.__path__, "libecc_tpu_torch."):
    __import__(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "libecc_tpu.")))
assert not bad, bad
assert "libecc_tpu_torch.sig.batch_verify" in sys.modules
print("clean")
"""


def test_port_modules_import_no_jax():
    """Every module of the port, batch_verify and bip0340 included, imports
    in a fresh interpreter without loading jax or the JAX package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("clean")


@pytest.mark.slow
@pytest.mark.parametrize("alg", ["ECFSDSA", "BIP0340", "EDDSA"])
def test_batch_verify_matches_jitted_jax(alg):
    """The JAX package's whole entry points (jitted combined check, minutes
    on the CPU) give the port's accept and reject."""
    first, msgs, sigs = _fixture(alg)
    bad = list(sigs)
    bad[1] = bad[1][:-1] + bytes([bad[1][-1] ^ 1])
    for s_, seed in ((sigs, 6), (bad, 7)):
        if alg == "EDDSA":
            want = jbv.eddsa_verify_batch("ed25519", first, msgs, s_,
                                          rng=_rng(seed))
        else:
            fn = (jbv.ecfsdsa_verify_batch if alg == "ECFSDSA"
                  else jbv.bip0340_verify_batch)
            want = fn(_jax_keys(first), msgs, s_, "SHA256", rng=_rng(seed))
        assert _verify(alg, first, msgs, s_, seed) is want
    assert want is False
