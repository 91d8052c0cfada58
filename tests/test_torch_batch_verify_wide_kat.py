"""The port's batch verification on P-384 and Ed448 against the frozen
vectors and the host oracle, on the CPU: the ECFSDSA SECP384R1 (SHA-384)
row and the 11 EDDSA448 / EDDSA448PH rows of kats_full.jsonl as batches
(the host signers reproduce each row's signature first); the plain
separate-table Straus multiply (kernels 6 and 6-ed) at K = 12 (P-384, 96
windows) and K = 14 (Ed448, 112) against the host oracle's u*P + v*Q,
with the window edge scalars. Exact. test_torch_batch_verify_bp512.py
runs the same on BrainpoolP512r1."""

import json
import os

import numpy as np
import pytest
import torch

from libecc_tpu_torch.curves import edwards as ed, params, scalar_mul
from libecc_tpu_torch.curves.edwards import ExtPoint
from libecc_tpu_torch.curves.shortw import PrjPoint
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import batch_verify as bv, keys

from test_torch_batch_verify_wide import ed448, flip_s, host_w, rng_of
from test_torch_ecdsa_wide import _ints

VEC = os.path.join(os.path.dirname(__file__), "vectors", "kats_full.jsonl")
ED448_VARIANTS = {"EDDSA448": "ed448", "EDDSA448PH": "ed448ph"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def _rows(pred):
    with open(VEC) as f:
        return [r for r in map(json.loads, f) if pred(r)]


def check_ecfsdsa_kat_row(curve, hash_name):
    """The row (key X || Y || Z) reproduced by the host signer with its
    nonce, then verified as a batch of two: accepted, and rejected with a
    changed message in the second signature."""
    (r,) = _rows(lambda r: r.get("alg") == "ECFSDSA" and r["curve"] == curve)
    assert r["hash"] == hash_name
    c, wc = host_w(curve)
    p = c.fp_ctx.p_int
    d, k = int(r["priv"], 16), int(r["nonce"], 16)
    msg, sig = bytes.fromhex(r["msg_hex"]), bytes.fromhex(r["sig"])
    assert H.ecfsdsa_sign_ref(wc, d, k, msg, hash_name) == sig
    pub = bytes.fromhex(r["pub"])
    nb = len(pub) // 3
    X, Y, Z = [int.from_bytes(pub[nb * i:nb * (i + 1)], "big")
               for i in range(3)]
    zi = pow(Z, -1, p)
    assert H.ec_base_mul(wc, d) == (X * zi % p, Y * zi % p)
    kb = keys.pubkey_batch_from_affine_ints(c, "ECFSDSA", [X * zi % p] * 2,
                                            [Y * zi % p] * 2, device="cpu")
    assert bv.ecfsdsa_verify_batch(kb, [msg] * 2, [sig] * 2, hash_name,
                                   rng=rng_of(10), device="cpu") is True
    assert bv.ecfsdsa_verify_batch(kb, [msg, msg + b"x"], [sig] * 2,
                                   hash_name, rng=rng_of(11),
                                   device="cpu") is False


def test_ecfsdsa_kat_row_as_a_batch():
    check_ecfsdsa_kat_row("SECP384R1", "SHA384")


def _ed448_groups():
    """The 11 Ed448 rows, re-signed by the host signer from their seeds and
    grouped by (variant, context): {(variant, ctx): (pubs, msgs, sigs)}."""
    rows = _rows(lambda r: r.get("alg") in ED448_VARIANTS)
    assert len(rows) == 11
    _, hc = ed448()
    groups = {}
    for r in rows:
        var = ED448_VARIANTS[r["alg"]]
        ctx = bytes.fromhex(r["adata_hex"]) if r["adata_hex"] else b""
        msg = bytes.fromhex(r["msg_hex"])
        pub, sig = H.ed448_sign(hc, bytes.fromhex(r["priv"]), msg, var, ctx)
        assert sig == bytes.fromhex(r["sig"]), r["name"]
        g = groups.setdefault((var, ctx), ([], [], []))
        for lst, v in zip(g, (pub, msg, sig)):
            lst.append(v)
    return groups


def test_ed448_kat_rows_as_batches():
    """One batch per variant and context (ed448: 8 rows without a context
    and 1 with; ed448ph: 1 and 1): each accepts; the largest, with one
    flipped bit of S, rejects."""
    groups = _ed448_groups()
    assert sorted((v, c, len(g[0])) for (v, c), g in groups.items()) == [
        ("ed448", b"", 8), ("ed448", b"foo", 1), ("ed448ph", b"", 1),
        ("ed448ph", b"foo", 1)]
    for (var, ctx), (gp, gm, gs) in groups.items():
        assert bv.eddsa_verify_batch(var, gp, gm, gs, ctx, rng=rng_of(12),
                                     device="cpu") is True, (var, ctx)
    gp, gm, gs = groups[("ed448", b"")]
    bad = [flip_s("ed448", gs[0])] + gs[1:]
    assert bv.eddsa_verify_batch("ed448", gp, gm, bad, rng=rng_of(13),
                                 device="cpu") is False


def check_plain_straus(name):
    """straus_double_mul_public_w4 through kernel 6's (or 6-ed's) plain
    version: u takes the window edge scalars (the last add T + O, -T + T,
    T + T), v the same shifted by two lanes; the identity is P on lane 5
    and Q on lane 6; compared in affine form mod p."""
    rng = np.random.RandomState(198)
    if name == "ED448":
        c, hc = ed448()
        base = lambda k: H.ed_base_mul(hc, k)           # noqa: E731
        add, mul, ident = (lambda P, Q: H.ed_add(hc, P, Q),
                           lambda k, P: H.ed_mul(hc, k, P), (0, 1))
    else:
        c, wc = host_w(name)
        base = lambda k: H.ec_base_mul(wc, k)           # noqa: E731
        add, mul, ident = (lambda P, Q: H.ec_add(wc, P, Q),
                           lambda k, P: H.ec_mul(wc, k, P), None)
    q, p = c.q, c.fp_ctx.p_int
    us = H.window_edge_scalars(q) + [7, 1 << 100, q - 2]
    vs = [3, 1] + H.window_edge_scalars(q) + [5]
    n = len(us)
    ps = [base(1 + k % (q - 1)) for k in _ints(rng, n, q)]
    qs = [base(1 + k % (q - 1)) for k in _ints(rng, n, q)]
    ps[5], qs[6] = ident, ident
    lam = [1 + v % (p - 1) for v in _ints(rng, n, p)]

    def lift(pts):
        f = lambda col: c.fp_ctx.from_ints([v % p for v in col],  # noqa
                                           "cpu")
        if name == "ED448":
            return ExtPoint(*[f(col) for col in zip(*[
                (x * m, y * m, m, x * y * m) for (x, y), m in zip(pts, lam)])])
        return PrjPoint(*[f(col) for col in zip(*[
            (0, m, 0) if P is None else (P[0] * m, P[1] * m, m)
            for P, m in zip(pts, lam)])])
    ut = nn.upload(nn.batch_to_limbs(us, c.q_ctx.k), "cpu")
    vt = nn.upload(nn.batch_to_limbs(vs, c.q_ctx.k), "cpu")
    W = scalar_mul.straus_double_mul_public_w4(c, ut, lift(ps), vt, lift(qs))
    X, Y, Z = [c.fp_ctx.to_ints(t) for t in W[:3]]
    got = [ident if z == 0 else (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)
           for x, y, z in zip(X, Y, Z)]
    assert got == [add(mul(u, P), mul(v, Q))
                   for u, v, P, Q in zip(us, vs, ps, qs)]


@pytest.mark.parametrize("name", ["SECP384R1", "ED448"])
def test_plain_straus_against_the_oracle(name):
    check_plain_straus(name)
