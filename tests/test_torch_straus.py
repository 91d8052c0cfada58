"""The port's Straus dual multiply and its scan step, on the CPU: the plain
versions of kernel 5 (shortw.point_dbln_add), kernel 8c
(EdwardsCurve.pdbln_add) and kernels 6 and 6-ed (megamul.straus_mul_plain,
through straus_double_mul_public_w4), the joint-table
straus_double_mul_public and point_dbln_jac, against the JAX package
called eagerly with Pallas off, the TPU kernel's own window body and the
host oracle. Projective outputs are compared exactly as values
mod p: both packages run the same formulas on the same schedule.

The JAX package's Straus functions compile their scan step when called
(about 15-40 s each on the CPU, whatever nbits), so the default tier
compares them on one case (Ed25519, the joint table); the other curves
and the w = 4 function are the slow tier."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import edwards as jed, params as jparams
from libecc_tpu.curves import scalar_mul as jsm, shortw as jshortw
from libecc_tpu.nn import core as jnn
from libecc_tpu.ops.pallas import megamul as jmegamul, mont as jpmont

from libecc_tpu_torch import convert
from libecc_tpu_torch.curves import edwards as ed, params, scalar_mul
from libecc_tpu_torch.curves import shortw
from libecc_tpu_torch.curves.edwards import ExtPoint
from libecc_tpu_torch.curves.shortw import PrjPoint
from libecc_tpu_torch.fp.field import FpCtx
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ops.cuda import edpoint, megamul, point
from libecc_tpu_torch.ref import hostref as H


@pytest.fixture(autouse=True)
def _scan_path(monkeypatch):
    """The JAX package on its XLA path (no Pallas, no megakernel); one
    intra-op thread for the port's tiny tensors (several test workers
    share the machine's cores), in inference mode (no autograd
    bookkeeping: about a fifth off each plain tensor operation here)."""
    monkeypatch.setenv("LIBECC_TPU_PALLAS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def _wcurves(name):
    c = params.get_curve(name)
    return c, jparams.get_curve(name), H.WCurve(c.fp_ctx.p_int, c.a, c.b,
                                                c.gx, c.gy, c.q)


def _vals(ctx, pt):
    return [ctx.to_ints(v) for v in pt]


def _w_affine(p, vals):
    X, Y, Z = vals[:3]
    return [None if z == 0 else (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)
            for x, y, z in zip(X, Y, Z)]


def _jax_prj(jc, pts, rng):
    """Host affine points (None: the identity) -> JAX PrjPoint, random Z."""
    p = jc.fp_ctx.p_int
    cols = [[], [], []]
    for P in pts:
        lam = 1 + int.from_bytes(rng.bytes(40), "big") % (p - 1)
        v = (0, lam, 0) if P is None else (P[0] * lam, P[1] * lam, lam)
        for col, x in zip(cols, v):
            col.append(x % p)
    return jshortw.PrjPoint(*[jc.fp_ctx.from_ints(col) for col in cols])


def _jax_ext(jc, pts, rng):
    p = jc.fp_ctx.p_int
    cols = [[], [], [], []]
    for x, y in pts:
        lam = 1 + int.from_bytes(rng.bytes(40), "big") % (p - 1)
        for col, v in zip(cols, (x * lam, y * lam, lam, x * y * lam)):
            col.append(v % p)
    return jed.ExtPoint(*[jc.fp_ctx.from_ints(col) for col in cols])


def _w_lanes(wc, rng, n=7):
    """(P, Q) lanes: random, identity in either or both, P = Q, P = -Q."""
    def rnd():
        return H.ec_base_mul(wc, 1 + int.from_bytes(rng.bytes(32), "big")
                             % (wc.q - 1))
    A = [rnd() for _ in range(n)]
    B = [rnd() for _ in range(n)]
    A[1] = None
    B[2] = None
    A[3] = B[3] = None
    B[4] = A[4]
    B[5] = H.ec_neg(wc, A[5])
    return A, B


@pytest.mark.parametrize("ndbl", [1, 2, 4])
@pytest.mark.parametrize("name", ["P-256", "SECP256K1"])
def test_point_dbln_add_matches_jax(name, ndbl):
    """Kernel 5's plain version (a = -3 and a = 0) against
    shortw.point_dbln_add, and point_dbln_jac against the JAX block."""
    c, jc, wc = _wcurves(name)
    rng = np.random.RandomState(91 + ndbl)
    A, B = _w_lanes(wc, rng)
    Aj, Bj = _jax_prj(jc, A, rng), _jax_prj(jc, B, rng)
    At = convert.point_from_jax(c, *[np.asarray(v) for v in Aj], "cpu")
    Bt = convert.point_from_jax(c, *[np.asarray(v) for v in Bj], "cpu")
    want = _vals(jc.fp_ctx, jshortw.point_dbln_add(jc, Aj, Bj, ndbl))
    got = _vals(c.fp_ctx, c.pdbln_add(At, Bt, ndbl))
    assert got == want
    assert _vals(c.fp_ctx, point.point_dbln_add_plain(c, At, Bt, ndbl)) == got
    oracle = [H.ec_add(wc, H.ec_mul(wc, 1 << ndbl, a), b)
              for a, b in zip(A, B)]
    assert _w_affine(c.fp_ctx.p_int, got) == oracle
    if ndbl == 4:
        assert _vals(c.fp_ctx, shortw.point_dbln_jac(c, At, ndbl)) == _vals(
            jc.fp_ctx, jshortw.point_dbln_jac(jc, Aj, ndbl))


@pytest.mark.parametrize("ndbl", [1, 2, 4])
def test_ed_pdbln_add_matches_jax(ndbl):
    """Kernel 8c's plain version against EdwardsCurve.pdbln_add (ndbl = 0
    too: the add with P's T)."""
    c = ed.get_edwards_curve("ED25519")
    jc = jed.get_edwards_curve("ED25519")
    p = c.fp_ctx.p_int
    hc = H.EdCurve(p, c.a, c.d, c.gx, c.gy, c.q, c.h)
    rng = np.random.RandomState(95 + ndbl)

    def rnd():
        return H.ed_base_mul(hc, int.from_bytes(rng.bytes(32), "big") % c.q)
    A = [rnd() for _ in range(6)]
    B = [rnd() for _ in range(6)]
    A[1] = (0, 1)
    B[2] = (0, 1)
    B[3] = A[3]
    B[4] = ((-A[4][0]) % p, A[4][1])
    Aj, Bj = _jax_ext(jc, A, rng), _jax_ext(jc, B, rng)
    At = convert.ext_point_from_jax(c, *[np.asarray(v) for v in Aj], "cpu")
    Bt = convert.ext_point_from_jax(c, *[np.asarray(v) for v in Bj], "cpu")
    for n in (0, ndbl):
        want = _vals(jc.fp_ctx, jc.pdbln_add(Aj, Bj, n))
        got = _vals(c.fp_ctx, c.pdbln_add(At, Bt, n))
        assert got == want
        assert _vals(c.fp_ctx, edpoint.ed_dbln_add_plain(c, At, Bt, n)) == got
    oracle = [H.ed_add(hc, H.ed_mul(hc, 1 << ndbl, a), b)
              for a, b in zip(A, B)]
    assert _w_affine(p, got) == oracle


def _scalars(rng, nbits, n):
    """(u, v) lanes: both zero, one zero, one and short, then random
    nbits-bit scalars."""
    rand = [int.from_bytes(rng.bytes(8), "big") % (1 << nbits)
            for _ in range(2 * n)]
    return [0, 0, 1, 5] + rand[:n - 4], [0, 3, 0, 1] + rand[n:2 * n - 4]


def _straus_case(name, fn, nbits):
    """Port and JAX Straus on the same lanes; returns their values and the
    host oracle's affine points."""
    rng = np.random.RandomState(101)
    n = 6
    if name == "ED25519":
        c, jc = ed.get_edwards_curve(name), jed.get_edwards_curve(name)
        p = c.fp_ctx.p_int
        hc = H.EdCurve(p, c.a, c.d, c.gx, c.gy, c.q, c.h)
        A = [H.ed_base_mul(hc, 7 + i) for i in range(n)]
        B = [H.ed_base_mul(hc, 1000 + 3 * i) for i in range(n)]
        Pj, Qj = _jax_ext(jc, A, rng), _jax_ext(jc, B, rng)
        cv = convert.ext_point_from_jax
        mul, add = (lambda k, X: H.ed_mul(hc, k, X),
                    lambda X, Y: H.ed_add(hc, X, Y))
    else:
        c, jc, wc = _wcurves(name)
        p = c.fp_ctx.p_int
        A = [H.ec_base_mul(wc, 7 + i) for i in range(n)]
        B = [H.ec_base_mul(wc, 1000 + 3 * i) for i in range(n)]
        Pj, Qj = _jax_prj(jc, A, rng), _jax_prj(jc, B, rng)
        cv = convert.point_from_jax
        mul, add = (lambda k, X: H.ec_mul(wc, k, X),
                    lambda X, Y: H.ec_add(wc, X, Y))
    us, vs = _scalars(rng, nbits, n)
    P = cv(c, *[np.asarray(t) for t in Pj], "cpu")
    Q = cv(c, *[np.asarray(t) for t in Qj], "cpu")
    ut = nn.upload(nn.batch_to_limbs(us, c.q_ctx.k), "cpu")
    vt = nn.upload(nn.batch_to_limbs(vs, c.q_ctx.k), "cpu")
    uj = jnp.asarray(jnn.batch_to_limbs(us, jc.q_ctx.k))
    vj = jnp.asarray(jnn.batch_to_limbs(vs, jc.q_ctx.k))
    got = _vals(c.fp_ctx, getattr(scalar_mul, fn)(c, ut, P, vt, Q,
                                                  nbits=nbits))
    want = _vals(jc.fp_ctx, getattr(jsm, fn)(jc, uj, Pj, vj, Qj,
                                             nbits=nbits))
    oracle = [add(mul(u, a), mul(v, b)) for u, a, v, b in zip(us, A, vs, B)]
    return got, want, _w_affine(p, got), oracle


def test_joint_straus_matches_jax():
    """straus_double_mul_public (joint 2-bit table, 8 steps of kernel 8c's
    plain version) against the JAX package on Ed25519, 16-bit scalars."""
    got, want, affine, oracle = _straus_case("ED25519",
                                             "straus_double_mul_public", 16)
    assert got == want
    assert affine == oracle


@pytest.mark.slow
@pytest.mark.parametrize("fn", ["straus_double_mul_public_w4",
                                "straus_double_mul_public"])
@pytest.mark.parametrize("name", ["P-256", "SECP256K1", "ED25519"])
def test_straus_matches_jax(name, fn):
    """Both Straus functions on the three curves (kernels 6 and 6-ed
    through straus_double_mul_public_w4), 24-bit scalars."""
    got, want, affine, oracle = _straus_case(name, fn, 24)
    assert got == want
    assert affine == oracle


@pytest.mark.parametrize("name", ["P-256", "ED25519"])
def test_straus_w4_matches_its_scan(name):
    """Kernel 6's plain version (through straus_double_mul_public_w4) equals
    the reference's scan formulation step by step: per window pdbln_add of
    P's entry (kernel 5 / 8c plain), then padd of Q's entry, from the same
    tables; and the host oracle. 32-bit scalars (8 windows)."""
    rng = np.random.RandomState(103)
    n = 5
    if name == "ED25519":
        c = ed.get_edwards_curve(name)
        hc = H.EdCurve(c.fp_ctx.p_int, c.a, c.d, c.gx, c.gy, c.q, c.h)
        A = [H.ed_base_mul(hc, 11 + i) for i in range(n)]
        B = [H.ed_base_mul(hc, 77 + i) for i in range(n)]
        mk = lambda pts: c.point_from_affine_ints(  # noqa: E731
            [a[0] for a in pts], [a[1] for a in pts], "cpu")
        mul, add = (lambda k, X: H.ed_mul(hc, k, X),
                    lambda X, Y: H.ed_add(hc, X, Y))
    else:
        c, _, wc = _wcurves(name)
        A = [H.ec_base_mul(wc, 11 + i) for i in range(n)]
        B = [H.ec_base_mul(wc, 77 + i) for i in range(n)]
        mk = lambda pts: c.point_from_affine_ints(  # noqa: E731
            [a[0] for a in pts], [a[1] for a in pts], "cpu")
        mul, add = (lambda k, X: H.ec_mul(wc, k, X),
                    lambda X, Y: H.ec_add(wc, X, Y))
    nbits = 32
    us = [0, 1, (1 << nbits) - 1] + [int.from_bytes(rng.bytes(4), "big")
                                     for _ in range(n - 3)]
    vs = [(1 << nbits) - 2, 0, 3] + [int.from_bytes(rng.bytes(4), "big")
                                     for _ in range(n - 3)]
    P, Q = mk(A), mk(B)
    ut = nn.upload(nn.batch_to_limbs(us, c.q_ctx.k), "cpu")
    vt = nn.upload(nn.batch_to_limbs(vs, c.q_ctx.k), "cpu")
    got = scalar_mul.straus_double_mul_public_w4(c, ut, P, vt, Q,
                                                 nbits=nbits)
    cls = type(P)
    ptab = scalar_mul._build_mul_table(c, P)
    qtab = scalar_mul._build_mul_table(c, Q)
    du = scalar_mul._window_digits(ut, nbits)
    dv = scalar_mul._window_digits(vt, nbits)
    acc = c.pinf(like=P)
    for wi in range(du.shape[0]):
        acc = c.pdbln_add(acc, megamul.gather_entry(ptab, du[wi], cls), 4)
        acc = c.padd(acc, megamul.gather_entry(qtab, dv[wi], cls))
    assert _vals(c.fp_ctx, got) == _vals(c.fp_ctx, acc)
    oracle = [add(mul(u, a), mul(v, b)) for u, a, v, b in zip(us, A, vs, B)]
    assert _w_affine(c.fp_ctx.p_int, _vals(c.fp_ctx, got)) == oracle


# -- kernel 6 against the TPU kernel's own window body ---------------------
# Tiny curves over p = 8191, as tests/test_pallas_megamul.py registers them
# in the JAX package (its fake-ref harness takes K = 3 tile-backend curves
# and one block of 1024 lanes). The port's copies take K = 2 limbs (its
# plain Montgomery product needs at least two).
P_TINY = 8191
jparams.register_curve("TESTW13", P_TINY, P_TINY - 3, 3, 1, 1, 8221)
jed.register_edwards("TESTED13", P_TINY, 1, 14, 846, 3020, 2027, 4)
TINY_W = shortw.ShortWCurve("TESTW13", FpCtx(P_TINY, 2), P_TINY - 3, 3, 1, 1,
                            8221, q_ctx=FpCtx(8221, 2))
TINY_ED = ed.EdwardsCurve("TESTED13", FpCtx(P_TINY, 2), 1, 14, 846, 3020,
                          2027, 4, q_ctx=FpCtx(2027, 2))


class _FakeRef:
    """VMEM-ref stand-in: integer indexing over axis 0, mutable."""

    def __init__(self, arr):
        self._l = [arr[i] for i in range(arr.shape[0])]

    def __getitem__(self, i):
        return self._l[i]

    def __setitem__(self, i, v):
        self._l[i] = v

    def stacked(self):
        return jnp.stack(self._l)


def _run_kern_fake(name, w, model, tables, digs, monkeypatch):
    """The TPU megakernel's body (megamul._build_kern, npairs = 2) run
    eagerly through fake refs, one block of 1024 lanes."""
    nwin = digs[0].shape[0]
    k = tables[0].shape[2]
    kern, ncoord, tw, rows = jmegamul._build_kern(name, k, w, nwin, model,
                                                  len(tables))
    assert not rows
    n = digs[0].shape[-1]
    nrow = n // jpmont.LANES
    dig_refs = [_FakeRef(d.reshape(nwin, nrow, jpmont.LANES)) for d in digs]
    tab_refs = [_FakeRef(t[:, c].reshape(tw * k, nrow, jpmont.LANES))
                for t in tables for c in range(ncoord)]
    out_refs = [_FakeRef(jnp.zeros((k, nrow, jpmont.LANES), jnp.uint32))
                for _ in range(ncoord)]
    monkeypatch.setattr(
        jmegamul, "_LOOP",
        lambda lo, hi, body, init: ([body(i, init) for i in range(hi)],
                                    init)[1])
    kern(*dig_refs, *tab_refs, *out_refs)
    return [o.stacked().reshape(k, n) for o in out_refs]


@pytest.mark.parametrize("model", ["w", "ed"])
def test_straus_kernel_matches_tpu_kernel_body(model, monkeypatch):
    """Kernels 6 and 6-ed's plain version against the TPU kernel's window
    body (npairs = 2, w = 4) on the same tables and digits (the port's,
    handed to the JAX body in its limbs): 2 windows, 1024 lanes."""
    jmegamul._build_kern.cache_clear()
    rnd = random.Random(107)
    n = jpmont.BLOCK
    if model == "w":
        jc, c, cls = jparams.get_curve("TESTW13"), TINY_W, PrjPoint
        hc = H.WCurve(P_TINY, c.a, c.b, c.gx, c.gy, c.q)
        base = [H.ec_mul(hc, 1 + i, (c.gx, c.gy)) for i in range(16)]
    else:
        jc, c, cls = jed.get_edwards_curve("TESTED13"), TINY_ED, ExtPoint
        hc = H.EdCurve(P_TINY, c.a, c.d, c.gx, c.gy, c.q, c.h)
        base = [H.ed_mul(hc, 1 + i, (c.gx, c.gy)) for i in range(16)]
    pts = [base[i % 16] for i in range(n)]
    qts = [base[(5 * i + 3) % 16] for i in range(n)]
    P = c.point_from_affine_ints([a[0] for a in pts], [a[1] for a in pts],
                                 "cpu")
    Q = c.point_from_affine_ints([a[0] for a in qts], [a[1] for a in qts],
                                 "cpu")
    nbits, w = 8, 4
    us = [rnd.randrange(1 << nbits) for _ in range(n)]
    vs = [rnd.randrange(1 << nbits) for _ in range(n)]
    us[0] = vs[1] = 0
    ptab = scalar_mul._build_mul_table(c, P)
    qtab = scalar_mul._build_mul_table(c, Q)
    du = scalar_mul._window_digits(
        nn.upload(nn.batch_to_limbs(us, c.q_ctx.k), "cpu"), nbits)
    dv = scalar_mul._window_digits(
        nn.upload(nn.batch_to_limbs(vs, c.q_ctx.k), "cpu"), nbits)
    kj = jc.fp_ctx.k

    def jax_table(t):
        return jnp.asarray(np.stack([np.stack([
            convert.fe_to_jax(t[e, i], c.fp_ctx, kj)
            for i in range(t.shape[1])]) for e in range(t.shape[0])]))

    want = _run_kern_fake(jc.name, w, model, (jax_table(ptab),
                                              jax_table(qtab)),
                          (jnp.asarray(du.numpy()), jnp.asarray(dv.numpy())),
                          monkeypatch)
    got = megamul.straus_mul_plain(c, ptab, du, qtab, dv, cls)
    for g, wnt in zip(got, want):
        assert torch.equal(g, convert.fe_from_jax(np.asarray(wnt), c.fp_ctx,
                                                  "cpu"))
    # the same value from the host oracle, on a few lanes
    affine = _w_affine(P_TINY, _vals(c.fp_ctx, got))
    for i in range(8):
        if model == "w":
            want_i = H.ec_add(hc, H.ec_mul(hc, us[i], pts[i]),
                              H.ec_mul(hc, vs[i], qts[i]))
        else:
            want_i = H.ed_add(hc, H.ed_mul(hc, us[i], pts[i]),
                              H.ed_mul(hc, vs[i], qts[i]))
        assert affine[i] == want_i
