"""Card-only tests of the port's CUDA kernels: each kernel bitwise against
its plain version on the same CUDA tensors, the launch counters, and the
wrappers' refusals. They skip where there is no CUDA device. This file
imports neither JAX nor the JAX package, so it runs on a machine without
them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from libecc_tpu_torch.curves import edwards, params, scalar_mul
from libecc_tpu_torch.curves.edwards import EdwardsCurve, ExtPoint
from libecc_tpu_torch.curves.shortw import PrjPoint
from libecc_tpu_torch.fp.field import FpCtx
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ops.cuda import edpoint, megamul, mont, point
from libecc_tpu_torch.ops.cuda.build import kernel_name
from libecc_tpu_torch.ref import hostref as H

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ints(rng, n, mod):
    """n random residues mod `mod` from 64 bits more than it has."""
    nbytes = (mod.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "big") % mod for _ in range(n)]


def _prj(c, rng, pts, dev):
    """Affine points (None: the identity) -> PrjPoint with random Z."""
    p = c.fp_ctx.p_int
    lam = [1 + v % (p - 1) for v in _ints(rng, len(pts), p)]
    f = c.fp_ctx.from_ints
    return PrjPoint(
        f([0 if q is None else q[0] * m % p for q, m in zip(pts, lam)], dev),
        f([m if q is None else q[1] * m % p for q, m in zip(pts, lam)], dev),
        f([0 if q is None else m for q, m in zip(pts, lam)], dev))


def _host(c):
    return H.WCurve(c.fp_ctx.p_int, c.a, c.b, c.gx, c.gy, c.q, c.h)


def _points(c, rng, n, dev):
    """n projective points (16 distinct ones repeated), lane 0 the
    identity."""
    wc = _host(c)
    base = [H.ec_mul(wc, 1 + k % (c.q - 1), (c.gx, c.gy))
            for k in _ints(rng, 16, c.q)]
    pts = [base[i % 16] for i in range(n)]
    pts[0] = None
    return _prj(c, rng, pts, dev)


def _point_pairs(c, rng, n, dev):
    """Projective point pairs with the edge lanes P + O, O + Q, O + O,
    P = Q and P = -Q, then random ones (random Z on every lane)."""
    wc = _host(c)
    base = [H.ec_base_mul(wc, 1 + k % (c.q - 1)) for k in _ints(rng, 16, c.q)]
    a_pts = [base[i % 16] for i in range(n)]
    b_pts = [base[(7 * i + 3) % 16] for i in range(n)]
    b_pts[0] = a_pts[1] = a_pts[2] = b_pts[2] = None
    b_pts[3] = a_pts[3]
    b_pts[4] = H.ec_neg(wc, a_pts[4])
    return _prj(c, rng, a_pts, dev), _prj(c, rng, b_pts, dev)


# Kernels 1-4 at K = 8 (every a), K = 12 (P-384, a = -3), K = 16 (the
# 512-bit curves, generic a) and K = 17 (P-521, a = -3), and the later
# instances: K = 6 and 7 for every a, K = 10 for a = -3 and generic a,
# K = 12 for generic a, K = 16 for a = -3 and K = 14 for generic a
# (WEI448). K and the scalar bits come
# from the curve (secp224k1: K = 7 coordinates, a 225-bit q at K = 8).
# One curve for each (K, a) instance:
NEW_W_CURVES = ["P-192", "BRAINPOOLP192R1", "SECP192K1", "P-224",
                "BRAINPOOLP224R1", "SECP224K1", "BRAINPOOLP320T1",
                "BRAINPOOLP320R1", "BRAINPOOLP384R1", "BRAINPOOLP512T1",
                "WEI448"]


@pytest.mark.parametrize("which", ["p", "q"])
@pytest.mark.parametrize("name", ["P-256", "P-384", "BRAINPOOLP512R1",
                                  "GOST512", "P-521", "P-192", "P-224",
                                  "SECP224K1", "BRAINPOOLP320R1"])
def test_mont_kernels_match_plain(dev, name, which):
    c = params.get_curve(name)
    ctx = c.fp_ctx if which == "p" else c.q_ctx
    k = ctx.k
    rng = np.random.RandomState(71)
    m = ctx.p_int
    n = 4099                                   # ragged edge
    a = nn.upload(nn.batch_to_limbs([0, 1, m - 1, m - 1]
                                    + _ints(rng, n - 4, m), k), dev)
    b = nn.upload(nn.batch_to_limbs([m - 1] * 3 + [m - 2]
                                    + _ints(rng, n - 4, m), k), dev)
    names = [kernel_name("mont_mul", k), kernel_name("mont_sqr", k)]
    before = dict(mont.launches)
    assert torch.equal(mont.mont_mul(a, b, ctx), nn.mont_mul(a, b, ctx))
    assert torch.equal(mont.mont_sqr(a, ctx), nn.mont_sqr(a, ctx))
    for name_k in names:
        assert mont.launches[name_k] == before[name_k] + 1


@pytest.mark.parametrize("name", ["P-256", "SECP256K1", "BRAINPOOLP256R1",
                                  "P-384", "BRAINPOOLP512R1", "GOST512",
                                  "P-521", *NEW_W_CURVES])
def test_point_kernels_match_plain(dev, name):
    c = params.get_curve(name)
    rng = np.random.RandomState(72)
    A, B = _point_pairs(c, rng, 777, dev)
    before = dict(point.launches)
    got = point.point_add(c, A, B)
    want = point.point_add_plain(c, A, B)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = point.point_dbl(c, A)
    want = point.point_dbl_plain(c, A)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for base in ("point_add", "point_dbl"):
        name_k = point.instance_name(base, c)
        assert point.launches[name_k] == before[name_k] + 1
    assert sum(point.launches.values()) == sum(before.values()) + 2


@pytest.mark.parametrize("name", ["P-256", "SECP256K1", "P-384",
                                  "BRAINPOOLP512R1", "GOST512", "P-521",
                                  *NEW_W_CURVES])
def test_windowed_kernel_matches_plain(dev, name):
    """Kernel 4 (48 to 131 windows): the identity point (lanes 1 and
    2), scalars whose last add is T + O, -T + T and T + T
    (hostref.window_edge_scalars), short ones and random ones; the first
    lanes also against the host oracle."""
    c = params.get_curve(name)
    rng = np.random.RandomState(73)
    n = 300
    P, _ = _point_pairs(c, rng, n, dev)
    ms = H.window_edge_scalars(c.q) + [2, 1 << 100]
    ms += _ints(rng, n - len(ms), c.q)
    mt = nn.upload(nn.batch_to_limbs(ms, c.q_ctx.k), dev)
    table = scalar_mul._build_mul_table(c, P)
    digs = scalar_mul._window_digits(mt, c.scalar_bits())
    assert digs.shape[0] == -(-c.scalar_bits() // 4)
    name_k = megamul.kernel_name_of(c, 1)
    before = megamul.launches[name_k]
    got = megamul.windowed_mul(c, table, digs, PrjPoint)
    want = megamul.windowed_mul_plain(c, table, digs, PrjPoint)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert megamul.launches[name_k] == before + 1
    p = c.fp_ctx.p_int
    X, Y, Z = [c.fp_ctx.to_ints(v[:, :8]) for v in got]
    PX, PY, PZ = [c.fp_ctx.to_ints(v[:, :8]) for v in P]
    for i in range(8):
        base = None if PZ[i] == 0 else (PX[i] * pow(PZ[i], -1, p) % p,
                                        PY[i] * pow(PZ[i], -1, p) % p)
        got_i = None if Z[i] == 0 else (X[i] * pow(Z[i], -1, p) % p,
                                        Y[i] * pow(Z[i], -1, p) % p)
        assert got_i == H.ec_mul(_host(c), ms[i], base), i


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ctx = FpCtx((1 << 283) - 1)                        # K = 9: not built
    a = ctx.from_ints([1, 2], dev)
    with pytest.raises(ValueError):
        mont.mont_mul(a, a, ctx)
    c = params.get_curve("P-256")
    a = c.fp_ctx.from_ints([1, 2, 3], dev)
    with pytest.raises(ValueError):
        mont.mont_mul(a, a[:, :2].contiguous(), c.fp_ctx)
    with pytest.raises(ValueError):
        mont.mont_mul(a.to(torch.int64), a.to(torch.int64), c.fp_ctx)
    with pytest.raises(ValueError):
        mont.mont_mul(a[:, ::2], a[:, ::2], c.fp_ctx)
    table = torch.zeros((8, 3, 8, 3), dtype=torch.int32, device=dev)
    digs = torch.zeros((64, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                    # w = 3
        megamul.windowed_mul(c, table, digs, PrjPoint)



def _ed_affine(c, rng, n):
    """n host Ed25519 points (16 distinct ones repeated), lane 0 the
    identity (0, 1)."""
    hc = H.EdCurve(c.fp_ctx.p_int, c.a, c.d, c.gx, c.gy, c.q, c.h)
    base = [H.ed_base_mul(hc, k) for k in _ints(rng, 16, c.q)]
    pts = [base[i % 16] for i in range(n)]
    pts[0] = (0, 1)
    return pts


def _ed_extended(c, rng, pts, dev):
    """Host affine points -> ExtPoint (lam x : lam y : lam : lam x y) with
    random lam."""
    p = c.fp_ctx.p_int
    lam = [1 + v % (p - 1) for v in _ints(rng, len(pts), p)]
    coords = zip(*[(x * m, y * m, m, x * y * m)
                   for (x, y), m in zip(pts, lam)])
    return ExtPoint(*[c.fp_ctx.from_ints([v % p for v in col], dev)
                      for col in coords])


def _ed_pairs(c, rng, n, dev):
    """Edge lanes P + O, O + Q, O + O, P = Q, P = -Q, then random ones."""
    p = c.fp_ctx.p_int
    hc = H.EdCurve(p, c.a, c.d, c.gx, c.gy, c.q, c.h)
    base = [H.ed_base_mul(hc, k) for k in _ints(rng, 16, c.q)]
    a_pts = [base[i % 16] for i in range(n)]
    b_pts = [base[(7 * i + 3) % 16] for i in range(n)]
    b_pts[0] = a_pts[1] = a_pts[2] = b_pts[2] = (0, 1)
    b_pts[3] = a_pts[3]
    b_pts[4] = ((-a_pts[4][0]) % p, a_pts[4][1])
    return (_ed_extended(c, rng, a_pts, dev),
            _ed_extended(c, rng, b_pts, dev))


def test_ed_kernels_match_plain(dev):
    c = edwards.get_edwards_curve("ED25519")
    p = c.fp_ctx.p_int
    rng = np.random.RandomState(74)
    a_pts, b_pts = _ed_affine(c, rng, 777), _ed_affine(c, rng, 777)
    b_pts[1] = a_pts[1]                                 # P = Q
    b_pts[2] = ((-a_pts[2][0]) % p, a_pts[2][1])        # P = -Q
    b_pts[3] = (0, 1)                                   # P + O
    A, B = _ed_extended(c, rng, a_pts, dev), _ed_extended(c, rng, b_pts, dev)
    before = dict(edpoint.launches)
    got = edpoint.ed_add(c, A, B)
    assert all(torch.equal(g, w) for g, w in zip(
        got, edpoint.ed_add_plain(c, A, B)))
    got = edpoint.ed_dbl(c, A)
    assert all(torch.equal(g, w) for g, w in zip(
        got, edpoint.ed_dbl_plain(c, A)))
    assert edpoint.launches["ed_add"] == before["ed_add"] + 1
    assert edpoint.launches["ed_dbl"] == before["ed_dbl"] + 1

def test_ed_windowed_kernel_matches_plain(dev):
    c = edwards.get_edwards_curve("ED25519")
    rng = np.random.RandomState(75)
    n = 300
    P = _ed_extended(c, rng, _ed_affine(c, rng, n), dev)
    ms = [0, 1, 2, 1 << 100] + _ints(rng, n - 4, c.q)
    mt = nn.upload(nn.batch_to_limbs(ms, 8), dev)
    table = scalar_mul._build_mul_table(c, P)
    digs = scalar_mul._window_digits(mt, c.scalar_bits())
    before = megamul.launches["windowed_mul_ed"]
    got = megamul.windowed_mul(c, table, digs, ExtPoint)
    want = megamul.windowed_mul_plain(c, table, digs, ExtPoint)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert megamul.launches["windowed_mul_ed"] == before + 1


def test_ed_wrappers_refuse_what_the_kernels_do_not_take(dev):
    c = edwards.get_edwards_curve("ED25519")
    one = c.fp_ctx.from_ints([1, 2, 3], dev)
    P = ExtPoint(one, one, one, one)
    a1 = EdwardsCurve("A1", c.fp_ctx, 1, c.d, 0, 1, c.q, c.h)       # a = 1
    with pytest.raises(ValueError):
        edpoint.ed_add(a1, P, P)
    with pytest.raises(ValueError):
        edpoint.ed_dbl(a1, P)
    k12 = EdwardsCurve("K12", FpCtx(params.get_curve("P-384").fp_ctx.p_int),
                       -1, 2, 0, 1, c.q, 1)                          # K = 12
    P12 = ExtPoint(*[k12.fp_ctx.from_ints([1, 2], dev)] * 4)
    with pytest.raises(ValueError):
        edpoint.ed_add(k12, P12, P12)
    with pytest.raises(ValueError):
        edpoint.ed_dbl(k12, P12)
    short = ExtPoint(*[t[:, :2].contiguous() for t in P])
    with pytest.raises(ValueError):                    # P, Q differ in N
        edpoint.ed_add(c, P, short)
    with pytest.raises(ValueError):                    # not contiguous
        edpoint.ed_add(c, ExtPoint(*[t[:, ::2] for t in P]),
                       ExtPoint(*[t[:, ::2] for t in P]))
    digs = torch.zeros((64, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                    # three coordinates
        megamul.windowed_mul(c, torch.zeros((16, 3, 8, 3), dtype=torch.int32,
                                            device=dev), digs, ExtPoint)
    with pytest.raises(ValueError):                    # a = 1
        megamul.windowed_mul(a1, torch.zeros((16, 4, 8, 3), dtype=torch.int32,
                                             device=dev), digs, ExtPoint)


# kernel 5's instances: K = 8 (a = -3 and a = 0), K = 12 (a = -3), K = 16
# (generic a and a = -3), K = 17 (a = -3), K = 14 (generic a); each with
# kernel 8c at the K = 8 and 14 Edwards instances
@pytest.mark.parametrize("name,ed_name", [
    ("P-256", "ED25519"), ("SECP256K1", "ED25519"), ("P-384", "ED25519"),
    ("BRAINPOOLP512R1", "ED25519"), ("BRAINPOOLP512T1", "ED448"),
    ("P-521", "ED448"), ("WEI448", "ED448")])
def test_dbln_add_kernel_matches_plain(dev, name, ed_name):
    """Kernel 5 (2^n*P + Q) for n = 0, 1, 2, 4 and kernel 8c, identity
    lanes included (and, for kernel 8c, P = Q and P = -Q)."""
    c = params.get_curve(name)
    rng = np.random.RandomState(76)
    A, B = _points(c, rng, 777, dev), _points(c, rng, 777, dev)
    name_k = point.instance_name("point_dbln_add", c)
    before = dict(point.launches)
    for n in (0, 1, 2, 4):
        got = c.pdbln_add(A, B, n)
        want = point.point_dbln_add_plain(c, A, B, n)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert point.launches[name_k] == before[name_k] + 4
    assert sum(point.launches.values()) == sum(before.values()) + 4
    e = edwards.get_edwards_curve(ed_name)
    EA, EB = _ed_pairs(e, rng, 777, dev)
    ed_k = kernel_name("ed_dbln_add", e.fp_ctx.k)
    before = edpoint.launches[ed_k]
    for n in (0, 2, 4):
        got = e.pdbln_add(EA, EB, n)
        want = edpoint.ed_dbln_add_plain(e, EA, EB, n)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert edpoint.launches[ed_k] == before + 3
    with pytest.raises(ValueError):
        point.point_dbln_add(c, A, B, -1)


@pytest.mark.parametrize("name", ["P-256", "SECP256K1", "ED25519", "P-384",
                                  "BRAINPOOLP512R1", "GOST512", "ED448",
                                  *NEW_W_CURVES, "P-521"])
def test_straus_kernels_match_plain(dev, name):
    """Kernel 6 at K = 8 (as built for a = -3 and for a = 0), K = 12 (a =
    -3) and K = 16 (generic a, on both 512-bit curves), at each later
    (K, a) instance (K = 6, 7, 10, 12 generic a, 16 a = -3, 17) and kernel
    6-ed at K = 8 (a = -1) and K = 14 (a = 1) against their plain versions
    through
    straus_double_mul_public_w4: the identity among the points, zero and
    short scalars, the window edge scalars (the last add T + O, -T + T,
    T + T) for u and, shifted by two lanes, for v; those lanes also against
    the host oracle's u*P + v*Q. Where kernel 5 (8c) is built, the same
    points from the joint-table Straus."""
    rng = np.random.RandomState(77)
    n = 300
    if name.startswith("ED"):
        c, cls = edwards.get_edwards_curve(name), ExtPoint
        P, Q = _ed_pairs(c, rng, n, dev)
        hc = H.EdCurve(c.fp_ctx.p_int, c.a, c.d, c.gx, c.gy, c.q, c.h)
    else:
        c, cls = params.get_curve(name), PrjPoint
        P, Q = _point_pairs(c, rng, n, dev)
        wc = _host(c)
    edges = H.window_edge_scalars(c.q)
    us = [0, 1, 0, 1 << 100] + edges + [0, 1 << 100]
    vs = [0, 0, 5, 3, 0, 5] + edges
    nfix = len(vs)
    us += _ints(rng, n - len(us), c.q)
    vs += _ints(rng, n - len(vs), c.q)
    kq = c.q_ctx.k
    ut = nn.upload(nn.batch_to_limbs(us, kq), dev)
    vt = nn.upload(nn.batch_to_limbs(vs, kq), dev)
    nbits = c.scalar_bits()
    ptab = scalar_mul._build_mul_table(c, P)
    qtab = scalar_mul._build_mul_table(c, Q)
    du = scalar_mul._window_digits(ut, nbits)
    dv = scalar_mul._window_digits(vt, nbits)
    name_k = megamul.kernel_name_of(c, 2, "ed" if cls is ExtPoint else "w")
    before = dict(megamul.launches)
    got = scalar_mul.straus_double_mul_public_w4(c, ut, P, vt, Q)
    assert megamul.launches[name_k] == before[name_k] + 1
    assert sum(megamul.launches.values()) == sum(before.values()) + 1
    want = megamul.straus_mul_plain(c, ptab, du, qtab, dv, cls)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    p = c.fp_ctx.p_int

    def affine(T, i):
        x, y, z = [c.fp_ctx.to_ints(v[:, i:i + 1])[0] for v in T[:3]]
        return None if z == 0 else (x * pow(z, -1, p) % p,
                                    y * pow(z, -1, p) % p)
    for i in range(nfix):
        if cls is ExtPoint:
            want_i = H.ed_add(hc, H.ed_mul(hc, us[i], affine(P, i)),
                              H.ed_mul(hc, vs[i], affine(Q, i)))
        else:
            want_i = H.ec_add(wc, H.ec_mul(wc, us[i], affine(P, i)),
                              H.ec_mul(wc, vs[i], affine(Q, i)))
        assert affine(got, i) == want_i, i
    if (point.instance_name("point_dbln_add", c) if cls is PrjPoint
            else c.fp_ctx.k in edpoint.BUILT["ed_dbln_add"]):
        # where kernel 5 (8c) is built: the joint-table Straus's points
        joint = scalar_mul.straus_double_mul_public(c, ut, P, vt, Q)
        ctx = c.fp_ctx
        for a, b in ((0, 2), (1, 2)):           # x/z and y/z agree
            assert torch.equal(nn.mont_mul(got[a], joint[b], ctx),
                               nn.mont_mul(joint[a], got[b], ctx))
    with pytest.raises(ValueError):             # digits differ in nwin
        megamul.straus_mul(c, ptab, du, qtab, dv[:-1].contiguous(), cls)


# -- Ed448: kernels 1, 8a, 8b and 7 at K = 14 (a = 1) ----------------------

@pytest.mark.parametrize("which", ["p", "q"])
def test_mont_kernels_k14_match_plain(dev, which):
    c = edwards.get_edwards_curve("ED448")
    ctx = c.fp_ctx if which == "p" else c.q_ctx
    assert ctx.k == 14
    rng = np.random.RandomState(78)
    m = ctx.p_int
    n = 4099                                   # ragged edge
    a = nn.upload(nn.batch_to_limbs([0, 1, m - 1, m - 1]
                                    + _ints(rng, n - 4, m), 14), dev)
    b = nn.upload(nn.batch_to_limbs([m - 1] * 3 + [m - 2]
                                    + _ints(rng, n - 4, m), 14), dev)
    before = dict(mont.launches)
    assert torch.equal(mont.mont_mul(a, b, ctx), nn.mont_mul(a, b, ctx))
    assert torch.equal(mont.mont_sqr(a, ctx), nn.mont_sqr(a, ctx))
    assert mont.launches["mont_mul_k14"] == before["mont_mul_k14"] + 1
    assert mont.launches["mont_sqr_k14"] == before["mont_sqr_k14"] + 1
    assert mont.launches["mont_mul"] == before["mont_mul"]


def test_ed_kernels_k14_match_plain(dev):
    c = edwards.get_edwards_curve("ED448")
    rng = np.random.RandomState(79)
    A, B = _ed_pairs(c, rng, 777, dev)
    before = dict(edpoint.launches)
    got = edpoint.ed_add(c, A, B)
    assert all(torch.equal(g, w) for g, w in zip(
        got, edpoint.ed_add_plain(c, A, B)))
    got = edpoint.ed_dbl(c, A)
    assert all(torch.equal(g, w) for g, w in zip(
        got, edpoint.ed_dbl_plain(c, A)))
    assert edpoint.launches["ed_add_k14"] == before["ed_add_k14"] + 1
    assert edpoint.launches["ed_dbl_k14"] == before["ed_dbl_k14"] + 1
    assert edpoint.launches["ed_add"] == before["ed_add"]


def test_ed_windowed_kernel_k14_matches_plain(dev):
    """Kernel 7 at K = 14: 112 windows, zero, short and full scalars, the
    identity among the points."""
    c = edwards.get_edwards_curve("ED448")
    rng = np.random.RandomState(80)
    n = 300
    P, _ = _ed_pairs(c, rng, n, dev)
    ms = [0, 1, 2, 1 << 100, 0, c.q - 1] + _ints(rng, n - 6, c.q)
    mt = nn.upload(nn.batch_to_limbs(ms, 14), dev)
    table = scalar_mul._build_mul_table(c, P)
    digs = scalar_mul._window_digits(mt, c.scalar_bits())
    assert digs.shape[0] == 112
    before = megamul.launches["windowed_mul_ed_k14"]
    got = megamul.windowed_mul(c, table, digs, ExtPoint)
    want = megamul.windowed_mul_plain(c, table, digs, ExtPoint)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert megamul.launches["windowed_mul_ed_k14"] == before + 1


def test_ed_wrappers_refuse_other_k_and_a(dev):
    """(K = 14, a = -1) and (K = 8, a = 1) raise on the card: kernels 8a,
    8b, 8c, 7 and 6-ed are built for (K = 8, a = -1) and (K = 14, a = 1)
    only."""
    e448 = edwards.get_edwards_curve("ED448")
    e25519 = edwards.get_edwards_curve("ED25519")
    m448 = EdwardsCurve("M1_448", e448.fp_ctx, -1, e448.d, 0, 1, e448.q, 4)
    a1_8 = EdwardsCurve("A1", e25519.fp_ctx, 1, e25519.d, 0, 1, e25519.q, 8)
    for cv in (m448, a1_8):
        one = cv.fp_ctx.from_ints([1, 2, 3], dev)
        P = ExtPoint(one, one, one, one)
        with pytest.raises(ValueError):
            edpoint.ed_add(cv, P, P)
        with pytest.raises(ValueError):
            edpoint.ed_dbl(cv, P)
        digs = torch.zeros((112, 3), dtype=torch.int32, device=dev)
        tab = torch.zeros((16, 4, cv.fp_ctx.k, 3), dtype=torch.int32,
                          device=dev)
        with pytest.raises(ValueError):
            megamul.windowed_mul(cv, tab, digs, ExtPoint)
    for cv in (m448, a1_8):                            # 8c
        one = cv.fp_ctx.from_ints([1, 2, 3], dev)
        P = ExtPoint(one, one, one, one)
        with pytest.raises(ValueError, match="built for"):
            edpoint.ed_dbln_add(cv, P, P, 2)
    tab = torch.zeros((16, 4, 14, 3), dtype=torch.int32, device=dev)
    digs = torch.zeros((112, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="built for"):  # 6-ed: a = 1 at 14
        megamul.straus_mul(m448, tab, digs, tab, digs, ExtPoint)


# -- the wide instances refuse another a -------------------------------------

def test_wide_wrappers_refuse_other_a(dev):
    """An unbuilt (K, a) raises on the card: a = -3 at K = 14 (short
    Weierstrass is built at K = 14 for generic a only: WEI448) and a = 0
    at K = 10 (built for a = -3 and generic a); kernel 5 is built at K = 8
    and at the (K, a) of P-384, the 512-bit curves, P-521 and WEI448, so
    not at K = 10 or K = 12 with generic a. The first-built wide C entry
    points refuse the other a, now built under entry points of their own,
    themselves (cudaErrorInvalidValue)."""
    import ctypes
    from libecc_tpu_torch.curves.shortw import ShortWCurve
    w448 = params.get_curve("WEI448")
    m3_448 = ShortWCurve("M3_448", w448.fp_ctx, -3, w448.b, 0, 1, w448.q)
    r320 = params.get_curve("BRAINPOOLP320R1")
    a0_320 = ShortWCurve("A0_320", r320.fp_ctx, 0, r320.b, 0, 1, r320.q)
    assert point.a_kind(m3_448) == point.A_M3
    for cv in (m3_448, a0_320):
        k = cv.fp_ctx.k
        one = cv.fp_ctx.from_ints([1, 2, 3], dev)
        P = PrjPoint(one, one, one)
        with pytest.raises(ValueError, match="built for"):
            point.point_add(cv, P, P)
        with pytest.raises(ValueError, match="built for"):
            point.point_dbl(cv, P)
        tab = torch.zeros((16, 3, k, 3), dtype=torch.int32, device=dev)
        digs = torch.zeros((-(-cv.scalar_bits() // 4), 3), dtype=torch.int32,
                           device=dev)
        with pytest.raises(ValueError, match="built for"):
            megamul.windowed_mul(cv, tab, digs, PrjPoint)
        with pytest.raises(ValueError, match="built for"):
            megamul.straus_mul(cv, tab, digs, tab, digs, PrjPoint)
    for cv in (params.get_curve("BRAINPOOLP512T1"),    # K = 16, a = -3
               params.get_curve("BRAINPOOLP384R1")):   # K = 12, generic a
        k = cv.fp_ctx.k
        one = cv.fp_ctx.from_ints([1, 2, 3], dev)
        P = PrjPoint(one, one, one)
        outs = [torch.empty_like(one) for _ in range(3)]
        rc = getattr(point._lib("point_wide"), f"point_add_k{k}")(
            ctypes.byref(point.curve_struct(cv)),
            point.ptr_array([*P, *P]), point.ptr_array(outs), 3,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert rc != 0
    for cv in (a0_320, params.get_curve("BRAINPOOLP320R1"),
               params.get_curve("BRAINPOOLP384R1")):   # 5: not built
        one = cv.fp_ctx.from_ints([1, 2, 3], dev)
        P = PrjPoint(one, one, one)
        with pytest.raises(ValueError, match="built for"):
            point.point_dbln_add(cv, P, P, 2)


def _wrong_a(struct, kind):
    """A copy of a kernels' context struct with another a_kind."""
    s = type(struct).from_buffer_copy(struct)
    s.a_kind = kind
    return s


@pytest.mark.parametrize("cname,stem,curve,model,wrong", [
    ("point_add_k17", "point_p521", "P-521", "add", point.A_GENERIC),
    ("point_dbl_k17", "point_p521", "P-521", "dbl", point.A_ZERO),
    ("windowed_mul_k17_w4", "windowed_p521", "P-521", "w1",
     point.A_GENERIC),
    ("straus_mul_k12_w4", "straus_wide", "P-384", "w2", point.A_GENERIC),
    ("straus_mul_k16_w4", "straus_wide", "BRAINPOOLP512R1", "w2",
     point.A_M3),
    ("straus_mul_ed_k14_w4", "straus_ed448", "ED448", "ed2",
     edpoint.A_M1),
    ("point_add_k6_m3", "point_small", "P-192", "add", point.A_GENERIC),
    ("point_dbl_k7_a0", "point_small", "SECP224K1", "dbl", point.A_M3),
    ("point_add_k10_ga", "point_small", "BRAINPOOLP320R1", "add",
     point.A_ZERO),
    ("point_dbl_k12_ga", "point_wide_alt", "BRAINPOOLP384R1", "dbl",
     point.A_M3),
    ("point_add_k16_m3", "point_wide_alt", "BRAINPOOLP512T1", "add",
     point.A_GENERIC),
    ("windowed_mul_k6_a0_w4", "windowed_small", "SECP192K1", "w1",
     point.A_M3),
    ("windowed_mul_k10_m3_w4", "windowed_small", "BRAINPOOLP320T1", "w1",
     point.A_GENERIC),
    ("windowed_mul_k16_m3_w4", "windowed_wide_alt", "BRAINPOOLP512T1", "w1",
     point.A_GENERIC),
    ("straus_mul_k7_ga_w4", "straus_small", "BRAINPOOLP224R1", "w2",
     point.A_ZERO),
    ("straus_mul_k6_m3_w4", "straus_small", "P-192", "w2", point.A_ZERO),
    ("windowed_mul_k7_ga_w4", "windowed_small", "BRAINPOOLP224R1", "w1",
     point.A_M3),
    ("straus_mul_k10_ga_w4", "straus_small", "BRAINPOOLP320R1", "w2",
     point.A_M3),
    ("straus_mul_k12_ga_w4", "straus_wide_alt", "BRAINPOOLP384R1", "w2",
     point.A_M3),
    ("straus_mul_k17_w4", "straus_p521", "P-521", "w2", point.A_GENERIC),
    ("point_add_k14_ga", "point_wei448", "WEI448", "add", point.A_M3),
    ("point_dbl_k14_ga", "point_wei448", "WEI448", "dbl", point.A_ZERO),
    ("point_dbln_add_k14_ga", "point_wei448", "WEI448", "dbln", point.A_M3),
    ("point_dbln_add_k12", "point_wide", "P-384", "dbln", point.A_GENERIC),
    ("point_dbln_add_k16", "point_wide", "BRAINPOOLP512R1", "dbln",
     point.A_M3),
    ("point_dbln_add_k16_m3", "point_wide_alt", "BRAINPOOLP512T1", "dbln",
     point.A_GENERIC),
    ("point_dbln_add_k17", "point_p521", "P-521", "dbln", point.A_ZERO),
    ("windowed_mul_k14_ga_w4", "windowed_wei448", "WEI448", "w1",
     point.A_M3),
    ("straus_mul_k14_ga_w4", "straus_wei448", "WEI448", "w2", point.A_ZERO),
    ("ed_dbln_add_k14", "edpoint", "ED448", "ed_dbln", edpoint.A_M1),
    ("windowed_mul_ed_k14_w4", "windowed_ed448", "ED448", "ed1",
     edpoint.A_M1)])
def test_new_entry_points_refuse_another_a_in_c(dev, cname, stem, curve,
                                                model, wrong):
    """Each C entry point at K = 17, each wide Straus one, the entry
    points of the later (K, a) instances and the wide kernel-5 and 8c ones
    return cudaErrorInvalidValue for a curve context whose a they are not
    built for, and launch nothing."""
    import ctypes
    ed = model.startswith("ed")
    c = (edwards.get_edwards_curve(curve) if ed
         else params.get_curve(curve))
    k = c.fp_ctx.k
    ncoord = 4 if ed else 3
    one = c.fp_ctx.from_ints([1, 2, 3], dev)
    outs = [torch.empty_like(one) for _ in range(ncoord)]
    cs = _wrong_a(edpoint.curve_struct(c) if ed else point.curve_struct(c),
                  wrong)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if model in ("add", "dbl"):
        ins = [one] * (6 if model == "add" else 3)
        rc = getattr(point._lib(stem), cname)(
            ctypes.byref(cs), point.ptr_array(ins), point.ptr_array(outs), 3,
            stream)
    elif model in ("dbln", "ed_dbln"):
        lib = edpoint._lib() if ed else point._lib(stem)
        rc = getattr(lib, cname)(
            ctypes.byref(cs), point.ptr_array([one] * 2 * ncoord),
            point.ptr_array(outs), 3, 2, stream)
    else:
        npairs = int(model[-1])                 # w1, w2, ed1, ed2
        tab = torch.zeros((16, ncoord, k, 3), dtype=torch.int32, device=dev)
        digs = torch.zeros((-(-c.scalar_bits() // 4), 3), dtype=torch.int32,
                           device=dev)
        rc = getattr(megamul._lib(stem), cname)(
            ctypes.byref(cs), point.ptr_array([digs] * npairs),
            digs.shape[0], point.ptr_array([tab] * npairs),
            point.ptr_array(outs), 3, stream)
    assert rc == 1                                     # cudaErrorInvalidValue


# -- kernels 4 and 6 (every K), 6-ed (K = 8) and 7 and 6-ed (K = 14) on the
# group loop --

# one curve for each (K, a) built on the group loop; Ed25519's kernel 6-ed
# runs it, its kernel 7 one thread a lane
GROUP_CURVES = ["P-192", "BRAINPOOLP192R1", "SECP192K1", "P-224",
                "BRAINPOOLP224R1", "SECP224K1", "P-256", "SECP256K1",
                "BRAINPOOLP256R1", "BRAINPOOLP320T1", "BRAINPOOLP320R1",
                "P-384", "BRAINPOOLP384R1", "WEI448", "BRAINPOOLP512T1",
                "BRAINPOOLP512R1", "P-521", "ED448", "ED25519"]


def group_loop_lanes(c, dev, nmax=161):
    """The group-loop tests' inputs on nmax lanes: point pairs P, Q (the
    identity on lanes 1 and 2 of P, the edge lanes of _point_pairs or
    _ed_pairs) and scalars us, vs (the window edge scalars first in us,
    from lane 2 in vs)."""
    rng = np.random.RandomState(81)
    if isinstance(c, EdwardsCurve):
        P, Q = _ed_pairs(c, rng, nmax, dev)
    else:
        P, Q = _point_pairs(c, rng, nmax, dev)
    edges = H.window_edge_scalars(c.q)
    us = edges + [2, 1 << 100] + _ints(rng, nmax - len(edges) - 2, c.q)
    vs = [0, 5] + edges + _ints(rng, nmax - len(edges) - 2, c.q)
    return P, Q, us, vs


@pytest.mark.parametrize("npairs", [1, 2])
@pytest.mark.parametrize("name", GROUP_CURVES)
def test_group_loop_kernels_match_plain_at_ragged_n(dev, name, npairs):
    """Kernel 4 (npairs 1) and kernel 6 (npairs 2) at each (K, a) of the
    group loop, kernels 7 and 6-ed on Ed448 and Ed25519, all on the group
    loop, against their plain versions, bitwise,
    at n = 1 (one group, a partial warp), 33 (every shape of
    csrc/groupfield.cuh's GroupShape gives a block 32 lanes: a partial
    block) and 161 (the last of six blocks holds one lane); where
    the group's threads do not divide K (K = 7, 14 and 17) its zero limbs
    are in play.
    The first lanes carry the identity (lanes 1 and 2 of P) and the window
    edge scalars. One plain run at 161 lanes serves the three, the lanes
    being independent. With n = 0 the C entry point returns 0 and so
    launched nothing: a launch of no blocks is refused
    (cudaErrorInvalidConfiguration)."""
    import ctypes
    ed = name.startswith("ED")
    c = edwards.get_edwards_curve(name) if ed else params.get_curve(name)
    cls, model = (ExtPoint, "ed") if ed else (PrjPoint, "w")
    nmax = 161
    P, Q, us, vs = group_loop_lanes(c, dev, nmax)
    nbits = c.scalar_bits()

    def inputs(n):
        tabs = [scalar_mul._build_mul_table(
            c, cls(*[v[:, :n].contiguous() for v in T]))
            for T in (P, Q)[:npairs]]
        digs = [scalar_mul._window_digits(nn.upload(nn.batch_to_limbs(
            m[:n], c.q_ctx.k), dev), nbits) for m in (us, vs)[:npairs]]
        return tabs, digs

    tabs, digs = inputs(nmax)
    want = megamul._mul_plain(c, tabs, digs, cls)
    name_k = megamul.kernel_name_of(c, npairs, model)
    for n in (1, 33, nmax):
        tabs, digs = inputs(n)
        before = megamul.launches[name_k]
        got = (megamul.windowed_mul(c, tabs[0], digs[0], cls)
               if npairs == 1 else
               megamul.straus_mul(c, tabs[0], digs[0], tabs[1], digs[1],
                                  cls))
        assert megamul.launches[name_k] == before + 1
        assert all(torch.equal(g, w[:, :n]) for g, w in zip(got, want)), n
    _, cname, stem = megamul.instance(c, model, npairs)
    k, ncoord = c.fp_ctx.k, len(cls._fields)
    tab = torch.zeros((16, ncoord, k, 0), dtype=torch.int32, device=dev)
    dig = torch.zeros((digs[0].shape[0], 0), dtype=torch.int32, device=dev)
    outs = [torch.zeros((k, 0), dtype=torch.int32, device=dev)] * ncoord
    cs = edpoint.curve_struct(c) if ed else point.curve_struct(c)
    rc = getattr(megamul._lib(stem), cname)(
        ctypes.byref(cs), point.ptr_array([dig] * npairs),
        dig.shape[0], point.ptr_array([tab] * npairs), point.ptr_array(outs),
        0, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc == 0
    torch.cuda.synchronize()


# -- kernel 2 on a group of threads a lane (every K) ------------------------

# one curve for each (K, a) of kernel 2, then the h > 1 curves that share
# an instance (WEI448 has its own)
ADD_CURVES = [*[n for n in GROUP_CURVES if not n.startswith("ED")],
              "WEI25519", "GOST_R3410_2012_256_PARAMSETA",
              "GOST_R3410_2012_512_PARAMSETC"]


@pytest.mark.parametrize("name", ADD_CURVES)
def test_add_kernel_matches_plain_at_ragged_n(dev, name):
    """Kernel 2 in csrc/groupfield.cuh's AddShape at each (K, a) against
    its plain version, bitwise, at n = 1 (one group, a partial warp), 33
    (a partial block at every shape of 32 lanes a block) and 161 (the last
    block holds one lane); where the group's threads do not divide K
    (K = 7, 14 and 17 at four threads) its zero limbs are in play. Edge
    lanes first: P + O, O + Q, O + O, P = Q, P = -Q, then random ones; on
    an h > 1 curve the point T2 of order 2 and the identity: O + T2,
    T2 + O (the complete add gives (0 : 0 : 0) there, ROADMAP.md section
    3) and T2 + T2 on lanes 5, 6 and 7. One plain run at 161 lanes serves
    the three, the lanes being independent; each n launches once. With
    n = 0 the C entry point returns 0 and so launched nothing."""
    import ctypes
    c = params.get_curve(name)
    rng = np.random.RandomState(82)
    nmax = 161
    A, B = _point_pairs(c, rng, nmax, dev)
    if c.h > 1:
        t2 = H.ec_order2_point(_host(c))
        A2 = _prj(c, rng, [None, t2, t2], dev)
        B2 = _prj(c, rng, [t2, None, t2], dev)
        A = PrjPoint(*[torch.cat([a[:, :5], e, a[:, 8:]], 1)
                       for a, e in zip(A, A2)])
        B = PrjPoint(*[torch.cat([b[:, :5], e, b[:, 8:]], 1)
                       for b, e in zip(B, B2)])
    want = point.point_add_plain(c, A, B)
    if c.h > 1:
        assert c.fp_ctx.to_ints(want.z[:, 6:7]) == [0]
    name_k = point.instance_name("point_add", c)
    for n in (1, 33, nmax):
        ins = [v[:, :n].contiguous() for v in (*A, *B)]
        before = dict(point.launches)
        got = point.point_add(c, PrjPoint(*ins[:3]), PrjPoint(*ins[3:]))
        assert point.launches[name_k] == before[name_k] + 1
        assert sum(point.launches.values()) == sum(before.values()) + 1
        assert all(torch.equal(g, w[:, :n]) for g, w in zip(got, want)), n
    stem, _, tag = point.BUILT[(c.fp_ctx.k, point.a_kind(c))]
    empty = torch.zeros((c.fp_ctx.k, 0), dtype=torch.int32, device=dev)
    rc = getattr(point._lib(stem), point._entry("point_add", c.fp_ctx.k,
                                                 tag))(
        ctypes.byref(point.curve_struct(c)), point.ptr_array([empty] * 6),
        point.ptr_array([empty] * 3), 0,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc == 0
    torch.cuda.synchronize()


# -- kernel 8a on a group of threads a lane (K = 8 and 14) ------------------

@pytest.mark.parametrize("name", ["ED25519", "ED448"])
def test_ed_add_kernel_matches_plain_at_ragged_n(dev, name):
    """Kernel 8a in csrc/groupfield.cuh's AddShape at K = 8 (a = -1) and
    K = 14 (a = 1) against its plain version, bitwise, at n = 1 (one
    group, a partial warp), 33 (a partial block at 32 lanes a block) and
    161 (the last block holds one lane); at K = 14 with four threads a
    lane the group's zero limbs are in play. Edge lanes first: P + O,
    O + Q, O + O, P = Q, P = -Q, then random ones, random Z on every lane.
    One plain run at 161 lanes serves the three, the lanes being
    independent; each n launches once. With n = 0 the C entry point
    returns 0 and so launched nothing."""
    import ctypes
    c = edwards.get_edwards_curve(name)
    rng = np.random.RandomState(83)
    nmax = 161
    A, B = _ed_pairs(c, rng, nmax, dev)
    want = edpoint.ed_add_plain(c, A, B)
    k = c.fp_ctx.k
    name_k = kernel_name("ed_add", k)
    for n in (1, 33, nmax):
        ins = [v[:, :n].contiguous() for v in (*A, *B)]
        before = dict(edpoint.launches)
        got = edpoint.ed_add(c, ExtPoint(*ins[:4]), ExtPoint(*ins[4:]))
        assert edpoint.launches[name_k] == before[name_k] + 1
        assert sum(edpoint.launches.values()) == sum(before.values()) + 1
        assert all(torch.equal(g, w[:, :n]) for g, w in zip(got, want)), n
    empty = torch.zeros((k, 0), dtype=torch.int32, device=dev)
    rc = getattr(edpoint._lib(), f"ed_add_k{k}")(
        ctypes.byref(edpoint.curve_struct(c)), point.ptr_array([empty] * 8),
        point.ptr_array([empty] * 4), 0,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc == 0
    torch.cuda.synchronize()


# -- kernel 3 on a group of threads a lane (every K) ------------------------

@pytest.mark.parametrize("name", ADD_CURVES)
def test_dbl_kernel_matches_plain_at_ragged_n(dev, name):
    """Kernel 3 in csrc/groupfield.cuh's AddShape at each (K, a) against
    its plain version, bitwise, at n = 1 (one group, a partial warp), 33
    (a partial block at every shape of 32 lanes a block) and 161 (the last
    block holds one lane); where the group's threads do not divide K
    (K = 7, 14 and 17 at four threads) its zero limbs are in play. Edge
    lanes first: O = (0 : Y : 0) on lane 0, P with Z = 1 on lane 1, then
    random P with random Z; on an h > 1 curve the point T2 of order 2 on
    lanes 2 and 3, whose double is the identity (0 : Y : 0). One plain
    run at 161 lanes serves the three, the lanes being independent; each
    n launches once. With n = 0 the C entry point returns 0 and so
    launched nothing."""
    import ctypes
    c = params.get_curve(name)
    rng = np.random.RandomState(84)
    nmax = 161
    wc = _host(c)
    base = [H.ec_base_mul(wc, 1 + k % (c.q - 1)) for k in _ints(rng, 16, c.q)]
    pts = [base[i % 16] for i in range(nmax)]
    pts[0] = None
    if c.h > 1:
        pts[2] = pts[3] = H.ec_order2_point(wc)
    A = _prj(c, rng, pts, dev)
    one = PrjPoint(*[c.fp_ctx.from_ints([v], dev)
                     for v in (*pts[1], 1)])
    A = PrjPoint(*[torch.cat([a[:, :1], o, a[:, 2:]], 1)
                   for a, o in zip(A, one)])
    want = point.point_dbl_plain(c, A)
    if c.h > 1:
        assert c.fp_ctx.to_ints(want.z[:, 2:4]) == [0, 0]
        assert 0 not in c.fp_ctx.to_ints(want.y[:, 2:4])
    name_k = point.instance_name("point_dbl", c)
    for n in (1, 33, nmax):
        ins = [v[:, :n].contiguous() for v in A]
        before = dict(point.launches)
        got = point.point_dbl(c, PrjPoint(*ins))
        assert point.launches[name_k] == before[name_k] + 1
        assert sum(point.launches.values()) == sum(before.values()) + 1
        assert all(torch.equal(g, w[:, :n]) for g, w in zip(got, want)), n
    stem, _, tag = point.BUILT[(c.fp_ctx.k, point.a_kind(c))]
    empty = torch.zeros((c.fp_ctx.k, 0), dtype=torch.int32, device=dev)
    rc = getattr(point._lib(stem), point._entry("point_dbl", c.fp_ctx.k,
                                                 tag))(
        ctypes.byref(point.curve_struct(c)), point.ptr_array([empty] * 3),
        point.ptr_array([empty] * 3), 0,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc == 0
    torch.cuda.synchronize()


# -- kernel 8b on a group of threads a lane (K = 8 and 14) ------------------

@pytest.mark.parametrize("name", ["ED25519", "ED448"])
def test_ed_dbl_kernel_matches_plain_at_ragged_n(dev, name):
    """Kernel 8b in csrc/groupfield.cuh's AddShape at K = 8 (a = -1) and
    K = 14 (a = 1) against its plain version, bitwise, at n = 1 (one
    group, a partial warp), 33 (a partial block at 32 lanes a block) and
    161 (the last block holds one lane); at K = 14 with four threads a
    lane the group's zero limbs are in play. Edge lanes first: the
    identity (0, 1) and the point (0, -1) of order 2, then random ones,
    random Z on every lane. One plain run at 161 lanes serves the three,
    the lanes being independent; each n launches once. With n = 0 the C
    entry point returns 0 and so launched nothing."""
    import ctypes
    c = edwards.get_edwards_curve(name)
    rng = np.random.RandomState(85)
    nmax = 161
    pts = _ed_affine(c, rng, nmax)
    pts[1] = (0, c.fp_ctx.p_int - 1)
    A = _ed_extended(c, rng, pts, dev)
    want = edpoint.ed_dbl_plain(c, A)
    k = c.fp_ctx.k
    name_k = kernel_name("ed_dbl", k)
    for n in (1, 33, nmax):
        ins = [v[:, :n].contiguous() for v in A]
        before = dict(edpoint.launches)
        got = edpoint.ed_dbl(c, ExtPoint(*ins))
        assert edpoint.launches[name_k] == before[name_k] + 1
        assert sum(edpoint.launches.values()) == sum(before.values()) + 1
        assert all(torch.equal(g, w[:, :n]) for g, w in zip(got, want)), n
    empty = torch.zeros((k, 0), dtype=torch.int32, device=dev)
    rc = getattr(edpoint._lib(), f"ed_dbl_k{k}")(
        ctypes.byref(edpoint.curve_struct(c)), point.ptr_array([empty] * 3),
        point.ptr_array([empty] * 4), 0,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert rc == 0
    torch.cuda.synchronize()
