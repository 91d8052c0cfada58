"""The port's twisted-Edwards layer (plain versions of kernels 8a, 8b and
7, the Edwards comb table, fp.sqrt, the point helpers) against the JAX
package and the host oracle, on the CPU. Extended outputs are compared as
values mod p: both packages evaluate the same HWCD formulas on the same
schedule, so X, Y, Z and T agree exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import edwards as jed, params as jparams
from libecc_tpu.curves import scalar_mul as jsm
from libecc_tpu.fp import field as jfp
from libecc_tpu.nn import core as jnn

from libecc_tpu_torch import convert
from libecc_tpu_torch.curves import edwards as ed, params, scalar_mul
from libecc_tpu_torch.curves.edwards import ExtPoint
from libecc_tpu_torch.fp import field as fp
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ops.cuda import edpoint, megamul
from libecc_tpu_torch.ref import hostref as H

C = ed.get_edwards_curve("ED25519")
P = C.fp_ctx.p_int
HC = H.EdCurve(P, C.a, C.d, C.gx, C.gy, C.q, C.h)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(name):
    c = ed.get_edwards_curve(name)
    return c, H.EdCurve(c.fp_ctx.p_int, c.a, c.d, c.gx, c.gy, c.q, c.h)


def _pairs(name, rng):
    """8 lanes of (P, Q): random, P = Q, P = -Q, O + Q, P + O, O + O and
    two random pairs."""
    c, hc = _host(name)
    p = c.fp_ctx.p_int

    def rnd():
        return H.ed_mul(hc, int.from_bytes(rng.bytes(16), "big"),
                        (c.gx, c.gy))
    A = [rnd() for _ in range(8)]
    B = [rnd() for _ in range(8)]
    B[1] = A[1]
    B[2] = ((-A[2][0]) % p, A[2][1])
    A[3] = (0, 1)
    B[4] = (0, 1)
    A[5] = B[5] = (0, 1)
    return A, B


def _jax_ext(name, pts, rng):
    """Host affine points -> JAX ExtPoint with random Z."""
    jc = jed.get_edwards_curve(name)
    p = jc.fp_ctx.p_int
    lam = [1 + int.from_bytes(rng.bytes(64), "big") % (p - 1) for _ in pts]
    cols = zip(*[(x * m % p, y * m % p, m, x * y % p * m % p)
                 for (x, y), m in zip(pts, lam)])
    return jed.ExtPoint(*[jc.fp_ctx.from_ints(list(col)) for col in cols])


def _port(c, Pj):
    return convert.ext_point_from_jax(c, *[np.asarray(v) for v in Pj], "cpu")


def _vals(ctx, pt):
    return [ctx.to_ints(v) for v in pt]


def _affine(c, vals):
    p = c.fp_ctx.p_int
    X, Y, Z, _ = vals
    return [(x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)
            for x, y, z in zip(X, Y, Z)]


@pytest.mark.parametrize("name", ["ED25519", "ED448"])
@pytest.mark.parametrize("op", ["add", "dbl"])
def test_point_formulas_match_jax(name, op):
    """a = -1 (Ed25519, add-2008-hwcd-3) and a = 1 (Ed448, add-2008-hwcd)."""
    c, hc = _host(name)
    jc = jed.get_edwards_curve(name)
    rng = np.random.RandomState(81)
    A, B = _pairs(name, rng)
    Aj, Bj = _jax_ext(name, A, rng), _jax_ext(name, B, rng)
    if op == "add":
        want = _vals(jc.fp_ctx, jed.point_add(jc, Aj, Bj))
        got = _vals(c.fp_ctx, edpoint.ed_add_plain(c, _port(c, Aj),
                                                    _port(c, Bj)))
        oracle = [H.ed_add(hc, a, b) for a, b in zip(A, B)]
    else:
        want = _vals(jc.fp_ctx, jed.point_dbl(jc, Aj))
        got = _vals(c.fp_ctx, edpoint.ed_dbl_plain(c, _port(c, Aj)))
        oracle = [H.ed_add(hc, a, a) for a in A]
    assert got == want
    assert _affine(c, got) == oracle
    X, Y, Z, T = got
    assert [x * y % c.fp_ctx.p_int for x, y in zip(X, Y)] == [
        t * z % c.fp_ctx.p_int for t, z in zip(T, Z)]


@pytest.fixture(scope="module")
def scalars():
    rng = np.random.RandomState(82)
    rand = [int.from_bytes(rng.bytes(32), "big") % C.q for _ in range(3)]
    ms = [0, 1, C.q - 1, (1 << 37) + 5] + rand
    jc = jed.get_edwards_curve("ED25519")
    mj = jnn.batch_to_limbs(ms, jc.q_ctx.k)
    return ms, mj, convert.scalars_from_jax(mj, C.q_ctx.k, "cpu")


def test_comb_table_matches_jax():
    jc = jed.get_edwards_curve("ED25519")
    nbits = C.scalar_bits()
    tab_j, nwin_j, ncoord = jsm._comb_table_host(jc, scalar_mul.COMB_W, nbits)
    tab, nwin = scalar_mul._comb_table_host(C, nbits)
    assert (nwin, ncoord) == (nwin_j, 4) == (32, 4)
    assert np.array_equal(tab, convert.comb_table_from_jax(tab_j, C.fp_ctx))


def test_fixed_base_mul_matches_oracle(scalars):
    ms, _, mt = scalars
    got = _vals(C.fp_ctx, scalar_mul.fixed_base_mul(C, mt))
    assert _affine(C, got) == [H.ed_mul(HC, m, (C.gx, C.gy)) for m in ms]


def test_windowed_mul_matches_jax(scalars):
    """The plain version of kernel 7 (through windowed_mul_public) against
    the JAX package's windowed_mul_public, which takes its scan path on
    the CPU."""
    ms, mj, mt = scalars
    jc = jed.get_edwards_curve("ED25519")
    rng = np.random.RandomState(83)
    pts = [H.ed_base_mul(HC, int.from_bytes(rng.bytes(32), "big") % C.q)
           for _ in ms]
    Pj = _jax_ext("ED25519", pts, rng)
    want = _vals(jc.fp_ctx, jsm.windowed_mul_public(jc, jnp.asarray(mj), Pj))
    Pt = _port(C, Pj)
    got = _vals(C.fp_ctx, scalar_mul.windowed_mul_public(C, mt, Pt))
    assert got == want
    assert _affine(C, got) == [H.ed_mul(HC, m, q) for m, q in zip(ms, pts)]
    table = scalar_mul._build_mul_table(C, Pt)
    assert tuple(table.shape) == (16, 4, 8, len(ms))
    digs = scalar_mul._window_digits(mt, C.scalar_bits())
    direct = megamul.windowed_mul_plain(C, table, digs, ExtPoint)
    assert _vals(C.fp_ctx, direct) == got


@pytest.mark.parametrize("curve", ["ED25519", "P-256"])
def test_sqrt_matches_jax(curve):
    """Residues, non-residues and 0: p = 5 (mod 8) takes Atkin's branch with
    the sqrt(-1) fix-up, p = 3 (mod 4) the single exponentiation."""
    if curve == "ED25519":
        ctx, jctx = C.fp_ctx, jed.get_edwards_curve(curve).fp_ctx
    else:
        ctx = params.get_curve(curve).fp_ctx
        jctx = jparams.get_curve(curve).fp_ctx
    p = ctx.p_int
    rng = np.random.RandomState(84)
    rand = [int.from_bytes(rng.bytes(40), "big") % p for _ in range(6)]
    vals = [0, 1, p - 1, 4] + [v * v % p for v in rand[:3]] + rand[3:]
    r, ok = fp.sqrt(ctx.from_ints(vals, "cpu"), ctx)
    rj, okj = jfp.sqrt(jctx.from_ints(vals), jctx)
    is_sq = [v == 0 or pow(v, (p - 1) // 2, p) == 1 for v in vals]
    assert ok.tolist() == np.asarray(okj).tolist() == is_sq
    roots = ctx.to_ints(r)
    assert [x for x, s in zip(roots, is_sq) if s] == [
        x for x, s in zip(jctx.to_ints(rj), is_sq) if s]
    assert all(x * x % p == v for x, v, s in zip(roots, vals, is_sq) if s)


def test_sqrt_general_branch_not_ported():
    ctx = params.get_curve("P-224").fp_ctx                 # p = 1 (mod 8)
    with pytest.raises(NotImplementedError):
        fp.sqrt(ctx.from_ints([4], "cpu"), ctx)


def test_point_helpers():
    rng = np.random.RandomState(85)
    pts = [(0, 1)] + [H.ed_base_mul(HC, int.from_bytes(rng.bytes(32), "big"))
                      for _ in range(3)]
    Pj = _jax_ext("ED25519", pts, rng)
    Pt = _port(C, Pj)
    assert ed.is_identity_mask(C, Pt).tolist() == [True, False, False, False]
    assert ed.on_curve_mask(C, Pt).all()
    bad = ExtPoint(Pt.x, fp.add(Pt.y, C.fp_ctx.one(like=Pt.y), C.fp_ctx),
                   Pt.z, Pt.t)
    assert not ed.on_curve_mask(C, bad)[1:].any()
    x, y = ed.to_affine_plain(C, Pt)
    assert list(zip(nn.batch_from_limbs(x), nn.batch_from_limbs(y))) == pts
    nx, ny = ed.to_affine_plain(C, ed.point_neg(C, Pt))
    assert list(zip(nn.batch_from_limbs(nx), nn.batch_from_limbs(ny))) == [
        ((-px) % P, py) for px, py in pts]
    G = C.generator(batch_shape=(2,), device="cpu")
    assert ed.on_curve_mask(C, ExtPoint(*[g.contiguous() for g in G])).all()
    back = convert.ext_point_to_jax(Pt, C.fp_ctx, Pj.x.shape[0])
    assert all(np.array_equal(b, np.asarray(jfp.canon(v, Pj_ctx)))
               for b, v, Pj_ctx in zip(back, Pj, [jed.get_edwards_curve(
                   "ED25519").fp_ctx] * 4))
