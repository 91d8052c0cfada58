"""The plain versions of this slice's K = 14 point kernels against the JAX
package (K = 32 there), on the CPU, called eagerly with Pallas off, as
projective values mod p: kernels 2, 3 and 5 with WEI448's generic a
(point_add_plain, point_dbl_plain, point_dbln_add_plain against
shortw.point_add, point_dbl and point_dbln_add: 7 lanes with the
identity in either or both operands, P = Q and P = -Q) and kernel 8c with
Ed448's a = 1 (ed_dbln_add_plain against EdwardsCurve.pdbln_add, n = 0
and 2); each also against the host oracle. Exact."""

import numpy as np

from libecc_tpu.curves import edwards as jed
from libecc_tpu.curves import shortw as jshortw

from libecc_tpu_torch import convert
from libecc_tpu_torch.curves import edwards as ed
from libecc_tpu_torch.ops.cuda import edpoint, point
from libecc_tpu_torch.ref import hostref as H

from test_torch_straus import (_jax_ext, _jax_prj, _scan_path, _vals,
                               _w_affine, _w_lanes, _wcurves)

assert _scan_path                       # the module's autouse fixture


def test_plain_point_kernels_k14_generic_a_match_jax():
    c, jc, wc = _wcurves("WEI448")
    assert (c.fp_ctx.k, jc.fp_ctx.k, point.a_kind(c)) == (14, 32,
                                                          point.A_GENERIC)
    rng = np.random.RandomState(431)
    A, B = _w_lanes(wc, rng)
    Aj, Bj = _jax_prj(jc, A, rng), _jax_prj(jc, B, rng)
    At = convert.point_from_jax(c, *[np.asarray(v) for v in Aj], "cpu")
    Bt = convert.point_from_jax(c, *[np.asarray(v) for v in Bj], "cpu")
    p = c.fp_ctx.p_int
    for got, want, oracle in (
            (point.point_add_plain(c, At, Bt), jshortw.point_add(jc, Aj, Bj),
             [H.ec_add(wc, a, b) for a, b in zip(A, B)]),
            (point.point_dbl_plain(c, At), jshortw.point_dbl(jc, Aj),
             [H.ec_add(wc, a, a) for a in A]),
            (point.point_dbln_add_plain(c, At, Bt, 2),
             jshortw.point_dbln_add(jc, Aj, Bj, 2),
             [H.ec_add(wc, H.ec_mul(wc, 4, a), b) for a, b in zip(A, B)])):
        got = _vals(c.fp_ctx, got)
        assert got == _vals(jc.fp_ctx, want)
        assert _w_affine(p, got) == oracle


def test_plain_ed_dbln_add_k14_matches_jax():
    c = ed.get_edwards_curve("ED448")
    jc = jed.get_edwards_curve("ED448")
    assert (c.fp_ctx.k, jc.fp_ctx.k) == (14, 32)
    p = c.fp_ctx.p_int
    hc = H.EdCurve(p, c.a, c.d, c.gx, c.gy, c.q, c.h)
    rng = np.random.RandomState(432)

    def rnd():
        return H.ed_base_mul(hc, int.from_bytes(rng.bytes(57), "big") % c.q)
    A = [rnd() for _ in range(6)]
    B = [rnd() for _ in range(6)]
    A[1] = (0, 1)
    B[2] = (0, 1)
    B[3] = A[3]
    B[4] = ((-A[4][0]) % p, A[4][1])
    Aj, Bj = _jax_ext(jc, A, rng), _jax_ext(jc, B, rng)
    At = convert.ext_point_from_jax(c, *[np.asarray(v) for v in Aj], "cpu")
    Bt = convert.ext_point_from_jax(c, *[np.asarray(v) for v in Bj], "cpu")
    for n in (0, 2):
        want = _vals(jc.fp_ctx, jc.pdbln_add(Aj, Bj, n))
        got = _vals(c.fp_ctx, edpoint.ed_dbln_add_plain(c, At, Bt, n))
        assert got == want
        assert _w_affine(p, got) == [H.ed_add(hc, H.ed_mul(hc, 1 << n, a), b)
                                     for a, b in zip(A, B)]
