"""The joint-table Straus (scalar_mul.straus_double_mul_public: one joint
table iP + jQ, nbits/2 steps of kernel 5, or 8c on an Edwards curve) at
wide K, on the CPU through the kernels' plain versions: P-384 (K = 12,
a = -3), P-521 (K = 17, a = -3), WEI448 (K = 14, generic a) and Ed448
(K = 14, Edwards a = 1; these two in test_torch_joint_wide_14.py, each
file about 35 s here). On 6 lanes (P + O, O + Q, O + O, P = Q, P = -Q
and a random pair; zero, one, short and full-size scalars) its points
equal the separate-table Straus's (straus_double_mul_public_w4) and the
host oracle's u*P + v*Q in affine form. Exact."""

import numpy as np
import pytest

from libecc_tpu_torch.curves import edwards, params, scalar_mul
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H

from test_torch_cuda import _ed_pairs, _host, _point_pairs
from test_torch_registry import _one_torch_thread

assert _one_torch_thread                # the module's autouse fixture


def affine(c, pt):
    """Host affine points of a batch (None: the identity)."""
    p = c.fp_ctx.p_int
    X, Y, Z = [c.fp_ctx.to_ints(v) for v in pt[:3]]
    return [None if z == 0 else (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)
            for x, y, z in zip(X, Y, Z)]


def check_joint_straus(name):
    rng = np.random.RandomState(421)
    n = 6
    ed = name.startswith("ED")
    if ed:
        c = edwards.get_edwards_curve(name)
        P, Q = _ed_pairs(c, rng, n, "cpu")
        hc = H.EdCurve(c.fp_ctx.p_int, c.a, c.d, c.gx, c.gy, c.q, c.h)
        add, mul = (lambda a, b: H.ed_add(hc, a, b),
                    lambda k, a: H.ed_mul(hc, k, a))
    else:
        c = params.get_curve(name)
        P, Q = _point_pairs(c, rng, n, "cpu")
        wc = _host(c)
        add, mul = (lambda a, b: H.ec_add(wc, a, b),
                    lambda k, a: H.ec_mul(wc, k, a))
    q = c.q
    us = [5, 0, 7, (1 << 100) + 3, q - 1, q // 3 + int(rng.randint(1 << 30))]
    vs = [0, 9, 3, 1, q - 1, q - 2 - int(rng.randint(1 << 30))]
    ut, vt = [nn.upload(nn.batch_to_limbs(v, c.q_ctx.k), "cpu")
              for v in (us, vs)]
    got = affine(c, scalar_mul.straus_double_mul_public(c, ut, P, vt, Q))
    w4 = affine(c, scalar_mul.straus_double_mul_public_w4(c, ut, P, vt, Q))
    oracle = [add(mul(u, a), mul(v, b)) for u, v, a, b in
              zip(us, vs, affine(c, P), affine(c, Q))]
    assert got == w4 == oracle


@pytest.mark.parametrize("name", ["P-384", "P-521"])
def test_joint_straus_matches_w4_and_the_oracle(name):
    check_joint_straus(name)
