"""The port's ECDSA verify on the cofactor-1 curves at K = 10
(BrainpoolP320r1/t1), K = 12 with generic a (BrainpoolP384r1) and K = 16
with a = -3 (BrainpoolP512t1 here; BIGN512V1 and GOST R 34.10-2012 512
paramSetA and paramSetB, which share its kernels, in
test_torch_registry_512.py), on the CPU, against the host oracle: the 16
lanes of test_torch_registry.ecdsa_lanes a curve through verify_batch,
under the hash each curve's users pair with it (SHA-384 for the 320- and
384-bit Brainpool curves, SHA-512 for BrainpoolP512t1, SHA-256
elsewhere); and kernel 4's plain version at K = 6, 7 and 10 (48, 56, 57
and 80 windows: one per 4 bits of q) against the host oracle, on one
curve of each (K, a) instance there. Exact."""

import numpy as np
import pytest

from libecc_tpu_torch.curves import params, scalar_mul, shortw
from libecc_tpu_torch.curves.shortw import PrjPoint
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from test_torch_registry import (K6_K7, WIDE, _one_torch_thread,
                                 check_ecdsa_curve, host, ints)

assert _one_torch_thread                # the module's autouse fixture


@pytest.mark.parametrize("name", WIDE[:4])
def test_ecdsa_verify_matches_the_host_oracle(name):
    c = check_ecdsa_curve(name, 303)
    assert (c.fp_ctx.k, c.a_is_m3) in ((10, True), (10, False),
                                        (12, False), (16, True))


def _affine(c, P):
    p = c.fp_ctx.p_int
    X, Y, Z = [c.fp_ctx.to_ints(v) for v in P]
    return [None if z == 0 else (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)
            for x, y, z in zip(X, Y, Z)]


@pytest.mark.parametrize("name", K6_K7[:6] + WIDE[:2])
def test_plain_windowed_mul_against_the_oracle(name):
    """Kernel 4's plain version through windowed_mul_public, one window per
    4 bits of q (secp224k1: 57 windows of its 225-bit q over K = 7
    coordinates): scalars whose last add is T + O, -T + T and T + T, then
    a random one, on random points and the identity (lane 4); compared in
    affine form mod p."""
    c = params.get_curve(name)
    wc = host(c)
    rng = np.random.RandomState(323)
    ms = H.window_edge_scalars(c.q) + ints(rng, 1, c.q)
    pts = [H.ec_base_mul(wc, 1 + v % (c.q - 1))
           for v in ints(rng, len(ms), c.q)]
    pts[4] = None
    p = c.fp_ctx.p_int
    lam = [1 + v % (p - 1) for v in ints(rng, len(ms), p)]
    f = c.fp_ctx.from_ints
    P = PrjPoint(
        f([0 if q is None else q[0] * m % p for q, m in zip(pts, lam)], "cpu"),
        f([m if q is None else q[1] * m % p for q, m in zip(pts, lam)], "cpu"),
        f([0 if q is None else m for q, m in zip(pts, lam)], "cpu"))
    mt = nn.upload(nn.batch_to_limbs(ms, c.q_ctx.k), "cpu")
    nwin = -(-c.q.bit_length() // 4)
    assert scalar_mul._window_digits(mt, c.scalar_bits()).shape == (
        nwin, len(ms))
    R = scalar_mul.windowed_mul_public(c, mt, P)
    assert _affine(c, R) == [H.ec_mul(wc, m, pt) for m, pt in zip(ms, pts)]
    assert shortw.on_curve_mask(c, R).all()
