"""The port's ECDSA verify_core on P-384 (K = 12, a = -3), BrainpoolP512r1
and GOST512 (K = 16, generic a) against the JAX package's verify_core
(K = 28 and 37) called eagerly on 16 adversarial lanes (16 is not a
multiple of 1024, so the JAX package takes no Pallas kernel), lane for
lane, and against the host oracle. Each JAX mask is computed once per
curve; it costs about 60 s at K = 28 and 100 s at K = 37 on the CPU, so
GOST512, which runs the same K = 16 generic-a code as BrainpoolP512r1, is
in the slow tier."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import params as jparams
from libecc_tpu.nn import core as jnn
from libecc_tpu.sig import ecdsa as jecdsa

from libecc_tpu_torch import convert
from libecc_tpu_torch.curves import params
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import ecdsa

# lanes 0, 1, 11, 14: valid; 10: x(W) = r + q, accepted through the
# second candidate of the projective test; every other lane rejects
WANT = [i in (0, 1, 10, 11, 14) for i in range(16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sqrt(v: int, p: int):
    """A square root of v mod the odd prime p (Tonelli-Shanks), or None."""
    v %= p
    if v == 0:
        return 0
    if pow(v, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q, s = q // 2, s + 1
    z = next(z for z in range(2, p) if pow(z, (p - 1) // 2, p) == p - 1)
    m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2, i = t2 * t2 % p, i + 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def _lanes(c):
    """16 lanes of (affine key, e, r, s) covering every rejection class of
    the verifier and both candidates of its projective accept test."""
    p, q = c.fp_ctx.p_int, c.q
    wc = H.WCurve(p, c.a, c.b, c.gx, c.gy, q, c.h)
    rng = np.random.RandomState(96)
    nb = (q.bit_length() + 7) // 8

    def rnd():
        return 1 + int.from_bytes(rng.bytes(nb + 16), "big") % (q - 1)

    def e_of(m):
        return H.trunc_msb_mod_q(hashlib.sha256(m).digest(), q)

    lanes = []
    for _ in range(16):
        d, m = rnd(), rng.bytes(32)
        r, s = H.ecdsa_sign_ref(wc, d, e_of(m), rnd())
        lanes.append([H.ec_base_mul(wc, d), e_of(m), r, s])
    lanes[2][2] += 1                                         # r + 1
    lanes[3][3] = 0                                          # s = 0
    lanes[4][2] = 0                                          # r = 0
    lanes[5][3] = q                                          # s = q
    lanes[6][2] = q                                          # r = q
    lanes[7][1] = e_of(b"another message")                   # other message
    x, y = lanes[8][0]
    lanes[8][0] = (x, (y + 1) % p)                           # off-curve key
    lanes[9][2] = 12345                # r < p - q: the r + q candidate is
    assert 12345 < p - q               # tried, and rejects
    lanes[12][3] = q + 1                                     # s > q
    lanes[13][2] = q + 5                                     # r > q
    lanes[15][0] = lanes[14][0]                              # another key
    # lane 10: a key under which (r, s) with r = x(W) - q verifies: W a
    # point with q <= x(W) < p, then Y = v^-1 (W - u G)
    t = next(t for t in range(1, 1000)
             if _sqrt((q + t) ** 3 + c.a * (q + t) + c.b, p) is not None)
    assert q + t < p
    W = (q + t, _sqrt((q + t) ** 3 + c.a * (q + t) + c.b, p))
    e, s = lanes[10][1], rnd()
    si = pow(s, -1, q)
    u, v = e * si % q, t * si % q
    Y = H.ec_mul(wc, pow(v, -1, q), H.ec_add(
        wc, W, H.ec_neg(wc, H.ec_base_mul(wc, u))))
    lanes[10][0], lanes[10][2], lanes[10][3] = Y, t, s
    return wc, lanes


CURVES = ["SECP384R1", "BRAINPOOLP512R1",
          pytest.param("GOST512", marks=pytest.mark.slow)]


@pytest.fixture(scope="module", params=CURVES)
def case(request):
    """The curve, its lanes, the JAX package's inputs and its accept mask
    (verify_core called eagerly, once per curve)."""
    name = request.param
    c, jc = params.get_curve(name), jparams.get_curve(name)
    wc, lanes = _lanes(c)
    pub_j = jc.point_from_affine_ints([ln[0][0] for ln in lanes],
                                      [ln[0][1] for ln in lanes])
    esr = [jnn.batch_to_limbs([ln[i] for ln in lanes], jc.q_ctx.k)
           for i in (1, 2, 3)]
    acc = np.asarray(jecdsa.verify_core(jc, pub_j,
                                        *[jnp.asarray(v) for v in esr]))
    return c, wc, lanes, pub_j, esr, acc.tolist()


def test_verify_core_matches_jax_lane_for_lane(case):
    c, wc, lanes, pub_j, esr, jax_acc = case
    assert (c.fp_ctx.k, c.a_is_m3) == ((12, True) if c.name == "SECP384R1"
                                       else (16, False))
    kb = convert.keys_from_jax(c, *[np.asarray(v) for v in pub_j],
                               "cpu")
    e, r, s = [convert.scalars_from_jax(v, c.q_ctx.k, "cpu") for v in esr]
    got = ecdsa.verify_core(c, kb.pub, e, r, s).tolist()
    assert got == jax_acc
    assert got == WANT
    # the host oracle agrees on every lane whose key is on the curve
    want = [H.ecdsa_verify_ref(wc, ln[0], ln[1], ln[2], ln[3])
            if i != 8 else False for i, ln in enumerate(lanes)]
    assert want == WANT
