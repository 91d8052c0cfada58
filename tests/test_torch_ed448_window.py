"""The plain versions of kernels 7 and 6-ed at K = 14 (Ed448, a = 1) on the
33 lanes of the group-loop card test (tests/test_torch_cuda.py:
group_loop_lanes): the identity among the points, the window edge
scalars, zero and short scalars. Each lane's m*P and u*P + v*Q against the
host oracle (hostref.ed_add's affine double-and-add, as hostref.ed_mul),
so the plain versions that the card holds the group-loop kernels against
are themselves right on those lanes.

    python -m pytest tests/test_torch_ed448_window.py
"""

import pytest
import torch

from libecc_tpu_torch.curves import edwards, scalar_mul
from libecc_tpu_torch.curves.edwards import ExtPoint
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ops.cuda import megamul
from libecc_tpu_torch.ref import hostref as H
from test_torch_cuda import group_loop_lanes

N = 33


@pytest.fixture
def one_torch_thread():
    """Tiny tensors: one intra-op thread (several test workers share the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lanes():
    """The curve, its host form, the 33 lanes' points and scalars, the
    plain tables and digits of both pairs (made once for both cases), and
    the oracle's k*P by double-and-add over hostref.ed_add: the lanes
    share 16 points, so each point's doublings are made once."""
    c = edwards.get_edwards_curve("ED448")
    p, cpu = c.fp_ctx.p_int, torch.device("cpu")
    hc = H.EdCurve(p, c.a, c.d, c.gx, c.gy, c.q, c.h)
    P, Q, us, vs = group_loop_lanes(c, cpu)
    bases = [ExtPoint(*[v[:, :N].contiguous() for v in T]) for T in (P, Q)]
    with torch.inference_mode():
        tabs = [scalar_mul._build_mul_table(c, B) for B in bases]
        digs = [scalar_mul._window_digits(nn.upload(
            nn.batch_to_limbs(m[:N], c.q_ctx.k), cpu), c.scalar_bits())
            for m in (us, vs)]
    nbits = 4 * digs[0].shape[0]
    doublings = {}

    def mul(k, A):
        assert 0 <= k < 1 << nbits
        if A not in doublings:
            D = [A]
            for _ in range(nbits - 1):
                D.append(H.ed_add(hc, D[-1], D[-1]))
            doublings[A] = D
        R = (0, 1)
        for j, D in enumerate(doublings[A]):
            if k >> j & 1:
                R = H.ed_add(hc, R, D)
        return R

    return c, hc, P, Q, us, vs, tabs, digs, mul


def _affine(c, T, i):
    p = c.fp_ctx.p_int
    x, y, z = [c.fp_ctx.to_ints(v[:, i:i + 1])[0] for v in T[:3]]
    zi = pow(z, -1, p)
    return x * zi % p, y * zi % p


@pytest.mark.parametrize("npairs", [1, 2])
def test_ed448_window_plain_matches_oracle_on_group_loop_lanes(
        one_torch_thread, lanes, npairs):
    c, hc, P, Q, us, vs, tabs, digs, mul = lanes
    p = c.fp_ctx.p_int
    assert digs[0].shape[0] == 112
    with torch.inference_mode():
        got = (megamul.windowed_mul(c, tabs[0], digs[0], ExtPoint)
               if npairs == 1 else
               megamul.straus_mul(c, tabs[0], digs[0], tabs[1], digs[1],
                                  ExtPoint))
    for i in range(N):
        x, y, z, t = [c.fp_ctx.to_ints(v[:, i:i + 1])[0] for v in got]
        assert x * y % p == z * t % p, i          # T = XY/Z
        want = mul(us[i], _affine(c, P, i))
        if npairs == 2:
            want = H.ed_add(hc, want, mul(vs[i], _affine(c, Q, i)))
        assert _affine(c, got, i) == want, i
