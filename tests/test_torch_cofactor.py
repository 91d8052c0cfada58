"""The port on the cofactor > 1 curves of the registry (WEI25519, h = 8;
GOST R 34.10-2012 256 paramSetA and 512 paramSetC and WEI448, h = 4), on
the CPU, against the host oracle: the q*P subgroup check of public-key
import (keys.order_check_mask and pubkey_batch_from_affine_ints) on
WEI448 and GOST 512 C, on keys d*G with a point of small order added on
some lanes, and which import calls run it. Exact everywhere. The helpers
serve the other test_torch_cofactor*.py files: ECDSA verify
(test_torch_cofactor_ecdsa.py), ECFSDSA batch verification
(test_torch_cofactor_fsdsa.py) and the comparisons with the JAX package
(test_torch_cofactor_jax*.py)."""

import random

import numpy as np
import pytest

from libecc_tpu_torch.curves import params
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import batch_verify as bv, keys as K

from test_torch_registry import (_one_torch_thread, digest, fsdsa_batch,
                                 host, ints)

assert _one_torch_thread                # the module's autouse fixture
# the registry's cofactor > 1 short-Weierstrass curves -> the hash their
# users pair with them (SHA-512's 512 bits truncated to WEI448's 446-bit q)
CURVES = {"WEI25519": "SHA256", "GOST_R3410_2012_256_PARAMSETA": "SHA256",
          "GOST_R3410_2012_512_PARAMSETC": "SHA512", "WEI448": "SHA512"}


def small_order_point(c, x0=2):
    """A point T != O whose order divides h (host ints)."""
    return H.ec_small_order_point(host(c), x0)


def mixed_keys(c, seed, bad=(1, 4, 6), n=8, order2=False):
    """n keys d_i*G; on the lanes `bad` a point of small order is added
    (G*d + T, T from small_order_point at three starting x); with order2,
    lane n is the curve's point T2 = (x, 0) of order 2 itself. Returns the
    affine keys and the host oracle's mask (q*P == O)."""
    wc = host(c)
    rng = np.random.RandomState(seed)
    pts = [H.ec_base_mul(wc, 1 + v) for v in ints(rng, n, c.q - 1)]
    for j, i in enumerate(bad):
        pts[i] = H.ec_add(wc, pts[i], small_order_point(c, 2 + 40 * j))
    if order2:
        pts.append(H.ec_order2_point(wc))
    want = [H.ec_mul(wc, c.q, P) is None for P in pts]
    assert [i for i, ok in enumerate(want) if not ok] == (
        list(bad) + [n] * order2)
    return pts, want


def _point_x_in(c, wc, rng, lo, hi):
    """A point k*G (order q) whose x lies in [lo, hi)."""
    while True:
        W = H.ec_base_mul(wc, 1 + ints(rng, 1, c.q - 1)[0])
        if lo <= W[0] < hi:
            return W


def cofactor_lanes(c, hash_name, seed):
    """16 lanes of (affine key, message, r, s) for a curve with
    ceil(p/q) > 2: 0, 1, 14 valid (14 under the key G); 2 a flipped bit of
    s; 3 another message; 4 r = q; 5 r = 0; 6 s = 0; 7 s = q; 8 an
    off-curve key; 9 a valid lane whose x(W) is in [q, 2q), r = x(W) - q;
    10 lane 9 signed with the unreduced x(W) as r; 11 valid with x(W) in
    [2q, p), r = x(W) mod q; 12 lane 11 with the unreduced x(W); 13 a key
    with a small-order component (its verdict is the oracle's); 15 r + 1.
    Returns the host curve, the lanes and the wanted mask (the host
    oracle's, False for the off-curve key)."""
    p, q = c.fp_ctx.p_int, c.q
    wc = host(c)
    rng = np.random.RandomState(seed)

    def rnd():
        return 1 + ints(rng, 1, q - 1)[0]

    def e_of(m):
        return H.trunc_msb_mod_q(digest(hash_name, m), q)

    lanes = []
    for i in range(16):
        d, m = (1 if i == 14 else rnd()), rng.bytes(32)
        r, s = H.ecdsa_sign_ref(wc, d, e_of(m), rnd())
        lanes.append([H.ec_base_mul(wc, d), m, r, s])
    lanes[2][3] ^= 1                                         # flipped bit
    lanes[3][1] = b"another message"
    lanes[4][2] = q                                          # r = q
    lanes[5][2] = 0                                          # r = 0
    lanes[6][3] = 0                                          # s = 0
    lanes[7][3] = q                                          # s = q
    x, y = lanes[8][0]
    lanes[8][0] = (x, (y + 1) % p)                           # off-curve key
    # lanes 9 and 11: W with x(W) at or above q, r = x(W) mod q, and the
    # key Y = v^-1 (W - u G); lanes 10 and 12 the same with r = x(W)
    for i, (lo, hi) in ((9, (q, 2 * q)), (11, (2 * q, p))):
        W = _point_x_in(c, wc, rng, lo, hi)
        r, s, m = W[0] % q, rnd(), lanes[i][1]
        si = pow(s, -1, q)
        u, v = e_of(m) * si % q, r * si % q
        Y = H.ec_mul(wc, pow(v, -1, q), H.ec_add(
            wc, W, H.ec_neg(wc, H.ec_base_mul(wc, u))))
        lanes[i] = [Y, m, r, s]
        lanes[i + 1] = [Y, m, W[0], s]
    lanes[13][0] = H.ec_add(wc, lanes[13][0], small_order_point(c))
    lanes[15][2] += 1                                        # r + 1
    want = [i != 8 and H.ecdsa_verify_ref(wc, Y, e_of(m), r, s)
            for i, (Y, m, r, s) in enumerate(lanes)]
    assert [i for i in (0, 1, 9, 11, 14) if not want[i]] == []
    assert not any(want[i] for i in (2, 3, 4, 5, 6, 7, 8, 10, 12, 15))
    return wc, lanes, want


def sigs_of(c, lanes):
    nb = (c.q.bit_length() + 7) // 8
    return [r.to_bytes(nb, "big") + s.to_bytes(nb, "big")
            for _, _, r, s in lanes]


def rng_of(seed):
    r = random.Random(seed)
    return lambda n: bytes(r.randrange(256) for _ in range(n))


def checked_batch(name, n=6, seed=411):
    """fsdsa_batch's n host-signed lanes (keys G and -G, nonces 1 and
    q - 1 among them), the keys imported with the default subgroup
    check."""
    c = params.get_curve(name)
    pts, msgs, sigs = fsdsa_batch(c, CURVES[name], seed, n)
    kb = K.pubkey_batch_from_affine_ints(c, "ECFSDSA", [P[0] for P in pts],
                                         [P[1] for P in pts], device="cpu")
    return c, kb, msgs, sigs


def check_accepts_and_rejects(name, other_message=True):
    """The valid batch accepts; a flipped bit of s (lane 3) and, with
    other_message, another message (lane 1) reject it."""
    _, kb, msgs, sigs = checked_batch(name)
    hash_name = CURVES[name]
    bad_s = list(sigs)
    bad_s[3] = bad_s[3][:-1] + bytes([bad_s[3][-1] ^ 1])
    bad_m = list(msgs)
    bad_m[1] = msgs[1] + b"x"
    cases = [(msgs, sigs, True), (msgs, bad_s, False)]
    if other_message:
        cases.append((bad_m, sigs, False))
    for ms, ss, want in cases:
        assert bv.ecfsdsa_verify_batch(kb, ms, ss, hash_name, rng=rng_of(7),
                                       device="cpu") is want


def test_the_cofactor_curves():
    """The four curves are the registry's short-Weierstrass curves with
    h > 1, each with ceil(p/q) > 2 (the affine accept test); WEI448 runs
    at K = 14 with generic a, the others at K = 8 and 16."""
    cof = {c.name: (c.h, c.fp_ctx.k, c.q_ctx.k, (c.fp_ctx.p_int - 1) // c.q
                    + 1)
           for c in map(params.get_curve, params._CURVES) if c.h > 1}
    assert cof == {"WEI25519": (8, 8, 8, 8),
                   "GOST_R3410_2012_256_PARAMSETA": (4, 8, 8, 4),
                   "GOST_R3410_2012_512_PARAMSETC": (4, 16, 16, 5),
                   "WEI448": (4, 14, 14, 5)}
    assert not any(params.get_curve(n).a_is_m3 or params.get_curve(n).a_is_0
                   for n in cof)


@pytest.mark.parametrize("name", ["WEI448", "GOST_R3410_2012_512_PARAMSETC",
                                  "WEI25519",
                                  "GOST_R3410_2012_256_PARAMSETA"])
def test_order_check_matches_the_host_oracle(name):
    """order_check_mask on 9 keys, three with a small-order component and
    the last the point T2 of order 2 (y = 0), equals the host oracle's
    q*P == O; the default import (h > 1: the check on) raises ValueError
    naming exactly those keys. T2 is refused although the complete
    formulas' add of the identity and T2 gives (0 : 0 : 0), which reads as
    the identity: the y = 0 test beside the multiply."""
    c = params.get_curve(name)
    pts, want = mixed_keys(c, 401, order2=True)
    assert pts[8][1] == 0 and want[8] is False
    xs, ys = [P[0] for P in pts], [P[1] for P in pts]
    pub = c.point_from_affine_ints(xs, ys, "cpu")
    assert K.order_check_mask(c, pub).tolist() == want
    with pytest.raises(ValueError, match=r"public key\(s\) \[1, 4, 6, 8\]: "
                                         "point not in the order-q"):
        K.pubkey_batch_from_affine_ints(c, "ECDSA", xs, ys, device="cpu")


def test_the_check_runs_exactly_where_asked(monkeypatch):
    """The default runs the check for h > 1 only: never on P-256 (h = 1),
    not with check_order=False or validate=False, and on request on an
    h == 1 curve."""
    calls = []
    monkeypatch.setattr(K, "order_check_mask", lambda c, pub: (
        calls.append(c.name) or np.ones(pub.x.shape[1], bool)))
    for name, kw, runs in (("P-256", {}, False),
                           ("P-256", {"check_order": True}, True),
                           ("WEI25519", {}, True),
                           ("WEI25519", {"check_order": False}, False),
                           ("WEI25519", {"validate": False}, False)):
        c = params.get_curve(name)
        calls.clear()
        kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", [c.gx], [c.gy],
                                             device="cpu", **kw)
        assert kb.n == 1 and calls == ([c.name] if runs else []), (name, kw)
