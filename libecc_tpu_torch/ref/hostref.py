"""Host-side pure-Python reference (test oracle and fixtures only).

Port of ``libecc_tpu/ref/hostref.py`` (its short-Weierstrass and twisted
Edwards parts): independent textbook big-int EC math over Python ints,
used to build the comb tables and the test and bench fixtures, and as the
differential oracle for the batched kernels. It also holds an RFC 8032
Ed25519 signer (pure, ctx and ph) for fixtures on machines without the
JAX package. Nothing here runs on the device.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass(frozen=True)
class WCurve:
    """Short-Weierstrass curve y^2 = x^3 + a x + b over GF(p)."""
    p: int
    a: int
    b: int
    gx: int
    gy: int
    q: int       # generator order
    h: int = 1   # cofactor

    def on_curve(self, P):
        if P is None:
            return True
        x, y = P
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0


def ec_add(c: WCurve, P, Q):
    """Affine addition (None = infinity)."""
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    p = c.p
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + c.a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def ec_mul(c: WCurve, k: int, P):
    """Double-and-add scalar multiplication."""
    R = None
    while k:
        if k & 1:
            R = ec_add(c, R, P)
        P = ec_add(c, P, P)
        k >>= 1
    return R


def ec_neg(c: WCurve, P):
    if P is None:
        return None
    return (P[0], (-P[1]) % c.p)


def trunc_msb_mod_q(digest: bytes, q: int) -> int:
    """ECDSA hash-to-scalar: keep the leftmost min(qbits, hbits) bits of
    the digest, then reduce mod q."""
    v = int.from_bytes(digest, "big")
    hbits = 8 * len(digest)
    if hbits > q.bit_length():
        v >>= hbits - q.bit_length()
    return v % q


def ecdsa_sign_ref(c: WCurve, d: int, e: int, k: int):
    """Raw ECDSA with given truncated-hash int e and nonce k. Returns (r,s)."""
    R = ec_mul(c, k, (c.gx, c.gy))
    r = R[0] % c.q
    if r == 0:
        raise ValueError("r = 0: pick another nonce")
    s = pow(k, -1, c.q) * (e + r * d) % c.q
    if s == 0:
        raise ValueError("s = 0: pick another nonce")
    return r, s


def ecdsa_verify_ref(c: WCurve, Y, e: int, r: int, s: int) -> bool:
    if not (0 < r < c.q and 0 < s < c.q):
        return False
    sinv = pow(s, -1, c.q)
    u = e * sinv % c.q
    v = r * sinv % c.q
    W = ec_add(c, ec_mul(c, u, (c.gx, c.gy)), ec_mul(c, v, Y))
    if W is None:
        return False
    return W[0] % c.q == r


# Twisted Edwards: a x^2 + y^2 = 1 + d x^2 y^2
@dataclass(frozen=True)
class EdCurve:
    p: int
    a: int
    d: int
    gx: int
    gy: int
    q: int
    h: int


def ed_add(c: EdCurve, P, Q):
    """Affine twisted-Edwards addition (complete for a square a and a
    non-square d; the identity is (0, 1))."""
    x1, y1 = P
    x2, y2 = Q
    p = c.p
    den = c.d * x1 * x2 * y1 * y2 % p
    x3 = (x1 * y2 + y1 * x2) * pow(1 + den, -1, p) % p
    y3 = (y1 * y2 - c.a * x1 * x2) * pow(1 - den, -1, p) % p
    return (x3, y3)


def ed_mul(c: EdCurve, k: int, P):
    """Double-and-add scalar multiplication."""
    R = (0, 1)
    while k:
        if k & 1:
            R = ed_add(c, R, P)
        P = ed_add(c, P, P)
        k >>= 1
    return R


# -- RFC 8032 Ed25519 signing (fixtures) --------------------------------------
# The signer multiplies only the base point, by an 8-bit comb over extended
# coordinates (one inversion per product): about a hundred times faster
# than ed_mul, so a fixture of thousands of signatures takes seconds. The
# same comb, made affine, is the device comb table of curves/scalar_mul.py.

_BASE_COMBS: dict = {}


def _ext_add(c: EdCurve, P, Q):
    """Unified extended addition (HWCD 2008, any a)."""
    x1, y1, z1, t1 = P
    x2, y2, z2, t2 = Q
    p = c.p
    a_ = x1 * x2 % p
    b_ = y1 * y2 % p
    c_ = c.d * t1 % p * t2 % p
    d_ = z1 * z2 % p
    e = ((x1 + y1) * (x2 + y2) - a_ - b_) % p
    f, g, h = (d_ - c_) % p, (d_ + c_) % p, (b_ - c.a * a_) % p
    return (e * f % p, g * h % p, f * g % p, e * h % p)


def ed_base_comb(c: EdCurve, nwin: int, w: int):
    """The w-bit comb of the base point in extended coordinates: row j
    holds d * 2^(w j) * B for d = 0..2^w - 1 (built once per curve, nwin
    and w)."""
    comb = _BASE_COMBS.get((c, nwin, w))
    if comb is None:
        comb = []
        base = (c.gx, c.gy, 1, c.gx * c.gy % c.p)
        for _ in range(nwin):
            row = [(0, 1, 1, 0)]
            for _d in range((1 << w) - 1):
                row.append(_ext_add(c, row[-1], base))
            comb.append(row)
            base = _ext_add(c, row[-1], base)          # 2^w * base
        _BASE_COMBS[(c, nwin, w)] = comb
    return comb


def ed_base_mul(c: EdCurve, k: int):
    """k*B for 0 <= k < 2^256, affine."""
    if not 0 <= k < 1 << 256:
        raise ValueError("scalar out of range")
    acc = (0, 1, 1, 0)
    for j, row in enumerate(ed_base_comb(c, 32, 8)):
        acc = _ext_add(c, acc, row[(k >> (8 * j)) & 0xFF])
    zi = pow(acc[2], -1, c.p)
    return (acc[0] * zi % c.p, acc[1] * zi % c.p)


ED25519_DOM = b"SigEd25519 no Ed25519 collisions"
ED25519_VARIANTS = ("ed25519", "ed25519ctx", "ed25519ph")


def ed25519_encode(P) -> bytes:
    """Point -> 32 bytes: y little-endian, the low bit of x in bit 255."""
    x, y = P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def ed25519_dom(variant: str, context: bytes) -> bytes:
    """dom2(phflag, context) framing; empty for pure ed25519 (RFC 8032 5.1)."""
    if variant not in ED25519_VARIANTS:
        raise ValueError(f"unknown Ed25519 variant {variant!r}")
    if variant == "ed25519":
        if context:
            raise ValueError("plain ed25519 takes no context")
        return b""
    if variant == "ed25519ctx" and not context:
        raise ValueError("ed25519ctx requires a context")
    if len(context) > 255:
        raise ValueError("context longer than 255 bytes")
    phflag = 1 if variant == "ed25519ph" else 0
    return ED25519_DOM + bytes([phflag, len(context)]) + context


def _ed25519_expand(c: EdCurve, seed: bytes):
    if len(seed) != 32:
        raise ValueError("Ed25519 seeds are 32 bytes")
    h = hashlib.sha512(seed).digest()
    a = bytearray(h[:32])
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    s = int.from_bytes(bytes(a), "little")
    return s, h[32:], ed25519_encode(ed_base_mul(c, s))


def ed25519_public(c: EdCurve, seed: bytes) -> bytes:
    """Seed -> encoded public key A = s*B."""
    return _ed25519_expand(c, seed)[2]


def ed25519_sign(c: EdCurve, seed: bytes, msg: bytes,
                 variant: str = "ed25519", context: bytes = b""):
    """RFC 8032 5.1.6 signing -> (public key bytes, 64-byte signature)."""
    dom = ed25519_dom(variant, context)
    if variant == "ed25519ph":
        msg = hashlib.sha512(msg).digest()
    s, prefix, enc_a = _ed25519_expand(c, seed)
    r = int.from_bytes(hashlib.sha512(dom + prefix + msg).digest(),
                       "little") % c.q
    enc_r = ed25519_encode(ed_base_mul(c, r))
    k = int.from_bytes(hashlib.sha512(dom + enc_r + enc_a + msg).digest(),
                       "little") % c.q
    return enc_a, enc_r + ((r + k * s) % c.q).to_bytes(32, "little")
