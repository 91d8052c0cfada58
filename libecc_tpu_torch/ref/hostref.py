"""Host-side pure-Python reference (test oracle and fixtures only).

Port of ``libecc_tpu/ref/hostref.py`` (its short-Weierstrass and twisted
Edwards parts): independent textbook big-int EC math over Python ints,
used to build the comb tables and the test and bench fixtures, and as the
differential oracle for the batched kernels. It also holds RFC 8032
Ed25519 (pure, ctx, ph) and Ed448 (pure, ph) signers, an EC-FSDSA signer
and a BIP-340 signer (nonce and auxiliary bytes injected) for fixtures on
machines without the JAX package. Nothing here runs on the device.
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


def sqrt_mod(v: int, p: int):
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


def ec_small_order_point(c: WCurve, x0: int = 2):
    """A point T != None whose order divides the cofactor h (h > 1): q
    times the first curve point with x >= x0 whose q-multiple is not the
    identity."""
    x = x0
    while True:
        y = sqrt_mod(x ** 3 + c.a * x + c.b, c.p)
        if y is not None:
            T = ec_mul(c, c.q, (x, y))
            if T is not None:
                return T
        x += 1


def ec_order2_point(c: WCurve):
    """The point (x, 0) of order 2 of a curve whose h is a power of two
    with such a point: ec_small_order_point doubled while that leaves the
    identity."""
    T = ec_small_order_point(c)
    while ec_add(c, T, T) is not None:
        T = ec_add(c, T, T)
    assert T[1] == 0
    return T


def window_edge_scalars(q: int, w: int = 4) -> list[int]:
    """Scalars that drive a w-bit fixed-window multiply of a point of order
    q through the complete add's edge cases in its last window: 0 (every
    add is T + O), q (the last add is -T + T, the result the identity) and
    q + 2d with d = -q mod 2^w (the accumulator before the last add is
    d*P, the entry d*P: T + T); then 1 and q - 1."""
    d = (-q) % (1 << w)
    return [0, q, q + 2 * d, 1, q - 1]


# -- fixed-base multiplication by a comb (fixtures) ----------------------------
# An 8-bit comb of affine multiples of G and Jacobian accumulation: one
# inversion per product instead of one per group operation, so a fixture
# of thousands of signatures takes seconds. The same comb is the device
# comb table of curves/scalar_mul.py.

_W_COMBS: dict = {}


def ec_base_comb(c: WCurve, nwin: int, w: int):
    """The w-bit comb of G, affine: row j holds d * 2^(w j) * G for
    d = 0..2^w - 1 (None at d = 0); built once per curve, nwin and w."""
    comb = _W_COMBS.get((c, nwin, w))
    if comb is None:
        comb = []
        base = (c.gx, c.gy)
        for _ in range(nwin):
            row = [None]
            for _d in range((1 << w) - 1):
                row.append(ec_add(c, row[-1], base))
            comb.append(row)
            base = ec_add(c, row[-1], base)            # 2^w * base
        _W_COMBS[(c, nwin, w)] = comb
    return comb


def _jac_dbl(c: WCurve, P):
    X, Y, Z = P
    p = c.p
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    yy = Y * Y % p
    s = 4 * X * yy % p
    zz = Z * Z % p
    m = (3 * X * X + c.a * zz * zz) % p
    X3 = (m * m - 2 * s) % p
    return (X3, (m * (s - X3) - 8 * yy * yy) % p, 2 * Y * Z % p)


def _jac_add_affine(c: WCurve, P, Q):
    """Jacobian P (Z = 0: the identity) + affine Q (None: the identity)."""
    if Q is None:
        return P
    X1, Y1, Z1 = P
    if Z1 == 0:
        return (Q[0], Q[1], 1)
    p = c.p
    zz = Z1 * Z1 % p
    h = (Q[0] * zz - X1) % p
    r = (Q[1] * zz * Z1 - Y1) % p
    if h == 0:
        return _jac_dbl(c, P) if r == 0 else (1, 1, 0)
    hh = h * h % p
    hhh = h * hh % p
    v = X1 * hh % p
    X3 = (r * r - hhh - 2 * v) % p
    return (X3, (r * (v - X3) - Y1 * hhh) % p, Z1 * h % p)


def ec_base_mul(c: WCurve, k: int):
    """k*G (None for the identity) for 0 <= k < 2^(8 ceil(qbits / 8))."""
    nwin = -(-c.q.bit_length() // 8)
    if not 0 <= k < 1 << (8 * nwin):
        raise ValueError("scalar out of range")
    acc = (1, 1, 0)
    for j, row in enumerate(ec_base_comb(c, nwin, 8)):
        acc = _jac_add_affine(c, acc, row[(k >> (8 * j)) & 0xFF])
    X, Y, Z = acc
    if Z == 0:
        return None
    zi = pow(Z, -1, c.p)
    zi2 = zi * zi % c.p
    return (X * zi2 % c.p, Y * zi2 * zi % c.p)


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
    R = ec_base_mul(c, k)
    r = R[0] % c.q
    if r == 0:
        raise ValueError("r = 0: pick another nonce")
    s = pow(k, -1, c.q) * (e + r * d) % c.q
    if s == 0:
        raise ValueError("s = 0: pick another nonce")
    return r, s


def _sha2(hash_name: str):
    return lambda data=b"": hashlib.new(
        hash_name.replace("-", "").lower(), data)


def _field_len(n: int) -> int:
    return (n.bit_length() + 7) // 8


def ecfsdsa_sign_ref(c: WCurve, d: int, k: int, msg: bytes,
                     hash_name: str = "SHA256") -> bytes:
    """EC-FSDSA (ISO 14888-3) signing with an injected nonce k: W = k*G,
    r = FE2OS(Wx) || FE2OS(Wy), e = OS2I(H(r || m)) mod q,
    s = (k + e d) mod q; returns r || s."""
    W = ec_base_mul(c, k)
    if W is None:
        raise ValueError("k*G is the identity: pick another nonce")
    p_len = _field_len(c.p)
    r = W[0].to_bytes(p_len, "big") + W[1].to_bytes(p_len, "big")
    e = int.from_bytes(_sha2(hash_name)(r + msg).digest(), "big") % c.q
    return r + ((k + e * d) % c.q).to_bytes(_field_len(c.q), "big")


def bip0340_tagged_hash(hash_name: str, tag: bytes, *chunks: bytes) -> bytes:
    """H(H(tag) || H(tag) || chunks...)."""
    alg = _sha2(hash_name)
    th = alg(tag).digest()
    return alg(th + th + b"".join(chunks)).digest()


def bip0340_sign_ref(c: WCurve, d: int, msg: bytes, aux: bytes,
                     hash_name: str = "SHA256") -> bytes:
    """BIP-340 signing with injected auxiliary bytes: d' = d or q - d so
    that d'*G has even y; t = d' XOR H_aux(aux); k0 = H_nonce(t || Px ||
    m) mod q; R = k0*G, k = k0 or q - k0 so that R has even y;
    e = H_challenge(Rx || Px || m) mod q; returns Rx || (k + e d') mod q.
    The reference's form for any (curve, hash): t keeps d''s bytes beyond
    the digest length."""
    p, q = c.p, c.q
    p_len, q_len = _field_len(p), _field_len(q)
    Y = ec_base_mul(c, d)
    dp = d if Y[1] % 2 == 0 else (q - d) % q
    ah = bip0340_tagged_hash(hash_name, b"BIP0340/aux", aux)
    dp_b = dp.to_bytes(q_len, "big")
    t = bytes(x ^ y for x, y in zip(dp_b, ah)) + dp_b[len(ah):]
    px = Y[0].to_bytes(p_len, "big")
    k0 = int.from_bytes(bip0340_tagged_hash(hash_name, b"BIP0340/nonce", t,
                                            px, msg), "big") % q
    if k0 == 0:
        raise ValueError("BIP-340 nonce is 0: pick other auxiliary bytes")
    R = ec_base_mul(c, k0)
    k = k0 if R[1] % 2 == 0 else q - k0
    rx = R[0].to_bytes(p_len, "big")
    e = int.from_bytes(bip0340_tagged_hash(hash_name, b"BIP0340/challenge",
                                           rx, px, msg), "big") % q
    return rx + ((k + e * dp) % q).to_bytes(q_len, "big")


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
    """k*B for 0 <= k < 2^(8 ceil(pbits / 8)) (2^256 on Ed25519, 2^448 on
    Ed448: every RFC 8032 secret scalar), affine."""
    nwin = -(-c.p.bit_length() // 8)
    if not 0 <= k < 1 << (8 * nwin):
        raise ValueError("scalar out of range")
    acc = (0, 1, 1, 0)
    for j, row in enumerate(ed_base_comb(c, nwin, 8)):
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


# -- RFC 8032 Ed448 signing (fixtures) ----------------------------------------
# The same comb (56 windows of 8 bits), SHAKE256 from hashlib, dom4 framing
# on every variant (RFC 8032 5.2).

ED448_DOM = b"SigEd448"
ED448_VARIANTS = ("ed448", "ed448ph")


def ed448_encode(P) -> bytes:
    """Point -> 57 bytes: y little-endian, the low bit of x in bit 455."""
    x, y = P
    return (y | ((x & 1) << 455)).to_bytes(57, "little")


def _shake256(data: bytes, n: int = 114) -> bytes:
    return hashlib.shake_256(data).digest(n)


def ed448_dom(variant: str, context: bytes) -> bytes:
    """dom4(phflag, context) (RFC 8032 5.2): present on both variants, the
    context may be empty."""
    if variant not in ED448_VARIANTS:
        raise ValueError(f"unknown Ed448 variant {variant!r}")
    if len(context) > 255:
        raise ValueError("context longer than 255 bytes")
    phflag = 1 if variant == "ed448ph" else 0
    return ED448_DOM + bytes([phflag, len(context)]) + context


def _ed448_expand(c: EdCurve, seed: bytes):
    if len(seed) != 57:
        raise ValueError("Ed448 seeds are 57 bytes")
    h = _shake256(seed)
    a = bytearray(h[:57])
    a[0] &= 252
    a[55] |= 128
    a[56] = 0
    s = int.from_bytes(bytes(a), "little")
    return s, h[57:], ed448_encode(ed_base_mul(c, s))


def ed448_public(c: EdCurve, seed: bytes) -> bytes:
    """Seed -> encoded public key A = s*B."""
    return _ed448_expand(c, seed)[2]


def ed448_sign(c: EdCurve, seed: bytes, msg: bytes, variant: str = "ed448",
               context: bytes = b""):
    """RFC 8032 5.2.6 signing -> (public key bytes, 114-byte signature).
    ed448ph signs PH(M) = SHAKE256(M, 64)."""
    dom = ed448_dom(variant, context)
    if variant == "ed448ph":
        msg = _shake256(msg, 64)
    s, prefix, enc_a = _ed448_expand(c, seed)
    r = int.from_bytes(_shake256(dom + prefix + msg), "little") % c.q
    enc_r = ed448_encode(ed_base_mul(c, r))
    k = int.from_bytes(_shake256(dom + enc_r + enc_a + msg), "little") % c.q
    return enc_a, enc_r + ((r + k * s) % c.q).to_bytes(57, "little")
