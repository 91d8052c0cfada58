"""Batched EdDSA verification (RFC 8032 ed25519, ed25519ctx, ed25519ph,
ed448, ed448ph).

Port of the verify side of ``libecc_tpu/sig/eddsa.py``: the variant table,
``_dom`` / ``_prehash`` / ``check_context_rules``, ``decode_core`` (:131),
``verify_core`` (:180), ``parse_verify_inputs`` (:374),
``verify_with_challenges`` (:406) and ``verify_batch`` (:345).

Verify: accept iff S < q, A and R decode, and S*B + k*(-A) == R with
k = H(dom || R || A || PH(M)) mod q, compared projectively (no
inversion). Ed25519: H = SHA-512, dom2, 32-byte encodings with the sign
of x in bit 255, K = 8. Ed448: H = SHAKE256 at 114 bytes, dom4 always,
57-byte encodings with the sign in bit 455, K = 14 (the K = 14 kernels).
The byte-level work (framing, PH(M), challenge digests reduced mod q on
host integers) runs on the host; the hashing and all group arithmetic run
as batches on the device. Signing is not ported yet.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import stages
from ..config import resolve_device
from ..nn import core as nn
from ..fp import field as fp
from ..curves import edwards as ed
from ..curves import scalar_mul
from ..curves.edwards import EdwardsCurve, ExtPoint
from . import common


@dataclass(frozen=True)
class Variant:
    name: str
    curve_name: str
    hash_name: str
    enc_len: int          # point/scalar wire length
    sign_bit: int         # bit index of the x-sign bit in the encoding
    phflag: int           # 0 = pure, 1 = pre-hashed
    always_dom: bool      # ed448 always frames with dom4
    dom_tag: bytes


VARIANTS = {
    "ed25519": Variant("ed25519", "ED25519", "SHA512", 32, 255, 0,
                       False, b"SigEd25519 no Ed25519 collisions"),
    "ed25519ctx": Variant("ed25519ctx", "ED25519", "SHA512", 32, 255, 0,
                          False, b"SigEd25519 no Ed25519 collisions"),
    "ed25519ph": Variant("ed25519ph", "ED25519", "SHA512", 32, 255, 1,
                         False, b"SigEd25519 no Ed25519 collisions"),
    "ed448": Variant("ed448", "ED448", "SHAKE256", 57, 455, 0,
                     True, b"SigEd448"),
    "ed448ph": Variant("ed448ph", "ED448", "SHAKE256", 57, 455, 1,
                       True, b"SigEd448"),
}


def get_variant(name: str) -> Variant:
    v = VARIANTS.get(name.lower())
    if v is None:
        raise ValueError(f"unknown EdDSA variant {name!r}")
    return v


def _dom(v: Variant, context: bytes) -> bytes:
    """dom2/dom4 framing (RFC 8032 section 2)."""
    if not v.always_dom and v.phflag == 0 and not context:
        return b""
    return v.dom_tag + bytes([v.phflag]) + bytes([len(context)]) + context


def _prehash(v: Variant, m: bytes) -> bytes:
    """PH(M): M itself, SHA-512(M) for ed25519ph, SHAKE256(M, 64) for
    ed448ph (host code, as in the reference)."""
    if v.phflag == 0:
        return m
    if v.hash_name == "SHAKE256":
        return hashlib.shake_256(m).digest(64)
    return hashlib.sha512(m).digest()


def _xof(v: Variant, *chunks: bytes) -> bytes:
    """H(chunks...) on the host: SHA-512 (64 bytes) for the Ed25519
    variants, SHAKE256 at 114 bytes for Ed448 and Ed448ph (the
    reference's ``_xof``)."""
    data = b"".join(chunks)
    if v.hash_name == "SHAKE256":
        return hashlib.shake_256(data).digest(2 * v.enc_len)
    return hashlib.sha512(data).digest()


def _le_mod_q(b: bytes, q: int) -> int:
    return int.from_bytes(b, "little") % q


def check_context_rules(v: Variant, context: bytes) -> None:
    if v.name == "ed25519" and context:
        raise ValueError("plain ed25519 takes no context")
    if v.name == "ed25519ctx" and not context:
        raise ValueError("ed25519ctx requires context")


# ---------------------------------------------------------------------------
# Device cores
# ---------------------------------------------------------------------------

def decode_core(c: EdwardsCurve, y_limbs, sign):
    """Batched point decode from (y, sign): x = sqrt((y^2 - 1)/(d y^2 - a)).
    y_limbs: int32[K, N] plain limbs (below 2^(32K), not yet
    range-checked);
    sign: int32[N] in {0, 1}. Returns (point, ok mask): ok is False where
    y >= p, where x has no root, and where x = 0 with the sign bit set."""
    ctx = c.fp_ctx
    y_ok = nn.lt_mask(y_limbs, ctx.col(ctx.p_int, y_limbs.device))
    ym = fp.to_mont(y_limbs, ctx)
    one = ctx.one(like=ym)
    y2 = fp.sqr(ym, ctx)
    num = fp.sub(y2, one, ctx)
    den = fp.sub(fp.mul(ctx.const(c.d, like=ym), y2, ctx),
                 ctx.const(c.a, like=ym), ctx)
    x2 = fp.mul(num, fp.inv(den, ctx), ctx)
    x, has_root = fp.sqrt(x2, ctx)
    x_plain = fp.from_mont(x, ctx)
    x = fp.select((x_plain[0] & 1) != sign, fp.neg(x, ctx), x)
    x_is_zero = nn.is_zero_mask(x_plain)
    ok = y_ok & has_root & ~(x_is_zero & (sign == 1))
    return ExtPoint(x, ym, one.contiguous(), fp.mul(x, ym, ctx)), ok


def verify_core(c: EdwardsCurve, ay, asign, ry, rsign, S, k):
    """Batched verify: S*B == R + k*A  <=>  S*B + k*(-A) == R, compared as
    cross-multiplied projective coordinates. ay, ry: int32[K, N] plain
    y limbs; asign, rsign: int32[N]; S (as received, below 2^(32Kq)) and k
    (< q): int32[Kq, N]. Returns the accept mask.

    A and R are decoded as ONE batch of 2N lanes: the same values as two
    decodes, with half the launches (the inversion and square-root ladders
    are about a thousand Montgomery products whatever the width)."""
    ctx, q_ctx = c.fp_ctx, c.q_ctx
    n = ay.shape[1]
    P, ok = decode_core(c, torch.cat([ay, ry], 1), torch.cat([asign, rsign]))
    stages.mark("decode", P, ok)
    A = ExtPoint(*[t[:, :n].contiguous() for t in P])
    R = ExtPoint(*[t[:, n:].contiguous() for t in P])
    s_ok = nn.lt_mask(S, q_ctx.col(c.q, S.device))
    W = scalar_mul.fixed_base_double_mul_public(c, S, k, ed.point_neg(c, A))
    eqm = (fp.eq_mask(fp.mul(W.x, R.z, ctx), fp.mul(R.x, W.z, ctx))
           & fp.eq_mask(fp.mul(W.y, R.z, ctx), fp.mul(R.y, W.z, ctx)))
    acc = ok[:n] & ok[n:] & s_ok & eqm
    stages.mark("accept", acc)
    return acc


# ---------------------------------------------------------------------------
# User API: wire bytes in, accept mask out
# ---------------------------------------------------------------------------

def parse_verify_inputs(c: EdwardsCurve, v: Variant, pub_keys, sigs):
    """Split wire public keys and signatures into batched verify inputs:
    a dict of host arrays (y limbs np.uint32[K, N], signs np.int32[N], S
    limbs, the pre-check mask) and the encoded R and A bytes that the
    challenge hashes. A lane whose key or signature has the wrong length
    is rejected (``pre_ok`` False) and carries zeros.

    Each encoding is padded to a whole number of 32-bit words before the
    word view (Ed448's 57 bytes are 15 words; byte 56 holds the sign in
    bit 455 and y's bits 448-454). Where y or S does not fit the K limbs
    the port holds (y >= 2^448 or S >= 2^448 on Ed448), the value is at
    least p or q, which the reference rejects (y >= p, S >= q): such a
    lane is rejected here (``pre_ok`` False), never truncated. On Ed25519
    the 256 bits of an encoding are 255 bits of y and the sign, so no high
    bit can be out of range."""
    el = v.enc_len
    n = len(sigs)
    pre_ok = np.array([len(s) == 2 * el and len(pk) == el
                       for s, pk in zip(sigs, pub_keys)], bool)
    sig_b = b"".join(s if o else bytes(2 * el) for s, o in zip(sigs, pre_ok))
    pub_b = b"".join(pk if o else bytes(el)
                     for pk, o in zip(pub_keys, pre_ok))
    nw = -(-el // 4)
    pad = 4 * nw - el

    def words(buf, parts):
        """parts encodings of el bytes per lane -> LE words [parts*nw, N]."""
        b = np.frombuffer(buf, np.uint8).reshape(n * parts, el)
        b = np.concatenate([b, np.zeros((n * parts, pad), np.uint8)], 1)
        return b.view("<u4").reshape(n, parts * nw).T

    sw, pw = words(sig_b, 2), words(pub_b, 1)
    word, bit = divmod(v.sign_bit, 32)
    k, kq = c.fp_ctx.k, c.q_ctx.k

    def y_and_sign(w):
        y = np.array(w, np.uint32)
        y[word] &= np.uint32(~(1 << bit) & 0xFFFFFFFF)
        fits = ~y[k:].any(0)
        return np.ascontiguousarray(y[:k]), ((w[word] >> bit) & 1).astype(
            np.int32), fits

    ay, asign, a_fits = y_and_sign(pw)
    ry, rsign, r_fits = y_and_sign(sw[:nw])
    S = sw[nw:]
    pre_ok &= a_fits & r_fits & ~S[kq:].any(0)
    return {"ay": ay, "asign": asign, "ry": ry, "rsign": rsign,
            "S": np.ascontiguousarray(S[:kq]), "pre_ok": pre_ok,
            "enc_R": [sig_b[2 * el * i:2 * el * i + el] for i in range(n)],
            "pubs": [pub_b[el * i:el * (i + 1)] for i in range(n)]}


def verify_with_challenges(c: EdwardsCurve, parsed, k_l: list[int],
                           device="cuda") -> np.ndarray:
    """Run the batched device verify given the per-lane challenge scalars
    k = H(dom || R || A || PH(M)) mod q. Returns an np.bool accept mask."""
    dev = resolve_device(device)
    args = [nn.upload(parsed[key], dev)
            for key in ("ay", "asign", "ry", "rsign", "S")]
    k = nn.upload(nn.batch_to_limbs(k_l, c.q_ctx.k), dev)
    acc = verify_core(c, *args, k).cpu().numpy()
    return acc & parsed["pre_ok"]


def verify_batch(variant_or_curve, pub_keys: list[bytes], msgs: list[bytes],
                 sigs: list[bytes], variant=None, context: bytes = b"",
                 device="cuda") -> np.ndarray:
    """Batched EdDSA verification -> np.bool accept mask. The first
    argument is a variant name ("ed25519", "ed25519ctx", "ed25519ph",
    "ed448", "ed448ph") or an Edwards curve (then pure ed25519 or ed448
    unless ``variant`` is given)."""
    if isinstance(variant_or_curve, str) and variant is None:
        variant, variant_or_curve = variant_or_curve, None
    if variant is not None:
        v = get_variant(variant)
    elif isinstance(variant_or_curve, EdwardsCurve):
        v = VARIANTS["ed25519" if variant_or_curve.name == "ED25519"
                     else "ed448"]
    else:
        raise ValueError("pass a variant name or curve")
    if not len(pub_keys) == len(msgs) == len(sigs):
        raise ValueError("pub_keys, msgs and sigs differ in length")
    dev = resolve_device(device)
    c = ed.get_edwards_curve(v.curve_name)
    check_context_rules(v, context)
    if not sigs:
        return np.zeros(0, bool)
    pre = _dom(v, context)
    parsed = parse_verify_inputs(c, v, pub_keys, sigs)
    stages.mark("parse", parsed)
    bufs = [pre + r + a + _prehash(v, m)
            for r, a, m in zip(parsed["enc_R"], parsed["pubs"], msgs)]
    k_l = [_le_mod_q(d, c.q)
           for d in common.batch_digests(v.hash_name, bufs, dev)]
    stages.mark("challenge", k_l)
    return verify_with_challenges(c, parsed, k_l, dev)
