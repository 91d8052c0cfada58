"""Batch signature verification: ONE accept or reject for a whole batch.

Port of ``libecc_tpu/sig/batch_verify.py`` (the reference library's
Bos-Coster batch verify, for the schemes whose signature carries a
recoverable commitment point R: ECFSDSA, EdDSA, BIP0340). With the
per-signature equation s_i*G == R_i + e_i*Y_i and random 128-bit z_i, the
batch accepts iff

    (sum_i z_i s_i) * G  ==  sum_i ( z_i*R_i + (z_i e_i)*Y_i ).

The left side is one comb multiply (kernel 2 or 8a) on one lane; the right
side is the lane-batched Straus dual multiply (kernel 6 or 6-ed) followed
by a log2(N) lane-tree point sum (kernel 2 or 8a). The two points are
compared projectively (no inversion). Forging acceptance means guessing
the z_i (2^-128), so ``rng`` must be unpredictable: it defaults to
``os.urandom`` and is injected only by tests.

The per-signature parsing, range checks and challenge hashes run on the
host (hashlib: the SHA-2 and SHA-3 names, and SHA-512 or SHAKE256 for
EdDSA), as in the reference. The card runs every curve whose (K, a) has
kernel 6 or 6-ed (``ops/cuda/megamul.py``): ECFSDSA on every
short-Weierstrass curve of the registry, K = 6 to 17 (P-192 to P-521, the
Brainpool, SM2, BIGN and GOST curves, secp192k1, secp224k1, whose
signatures are 28 + 28 + 29 bytes, and the cofactor > 1 curves WEI25519
and WEI448, whose keys come through the q*P check of
``keys.pubkey_batch_from_affine_ints``), BIP0340 on secp256k1, Ed25519
and Ed448. Every entry point runs on the card unless ``device="cpu"`` is
passed, and returns a Python bool.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from .. import stages
from ..config import resolve_device
from ..curves import edwards as ed
from ..curves import scalar_mul
from ..curves.edwards import ExtPoint
from ..curves.shortw import y_from_x
from ..fp import field as fp
from ..nn import core as nn
from . import eddsa as ed_mod
from .bip0340 import tagged_hash
from .common import hash_key
from .keys import pubkey_batch_from_affine_ints

Z_BITS = 128

_HOST_HASHES = {"SHA224": hashlib.sha224, "SHA256": hashlib.sha256,
                "SHA384": hashlib.sha384, "SHA512": hashlib.sha512,
                "SHA3224": hashlib.sha3_224, "SHA3256": hashlib.sha3_256,
                "SHA3384": hashlib.sha3_384, "SHA3512": hashlib.sha3_512}


def _host_hash(hash_name: str):
    """The hashlib constructor of a SHA-2 or SHA-3 name, without regard to
    case, dashes or underscores ("SHA-256", "SHA_256", "sha3_256"); other
    hashes raise."""
    alg = _HOST_HASHES.get(hash_key(hash_name))
    if alg is None:
        raise NotImplementedError(
            f"batch verification: hash {hash_name!r} is not ported yet "
            "(ROADMAP queue 1 item 6, the hash layer); the SHA-2 and SHA-3 "
            "hashes are")
    return alg


def _rand_zs(n: int, rng=None) -> list[int]:
    """n odd random Z_BITS-bit multipliers from rng(nbytes) -> bytes."""
    rng = rng or os.urandom
    return [int.from_bytes(rng(Z_BITS // 8), "big") | 1 for _ in range(n)]


def _scalars(q_ctx, ints, device) -> torch.Tensor:
    return nn.upload(nn.batch_to_limbs([v % q_ctx.p_int for v in ints],
                                       q_ctx.k), device)


def point_tree_reduce(curve, P):
    """Lane-tree point sum: a batch of N points (coordinates int32[K, N])
    -> one point (int32[K, 1]) in ceil(log2 N) rounds of one batched add;
    an odd width is padded with one identity lane."""
    cls = type(P)
    arr = torch.stack(list(P))                     # (ncoord, K, N)
    while arr.shape[-1] > 1:
        if arr.shape[-1] % 2 == 1:
            pad = curve.pinf(batch_shape=(1,), device=arr.device)
            arr = torch.cat([arr, torch.stack(list(pad))], -1)
        a = cls(*arr[..., 0::2].contiguous())
        b = cls(*arr[..., 1::2].contiguous())
        arr = torch.stack(list(curve.padd(a, b)))
    return cls(*arr)


def _combined_sides(curve, zs, e2, Y, R, c_int: int):
    """The check's two sides: (c*G, sum_i (z_i*R_i + e2_i*Y_i)), one lane
    each. zs, e2: canonical scalar limbs int32[Kq, N]; Y, R: point
    batches; c_int: the host scalar of the collapsed fixed-base term."""
    rhs_lanes = scalar_mul.straus_double_mul_public_w4(curve, zs, R, e2, Y)
    stages.mark("straus", rhs_lanes)
    rhs = point_tree_reduce(curve, rhs_lanes)
    stages.mark("reduce", rhs)
    lhs = scalar_mul.fixed_base_mul(curve, _scalars(curve.q_ctx, [c_int],
                                                    zs.device))
    stages.mark("comb", lhs)
    return lhs, rhs


def _combined_check(curve, zs, e2, Y, R, c_int: int):
    """Device core: accept iff c*G == sum_i (z_i*R_i + e2_i*Y_i), compared
    as x/z and y/z by cross-multiplication (both point models). Returns a
    bool tensor of one lane."""
    lhs, rhs = _combined_sides(curve, zs, e2, Y, R, c_int)
    ctx = curve.fp_ctx
    ex = fp.eq_mask(fp.mul(lhs.x, rhs.z, ctx), fp.mul(rhs.x, lhs.z, ctx))
    ey = fp.eq_mask(fp.mul(lhs.y, rhs.z, ctx), fp.mul(rhs.y, lhs.z, ctx))
    acc = ex & ey
    stages.mark("accept", acc)
    return acc


def ecfsdsa_verify_batch(keys, msgs, sigs, hash_name="SHA256", rng=None,
                         device=None) -> bool:
    """EC-FSDSA batch verify (signature r || s with r = Rx || Ry, e =
    H(r || m) mod q). Returns one bool."""
    dev = resolve_device(device)
    curve, q = keys.curve, keys.curve.q
    p = curve.fp_ctx.p_int
    alg = _host_hash(hash_name)
    p_len = (curve.fp_ctx.bits + 7) // 8
    nb = (q.bit_length() + 7) // 8
    n = len(sigs)
    zs = _rand_zs(n, rng)
    rx, ry, e2, c = [], [], [], 0
    for i, (m, sg) in enumerate(zip(msgs, sigs)):
        if len(sg) != 2 * p_len + nb:
            return False
        r = sg[:2 * p_len]
        s = int.from_bytes(sg[2 * p_len:], "big")
        x_i = int.from_bytes(r[:p_len], "big")
        y_i = int.from_bytes(r[p_len:], "big")
        if not (0 < s < q and x_i < p and y_i < p):
            return False
        e = int.from_bytes(alg(r + m).digest(), "big") % q
        rx.append(x_i)
        ry.append(y_i)
        e2.append(zs[i] * e % q)
        c = (c + zs[i] * s) % q
    stages.mark("parse", zs, e2, c)
    R = curve.point_from_affine_ints(rx, ry, dev)
    stages.mark("lift", R)
    Y = type(keys.pub)(*[t.to(dev) for t in keys.pub])
    acc = _combined_check(curve, _scalars(curve.q_ctx, zs, dev),
                          _scalars(curve.q_ctx, e2, dev), Y, R, c)
    return bool(acc.all())


def bip0340_verify_batch(keys, msgs, sigs, hash_name="SHA256", rng=None,
                         device=None) -> bool:
    """BIP-340 batch verify (signature Rx || s; R and the keys taken with
    even y). Returns one bool."""
    dev = resolve_device(device)
    curve, q = keys.curve, keys.curve.q
    ctx = curve.fp_ctx
    p = ctx.p_int
    alg = _host_hash(hash_name)
    p_len = (ctx.bits + 7) // 8
    q_len = (q.bit_length() + 7) // 8
    n = len(sigs)
    xs_pub, ys_pub, _ = keys.pub_affine_ints()
    stages.mark("keys", xs_pub, ys_pub)
    zs = _rand_zs(n, rng)
    rxs, e2, c = [], [], 0
    for i, (m, sg) in enumerate(zip(msgs, sigs)):
        if len(sg) != p_len + q_len:
            return False
        r = int.from_bytes(sg[:p_len], "big")
        s = int.from_bytes(sg[p_len:], "big")
        if not (r < p and 0 < s < q):
            return False
        e = int.from_bytes(
            tagged_hash(alg, b"BIP0340/challenge", r.to_bytes(p_len, "big"),
                        xs_pub[i].to_bytes(p_len, "big"), m), "big") % q
        rxs.append(r)
        e2.append(zs[i] * e % q)
        c = (c + zs[i] * s) % q
    stages.mark("parse", zs, e2, c)
    # lift_x: the candidate y of each R_i on the device (one square-root
    # ladder); the even root is chosen on the host
    ry, exists = y_from_x(curve, ctx.from_ints(rxs, dev))
    if not bool(exists.all()):
        return False
    ry_ints = nn.batch_from_limbs(fp.from_mont(ry, ctx))
    ry_even = [y if y % 2 == 0 else p - y for y in ry_ints]
    R = curve.point_from_affine_ints(rxs, ry_even, dev)
    ys_even = [y if y % 2 == 0 else p - y for y in ys_pub]
    pub_even = pubkey_batch_from_affine_ints(curve, "BIP0340", list(xs_pub),
                                             ys_even, device=dev)
    stages.mark("lift", R, pub_even.pub)
    acc = _combined_check(curve, _scalars(curve.q_ctx, zs, dev),
                          _scalars(curve.q_ctx, e2, dev), pub_even.pub, R, c)
    return bool(acc.all())


def eddsa_verify_batch(variant, pub_keys, msgs, sigs, context: bytes = b"",
                       rng=None, device=None) -> bool:
    """EdDSA batch verify (RFC 8032 ed25519, ed25519ctx, ed25519ph, ed448,
    ed448ph). A and R are decoded as one batch of 2N lanes. Returns one
    bool."""
    dev = resolve_device(device)
    v = ed_mod.get_variant(variant)
    c_curve = ed.get_edwards_curve(v.curve_name)
    q, p = c_curve.q, c_curve.fp_ctx.p_int
    pre = ed_mod._dom(v, context)
    msgs_ph = [ed_mod._prehash(v, m) for m in msgs]
    n = len(sigs)
    el = v.enc_len
    ymask = (1 << v.sign_bit) - 1
    zs = _rand_zs(n, rng)
    ay, asign, ry, rsign, e2, c = [], [], [], [], [], 0
    for i in range(n):
        sig = sigs[i]
        if len(sig) != 2 * el or len(pub_keys[i]) != el:
            return False
        encR, encS = sig[:el], sig[el:]
        a_int = int.from_bytes(pub_keys[i], "little")
        r_int = int.from_bytes(encR, "little")
        s_int = int.from_bytes(encS, "little")
        if s_int >= q:
            return False
        if (a_int & ~(ymask | (1 << v.sign_bit))) or \
           (r_int & ~(ymask | (1 << v.sign_bit))):
            return False
        # y >= p does not decode (the reference's decode_core rejects it);
        # Ed448's 455 bits of y would not fit the K = 14 limbs either
        if (a_int & ymask) >= p or (r_int & ymask) >= p:
            return False
        k = ed_mod._le_mod_q(
            ed_mod._xof(v, pre, encR, pub_keys[i], msgs_ph[i]), q)
        ay.append(a_int & ymask)
        asign.append((a_int >> v.sign_bit) & 1)
        ry.append(r_int & ymask)
        rsign.append((r_int >> v.sign_bit) & 1)
        e2.append(zs[i] * k % q)
        c = (c + zs[i] * s_int) % q
    stages.mark("parse", zs, e2, c)
    kk = c_curve.fp_ctx.k
    P, ok = ed_mod.decode_core(
        c_curve, nn.upload(nn.batch_to_limbs(ay + ry, kk), dev),
        nn.upload(np.array(asign + rsign, np.int32), dev))
    stages.mark("decode", P, ok)
    if not bool(ok.all()):
        return False
    A = ExtPoint(*[t[:, :n].contiguous() for t in P])
    R = ExtPoint(*[t[:, n:].contiguous() for t in P])
    acc = _combined_check(c_curve, _scalars(c_curve.q_ctx, zs, dev),
                          _scalars(c_curve.q_ctx, e2, dev), A, R, c)
    return bool(acc.all())


def unsupported_verify_batch(*a, **kw):
    """Schemes without a recoverable R register this."""
    raise NotImplementedError(
        "batch verification requires a signature scheme with a recoverable "
        "commitment point (ECFSDSA, EdDSA, BIP0340)")
