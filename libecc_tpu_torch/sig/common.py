"""Shared signature-layer plumbing: hashing to scalars and mod-q arithmetic.

Port of the verify-side helpers of ``libecc_tpu/sig/common.py``. Scalars
are canonical plain-domain ``int32[Kq, N]`` limbs; every mod-q product goes
through kernel 1 with q's constants (one binary serves p and q).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..nn import core as nn
from ..fp import field as fp
from ..fp.field import FpCtx
from ..hash import sha2, sha3
from ..ops.cuda import mont


def digests_to_words(digs: list[bytes]) -> np.ndarray:
    """Raw digests -> big-endian np.uint32 words [W, N] (zero-padded to a
    whole word)."""
    dlen = len(digs[0])
    pad = (-dlen) % 4
    arr = np.frombuffer(b"".join(d + b"\x00" * pad for d in digs),
                        dtype=">u4")
    return np.ascontiguousarray(arr.reshape(len(digs), -1).T).astype(
        np.uint32)


class Hasher(NamedTuple):
    """A hash that the signature layer computes on the device: the padded
    block count of a message length, the host packer, the tensor function
    (packed blocks -> big-endian digest words) and the digest bytes."""
    nblocks: Callable[[int], int]
    pack: Callable
    device: Callable
    digest_bytes: int


_SHA2 = {
    "SHA224": Hasher(sha2.nblocks_sha256, sha2.pack_blocks_sha256,
                     sha2.sha224_device, 28),
    "SHA256": Hasher(sha2.nblocks_sha256, sha2.pack_blocks_sha256,
                     sha2.sha256_device, 32),
    "SHA384": Hasher(sha2.nblocks_sha512, sha2.pack_blocks_sha512,
                     sha2.sha384_device, 48),
    "SHA512": Hasher(sha2.nblocks_sha512, sha2.pack_blocks_sha512,
                     sha2.sha512_device, sha2.SHA512_DIGEST_BYTES),
}


def hash_key(hash_name: str) -> str:
    """A hash name without case, dashes or underscores ("SHA-384",
    "sha384" -> "SHA384")."""
    return hash_name.replace("-", "").replace("_", "").upper()


def hasher(hash_name: str) -> Hasher:
    """The device hash of a name ("SHA-384", "sha3_256", "SHAKE256"): one
    of the SHA-2 hashes above or of the SHA-3 family (``sha3.PARAMS``).
    Any other name raises ValueError."""
    key = hash_key(hash_name)
    if key in _SHA2:
        return _SHA2[key]
    sha3_names = {name.replace("_", ""): name for name in sha3.PARAMS}
    if key not in sha3_names:
        raise ValueError(f"hash {hash_name!r} is not ported; "
                         f"{', '.join(_SHA2)} and {', '.join(sha3.PARAMS)} "
                         "are")
    rate, outlen, dsbyte = sha3.PARAMS[sha3_names[key]]
    return Hasher(lambda mlen: sha3.nblocks_keccak(mlen, rate),
                  lambda msgs: sha3.pack_blocks_keccak(msgs, rate, dsbyte),
                  lambda blocks: sha3.sha3_device(blocks, rate, outlen),
                  outlen)


def batch_digests(hash_name: str, msgs: list[bytes], device) -> list[bytes]:
    """Digests of a message batch (any hash of ``hasher``; SHAKE256 at 114
    bytes), hashed on `device`. Port of
    ``libecc_tpu/sig/common.py:batch_digests`` (:30-70): the messages are
    bucketed by padded block count and each bucket is hashed by one call of
    the device function; each digest is its big-endian words cut to the
    digest length (``make_sha3_device``'s convention for SHAKE256). Unlike
    the reference, tiny buckets are not hashed on the host (the port has no
    host hash layer) and buckets are not padded to a power of two (nothing
    is traced)."""
    nblocks, pack, device_fn, nb = hasher(hash_name)
    groups = defaultdict(list)
    for i, m in enumerate(msgs):
        groups[nblocks(len(m))].append(i)
    out: list = [None] * len(msgs)
    for idxs in groups.values():
        words = device_fn(nn.upload(pack([msgs[i] for i in idxs]), device))
        raw = nn.to_host(words).T.astype(">u4").tobytes()
        stride = 4 * words.shape[0]
        for j, i in enumerate(idxs):
            out[i] = raw[j * stride:j * stride + nb]
    return out


def e_from_msgs(msgs: list[bytes], q_ctx: FpCtx, device,
                hash_name: str = "SHA256"):
    """Message batch -> ECDSA scalar e = trunc(H(m)) mod q, for any hash of
    ``hasher``. Port of ``libecc_tpu/sig/common.py:e_from_msgs``
    (:108-131): a batch whose messages pad to one block count is hashed by
    one call of the tensor function and truncated on `device` without
    leaving it; a mixed batch is hashed on `device` bucket by bucket
    (``batch_digests``)."""
    h = hasher(hash_name)
    try:
        blocks = h.pack(msgs)
    except ValueError:
        words = nn.upload(digests_to_words(
            batch_digests(hash_name, msgs, device)), device)
    else:
        words = h.device(nn.upload(blocks, device))
    return e_from_digest_bits(words, 8 * h.digest_bytes, q_ctx)


def e_from_digest_bits(words, digest_bits: int, q_ctx: FpCtx,
                       q_bits: int | None = None):
    """ECDSA hash truncation: keep the leftmost min(q_bits, digest_bits)
    bits of the digest words (int32[W, N], big-endian), then reduce mod q
    with one conditional subtract (the truncated value is < 2q)."""
    if q_bits is None:
        q_bits = q_ctx.bits
    total = words.shape[0] * 32
    if digest_bits > q_bits:
        k_wide = max(q_ctx.k, words.shape[0])
        e = nn.be_words_to_limbs(words, total, k_wide)
        e = nn.rshift(e, total - q_bits)[:q_ctx.k].contiguous()
    else:
        e = nn.be_words_to_limbs(words, total, q_ctx.k)
        if total > digest_bits:
            e = nn.rshift(e, total - digest_bits)
    return nn.mod_reduce_once(e, q_ctx)


def x_coord_mod_q(x_canonical, p_ctx: FpCtx, q_ctx: FpCtx):
    """Canonical plain field x-coordinate -> x mod q."""
    return fp.reduce_wide(x_canonical, q_ctx)


# -- mod-q arithmetic on canonical scalars -----------------------------------

def q_mul(a, b, q_ctx: FpCtx):
    """a*b mod q on canonical plain-domain scalars (two kernel-1 products:
    a*R, then (a*R)*b*R^-1)."""
    return mont.mont_mul(fp.to_mont(a, q_ctx), b.contiguous(), q_ctx)


def q_add(a, b, q_ctx: FpCtx):
    return nn.mod_add(a, b, q_ctx)


def q_inv(a, q_ctx: FpCtx):
    """a^-1 mod q on scalars below R (0 -> 0; callers mask separately).
    Batches of >= 16 lanes use the batch-inversion lane tree."""
    if a.dim() == 2 and a.shape[-1] >= 16:
        return _q_inv_batched(a, q_ctx)
    return _q_inv_fermat(a, q_ctx)


def _mont_pow(a_mont, e: int, q_ctx: FpCtx):
    """x^e keeping the Montgomery factor (in xR, out x^e R); public e."""
    acc = a_mont
    for bit in bin(e)[3:]:
        acc = mont.mont_sqr(acc, q_ctx)
        if bit == "1":
            acc = mont.mont_mul(acc, a_mont, q_ctx)
    return acc


def _q_inv_fermat(a, q_ctx: FpCtx):
    return fp.from_mont(_mont_pow(fp.to_mont(a, q_ctx), q_ctx.p_int - 2,
                                  q_ctx), q_ctx)


def _q_inv_batched(a, q_ctx: FpCtx):
    """Montgomery's batch inversion as a lane tree: pairwise products up,
    ONE Fermat inversion of the total, products with the siblings down.
    Lanes whose value is 0 mod q (s = q, say) are swapped for 1 before the
    tree and masked to 0 after; one such lane would otherwise zero the
    whole product and poison every other lane's inverse."""
    n = a.shape[-1]
    am = fp.to_mont(a, q_ctx)                  # canonical: 0 iff a = 0 mod q
    zmask = nn.is_zero_mask(am)
    one_m = q_ctx.col(q_ctx.r_int, a.device).expand(q_ctx.k, n)
    am = torch.where(zmask[None], one_m, am)
    n2 = 1 << (n - 1).bit_length()
    if n2 != n:
        am = torch.cat([am, q_ctx.col(q_ctx.r_int, a.device).expand(
            q_ctx.k, n2 - n)], 1)
    levels = []
    cur = am
    while cur.shape[-1] > 1:
        even = cur[:, 0::2].contiguous()
        odd = cur[:, 1::2].contiguous()
        levels.append((even, odd))
        cur = mont.mont_mul(even, odd, q_ctx)
    inv = _mont_pow(cur, q_ctx.p_int - 2, q_ctx)
    for even, odd in reversed(levels):
        ie = mont.mont_mul(inv, odd, q_ctx)
        io = mont.mont_mul(inv, even, q_ctx)
        inv = torch.stack([ie, io], -1).reshape(q_ctx.k, -1)
    out = fp.from_mont(inv[:, :n].contiguous(), q_ctx)
    return torch.where(zmask[None], torch.zeros_like(out), out)
