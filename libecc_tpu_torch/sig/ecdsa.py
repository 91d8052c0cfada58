"""Batched ECDSA verification.

Port of the verify side of ``libecc_tpu/sig/ecdsa.py``:
``verify_core`` (:71-128), ``verify_batch`` (:390),
``verify_digests_batch`` (:398), ``_verify_dispatch`` (:414), the fused
bytes-in ``verify_batch_async`` (:436-497) and the pipelined
``verify_batches`` (:500).

Verify: W = (e s^-1) G + (r s^-1) Y; accept iff W.x mod q == r.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .. import stages
from ..nn import core as nn
from ..fp import field as fp
from ..curves.shortw import PrjPoint, ShortWCurve, on_curve_mask, \
    to_affine_plain
from ..curves import scalar_mul
from ..hash import sha2
from . import common


def verify_core(curve: ShortWCurve, pub: PrjPoint, e, r, s):
    """Batched ECDSA verify. e, r, s: int32[Kq, N] (e canonical, r and s as
    received, below 2^(32 Kq)); pub: points. Returns the accept mask.

    r and s are range-checked against q before any reduction. Both FIA
    on-curve checks (the key before, W after the multiply) force rejection
    of hostile or faulted points. The final test runs projectively when
    ceil(p/q) <= 2: accept iff W.X == c*W.Z for c in {r, r+q}, the second
    candidate only where the integer r + q < p."""
    q_ctx, p_ctx = curve.q_ctx, curve.fp_ctx
    p_int, q_int = p_ctx.p_int, curve.q
    q_arr = q_ctx.col(q_int, r.device)
    in_range = (~nn.is_zero_mask(r)) & (~nn.is_zero_mask(s)) \
        & nn.lt_mask(r, q_arr) & nn.lt_mask(s, q_arr)
    sinv = common.q_inv(s, q_ctx)
    u = common.q_mul(e, sinv, q_ctx)
    v = common.q_mul(r, sinv, q_ctx)
    stages.mark("scalars", u, v)
    fia_ok = on_curve_mask(curve, pub)
    stages.mark("key on curve", fia_ok)
    W = scalar_mul.fixed_base_double_mul_public(curve, u, v, pub)
    fia_ok = fia_ok & on_curve_mask(curve, W)
    in_range = in_range & fia_ok
    n_cand = (p_int - 1) // q_int + 1
    if n_cand <= 2:
        inf = fp.is_zero_mask(W.z, p_ctx)
        r_p = nn._fit(r, p_ctx.k).contiguous()
        rm = fp.to_mont(r_p, p_ctx)          # r as a Montgomery field element
        hit = fp.eq_mask(W.x, fp.mul(rm, W.z, p_ctx), p_ctx)
        if q_int > p_int:
            # r in [p, q) reduces mod p inside rm and can never equal x(W)
            hit = hit & nn.lt_mask(r, q_ctx.col(p_int, r.device))
        else:
            rq = fp.add(rm, p_ctx.const(q_int, like=r_p), p_ctx)
            rq_ok = nn.lt_mask(r, q_ctx.col(p_int - q_int, r.device))
            hit = hit | (fp.eq_mask(W.x, fp.mul(rq, W.z, p_ctx), p_ctx)
                         & rq_ok)
    else:
        wx, _, inf = to_affine_plain(curve, W)
        hit = nn.eq_mask(common.x_coord_mod_q(wx, p_ctx, q_ctx), r)
    acc = in_range & (~inf) & hit
    stages.mark("accept", acc)
    return acc


# ---------------------------------------------------------------------------
# User API: host messages and signatures in, accept mask out
# ---------------------------------------------------------------------------

def verify_batch(keys, msgs: list[bytes], sigs: list[bytes],
                 hash_name="SHA256", adata=None):
    """Verify N signatures (raw r || s) of messages hashed with hash_name
    (SHA-224/256/384/512 or SHA-3, ``common.hasher``; another name raises
    ValueError). Returns an np.bool accept mask. adata is accepted and
    ignored, as the reference does: ECDSA takes no additional data."""
    e = common.e_from_msgs(msgs, keys.curve.q_ctx, keys.device, hash_name)
    return _verify_with_e(keys, e, sigs)


def verify_digests_batch(keys, digs: list[bytes], sigs: list[bytes],
                         hash_name="SHA256", adata=None):
    """Digest-level verify; bit-identical to verify_batch on H(m) = digs,
    with H named by hash_name (its digest length sets the truncation).
    adata is ignored, as in verify_batch."""
    digest_bits = 8 * common.hasher(hash_name).digest_bytes
    words = nn.upload(common.digests_to_words(digs), keys.device)
    e = common.e_from_digest_bits(words, digest_bits, keys.curve.q_ctx)
    return _verify_with_e(keys, e, sigs)


def _verify_with_e(keys, e, sigs):
    return _verify_dispatch(keys, e, sigs).cpu().numpy()


def _verify_dispatch(keys, e, sigs):
    """Parse the signatures and launch the device work WITHOUT waiting
    for the result: returns the accept mask as a device tensor. Raises
    ValueError on a signature of the wrong length."""
    curve, q_ctx = keys.curve, keys.curve.q_ctx
    nb = (curve.q.bit_length() + 7) // 8
    for sg in sigs:
        if len(sg) != 2 * nb:
            raise ValueError("bad signature length")
    r = nn.upload(nn.bytes_be_to_limbs_np([sg[:nb] for sg in sigs], q_ctx.k),
                  keys.device)
    s = nn.upload(nn.bytes_be_to_limbs_np([sg[nb:] for sg in sigs], q_ctx.k),
                  keys.device)
    return verify_core(curve, keys.pub, e, r, s)


# The hashes of the fused bytes-in path: SHA-224 and SHA-256, the 64-byte
# block hashes that sha2.blocks_from_bytes_dev pads on the device.
FUSED_HASHES = ("SHA224", "SHA256")


def _fused_applicable(msgs, sigs, nb):
    """The bytes-in path applies to uniform-length batches of at least 64
    messages of at most 4 SHA-256 (or SHA-224) blocks, with well-formed
    signatures."""
    if not msgs or len(msgs) < 64:
        return False
    mlen = len(msgs[0])
    if mlen + 9 > 64 * 4:
        return False
    return (all(len(m) == mlen for m in msgs)
            and all(len(s) == 2 * nb for s in sigs))


def verify_batch_async(keys, msgs: list[bytes], sigs: list[bytes],
                       hash_name="SHA256", adata=None):
    """Non-blocking verify_batch: returns the accept mask as a device
    tensor without synchronising. Uniform batches hashed with SHA-224 or
    SHA-256 take the fused bytes-in path (as the reference's
    ``_fused_applicable``, :436): the raw message and signature bytes go to
    the device, and the padding, the hash and the limb unpacking run there.
    Other hashes take the unfused path. adata is ignored, as in
    verify_batch."""
    h = common.hasher(hash_name)
    curve, q_ctx = keys.curve, keys.curve.q_ctx
    nb = (curve.q.bit_length() + 7) // 8
    if (common.hash_key(hash_name) not in FUSED_HASHES
            or not _fused_applicable(msgs, sigs, nb)):
        e = common.e_from_msgs(msgs, q_ctx, keys.device, hash_name)
        stages.mark("digest", e)
        return _verify_dispatch(keys, e, sigs)
    n, mlen = len(msgs), len(msgs[0])
    msg_u8 = nn.upload(np.frombuffer(b"".join(msgs), np.uint8).reshape(
        n, mlen), keys.device)
    sig_u8 = nn.upload(np.frombuffer(b"".join(sigs), np.uint8).reshape(
        n, 2 * nb), keys.device)
    words = h.device(sha2.blocks_from_bytes_dev(msg_u8, mlen))
    e = common.e_from_digest_bits(words, 8 * h.digest_bytes, q_ctx)
    r = nn.be_rows_to_limbs_dev(sig_u8[:, :nb], q_ctx.k)
    s = nn.be_rows_to_limbs_dev(sig_u8[:, nb:], q_ctx.k)
    stages.mark("hash", e, r, s)
    return verify_core(curve, keys.pub, e, r, s)


def verify_batches(keys, batches, hash_name="SHA256", depth: int = 3):
    """Pipelined verification over a stream of (msgs, sigs) batches:
    yields one np.bool accept mask per batch, in input order, keeping up
    to `depth` batches in flight so that host packing of the next batch
    overlaps device work on the earlier ones."""
    pending: deque = deque()
    for msgs, sigs in batches:
        pending.append(verify_batch_async(keys, msgs, sigs, hash_name))
        while len(pending) >= depth:
            yield pending.popleft().cpu().numpy()
    while pending:
        yield pending.popleft().cpu().numpy()
