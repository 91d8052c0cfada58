"""EC public keys for verification.

Port of the verify-side part of ``libecc_tpu/sig/keys.py``: ``KeyBatch``
(with ``pub_affine_ints``), ``order_check_mask`` (the batched q*P
subgroup check), ``pubkey_batch_from_affine_ints`` (host range and
on-curve validation and, on cofactor > 1 curves, the subgroup check; each
raises) and ``import_pub_raw``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

import numpy as np

from .. import stages
from ..config import resolve_device
from ..curves import scalar_mul
from ..curves.shortw import ShortWCurve, PrjPoint, is_infinity_mask, \
    to_affine_plain
from ..fp import field as fp
from ..nn import core as nn


@dataclass
class KeyBatch:
    """N keys for one (curve, alg). priv: int32[Kq, N] canonical scalars
    (None for public-only keys); pub: PrjPoint batch (Montgomery coords)."""
    curve: ShortWCurve
    alg: str
    n: int
    priv: torch.Tensor | None = None
    pub: PrjPoint | None = None

    @property
    def device(self) -> torch.device:
        return self.pub.x.device

    def pub_affine_ints(self):
        """(xs, ys, inf): the keys' affine coordinates as host ints (0 at
        the identity) and an np.bool identity mask. One field inversion
        ladder on the keys' device."""
        x, y, inf = to_affine_plain(self.curve, self.pub)
        return (nn.batch_from_limbs(x), nn.batch_from_limbs(y),
                inf.cpu().numpy())


def order_check_mask(curve: ShortWCurve, pub: PrjPoint) -> np.ndarray:
    """Batched q*P == infinity check (reference: check_prj_pt_order,
    prj_pt.c:1909): True lanes have order dividing q. One windowed multiply
    by the PUBLIC scalar q, broadcast over the lanes, on the keys' device
    (kernel 4 on the card). Returns an np.bool mask.

    A point (x, 0) has order 2, which the odd q does not divide, so its lane
    is False whatever the multiply gives: on a curve with such a point
    (even h) the complete formulas add the identity (0 : Y : 0) to it and
    get (0 : 0 : 0), which reads as the identity. A Montgomery-form Y is
    zero exactly when y is."""
    kq, n = curve.q_ctx.k, pub.x.shape[1]
    ql = curve.q_ctx.col(curve.q, pub.x.device).expand(kq, n).contiguous()
    qP = scalar_mul.windowed_mul_public(curve, ql, pub,
                                        nbits=curve.q.bit_length())
    order2 = fp.is_zero_mask(pub.y) & ~fp.is_zero_mask(pub.z)
    ok = is_infinity_mask(curve, qP) & ~order2
    stages.mark("order check", ok)
    return ok.cpu().numpy()


def pubkey_batch_from_affine_ints(curve: ShortWCurve, alg: str, xs, ys,
                                  validate: bool = True,
                                  check_order: bool | None = None,
                                  device=None) -> KeyBatch:
    """Build a public-key batch; by default checks that every point has
    coordinates below p and lies on the curve (an off-curve key enables
    invalid-curve attacks), raising ValueError otherwise.

    check_order: run the q*P == infinity subgroup check
    (``order_check_mask``) on the keys' device and raise ValueError naming
    the keys outside the order-q subgroup. Default (None): exactly for
    h > 1 curves (WEI25519, WEI448, GOST R 34.10-2012 256 A and 512 C),
    where an imported point can carry a small-order component; on h == 1
    curves on-curve membership already implies order q."""
    dev = resolve_device(device)
    if validate:
        p = curve.fp_ctx.p_int
        for i, (x, y) in enumerate(zip(xs, ys)):
            if not (0 <= x < p and 0 <= y < p):
                raise ValueError(f"public key {i}: coordinate out of range")
            if (y * y - (x * x * x + curve.a * x + curve.b)) % p != 0:
                raise ValueError(f"public key {i}: point not on curve")
    pub = curve.point_from_affine_ints(xs, ys, dev)
    if check_order is None:
        check_order = validate and curve.h > 1
    if check_order:
        stages.mark("import", pub)
        okm = order_check_mask(curve, pub)
        if not okm.all():
            bad = [i for i, v in enumerate(okm) if not v]
            raise ValueError(
                f"public key(s) {bad}: point not in the order-q subgroup")
    return KeyBatch(curve=curve, alg=alg, n=len(xs), priv=None, pub=pub)


def import_pub_raw(curve: ShortWCurve, alg: str, bufs: list[bytes],
                   device=None) -> KeyBatch:
    """Uncompressed affine X || Y public keys (p-size bytes each)."""
    nb = (curve.fp_ctx.bits + 7) // 8
    xs, ys = [], []
    for b in bufs:
        if len(b) != 2 * nb:
            raise ValueError("bad public key length")
        xs.append(int.from_bytes(b[:nb], "big"))
        ys.append(int.from_bytes(b[nb:], "big"))
    return pubkey_batch_from_affine_ints(curve, alg, xs, ys, device=device)
