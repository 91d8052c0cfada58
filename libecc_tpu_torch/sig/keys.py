"""EC public keys for verification.

Port of the verify-side part of ``libecc_tpu/sig/keys.py``: ``KeyBatch``
(with ``pub_affine_ints``), ``pubkey_batch_from_affine_ints`` (host range
and on-curve validation, which raises) and ``import_pub_raw``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import resolve_device
from ..curves.shortw import ShortWCurve, PrjPoint, to_affine_plain
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


def pubkey_batch_from_affine_ints(curve: ShortWCurve, alg: str, xs, ys,
                                  validate: bool = True,
                                  check_order: bool | None = None,
                                  device=None) -> KeyBatch:
    """Build a public-key batch; by default checks that every point has
    coordinates below p and lies on the curve (an off-curve key enables
    invalid-curve attacks), raising ValueError otherwise.

    check_order (default: exactly for h > 1 curves) asks for the q*P
    subgroup check, which this slice does not provide: it raises rather
    than skip the check."""
    dev = resolve_device(device)
    if validate:
        p = curve.fp_ctx.p_int
        for i, (x, y) in enumerate(zip(xs, ys)):
            if not (0 <= x < p and 0 <= y < p):
                raise ValueError(f"public key {i}: coordinate out of range")
            if (y * y - (x * x * x + curve.a * x + curve.b)) % p != 0:
                raise ValueError(f"public key {i}: point not on curve")
    if check_order is None:
        check_order = validate and curve.h > 1
    if check_order:
        raise NotImplementedError(
            f"{curve.name}: the q*P subgroup check for cofactor {curve.h} "
            "curves is not ported yet")
    pub = curve.point_from_affine_ints(xs, ys, dev)
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
