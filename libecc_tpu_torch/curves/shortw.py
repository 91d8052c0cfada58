"""Short-Weierstrass curves: batched projective point operations.

Port of ``libecc_tpu/curves/shortw.py``. Points are homogeneous projective
(X : Y : Z), each coordinate an ``int32[K, N]`` canonical Montgomery-form
field element; the identity is (0 : 1 : 0). ``point_add`` and
``point_dbl`` are the Renes-Costello-Batina complete formulas and run as
kernels 2 and 3 (``ops/cuda/point.py``) for tensors on the card, and
``point_dbln_add`` (2^n*P + Q, the Straus scan step of public-scalar
paths) as kernel 5; their plain versions live beside the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..fp import field as fp
from ..fp.field import FpCtx
from ..ops.cuda import point as kpoint


class PrjPoint(NamedTuple):
    """Batch of projective points; coords in Montgomery form, int32[K, N]."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


@dataclass
class ShortWCurve:
    """Curve y^2 z = x^3 + a x z^2 + b z^3 over GF(p)."""
    name: str
    fp_ctx: FpCtx
    a: int
    b: int
    gx: int
    gy: int
    q: int            # generator order
    h: int = 1        # cofactor
    q_ctx: FpCtx | None = None   # mod-q arithmetic context (scalars)

    def __post_init__(self):
        if self.q_ctx is None:
            self.q_ctx = FpCtx(self.q)
        p = self.fp_ctx.p_int
        self.b3 = (3 * self.b) % p
        self.a2 = (self.a * self.a) % p
        self.a_is_m3 = (self.a % p) == (p - 3)
        self.a_is_0 = (self.a % p) == 0

    def point_from_affine_ints(self, xs, ys, device) -> PrjPoint:
        """Host ints -> batched projective point (Z = 1)."""
        x = self.fp_ctx.from_ints(xs, device)
        y = self.fp_ctx.from_ints(ys, device)
        return PrjPoint(x, y, self.fp_ctx.one(like=x).contiguous())

    def generator(self, batch_shape=(), device=None) -> PrjPoint:
        ctx = self.fp_ctx
        return PrjPoint(ctx.const(self.gx, None, batch_shape, device),
                        ctx.const(self.gy, None, batch_shape, device),
                        ctx.const(1, None, batch_shape, device))

    def infinity(self, like: PrjPoint | None = None, batch_shape=(),
                 device=None) -> PrjPoint:
        if like is not None:
            batch_shape, device = like.x.shape[1:], like.x.device
        z0 = self.fp_ctx.zero(batch_shape=batch_shape, device=device)
        one = self.fp_ctx.const(1, None, batch_shape, device).contiguous()
        return PrjPoint(z0, one, torch.zeros_like(z0))

    def padd(self, P, Q):
        return point_add(self, P, Q)

    def pdbl(self, P):
        return point_dbl(self, P)

    def pdbln_add(self, P, Q, ndbl: int):
        return point_dbln_add(self, P, Q, ndbl)

    def pinf(self, like=None, batch_shape=(), device=None):
        return self.infinity(like=like, batch_shape=batch_shape,
                             device=device)

    def scalar_bits(self) -> int:
        return self.q.bit_length()


def is_infinity_mask(c: ShortWCurve, p: PrjPoint):
    """Z == 0 lanewise (canonical limbs)."""
    return fp.is_zero_mask(p.z)


def point_add(c: ShortWCurve, P: PrjPoint, Q: PrjPoint) -> PrjPoint:
    """Complete addition, any a (RCB 2015 Alg. 1). Kernel 2 on the card."""
    return kpoint.point_add(c, P, Q)


def point_dbl(c: ShortWCurve, P: PrjPoint) -> PrjPoint:
    """Complete doubling, any a (RCB 2015 Alg. 3). Kernel 3 on the card."""
    return kpoint.point_dbl(c, P)


class _FpField(kpoint.PlainField):
    """The formula bodies' field operations through ``fp.mul`` and
    ``fp.sqr``: kernel 1 for tensors on the card, its plain version on the
    CPU (one launch per grouped layer)."""

    def muls(self, *pairs):
        return self._grouped(lambda a, b: fp.mul(a, b, self.ctx),
                             *zip(*pairs))

    def sqrs(self, *items):
        return self._grouped(lambda a: fp.sqr(a, self.ctx), items)


def point_dbln_jac(c: ShortWCurve, P: PrjPoint, ndbl: int) -> PrjPoint:
    """2^ndbl * P for PUBLIC points through a Jacobian doubling block:
    homogeneous -> Jacobian (X*Z, Y*Z^2, Z) with ONE select for the
    identity (Z = 0 lanes take (1, 1, 0), whose doubling orbit is itself),
    ndbl dbl-2001-b doublings, Jacobian -> homogeneous (X*Z : Y : Z^3).
    The formulas run on kernel 1; the fused form is kernel 5."""
    F = _FpField(c, P.x)
    return PrjPoint(*kpoint.dbln_jac_body(F, kpoint.a_kind(c), *P, ndbl))


def point_dbln_add(c: ShortWCurve, P: PrjPoint, Q: PrjPoint,
                   ndbl: int) -> PrjPoint:
    """2^ndbl * P + Q for PUBLIC points (the Jacobian block, then one
    complete add): the Straus scan step. Kernel 5 on the card."""
    return kpoint.point_dbln_add(c, P, Q, ndbl)


def to_affine_plain(c: ShortWCurve, P: PrjPoint):
    """Affine coordinates in the PLAIN domain (canonical), x = y = 0 at
    infinity; returns (x, y, inf_mask)."""
    ctx = c.fp_ctx
    inf = is_infinity_mask(c, P)
    zinv = fp.inv(P.z, ctx)
    x = fp.from_mont(fp.mul(P.x, zinv, ctx), ctx)
    y = fp.from_mont(fp.mul(P.y, zinv, ctx), ctx)
    z = ctx.zero(like=x)
    return fp.select(inf, z, x), fp.select(inf, z, y), inf


def on_curve_mask(c: ShortWCurve, P: PrjPoint):
    """Projective on-curve check Y^2 Z == X^3 + a X Z^2 + b Z^3; the
    identity passes."""
    ctx = c.fp_ctx
    A = ctx.const(c.a, like=P.x)
    B = ctx.const(c.b, like=P.x)
    X, Y, Z = P
    z2 = fp.sqr(Z, ctx)
    lhs = fp.mul(fp.sqr(Y, ctx), Z, ctx)
    rhs = fp.mul(fp.sqr(X, ctx), X, ctx)
    rhs = fp.add(rhs, fp.mul(A, fp.mul(X, z2, ctx), ctx), ctx)
    rhs = fp.add(rhs, fp.mul(B, fp.mul(z2, Z, ctx), ctx), ctx)
    return fp.eq_mask(lhs, rhs, ctx)


def y_from_x(c: ShortWCurve, x):
    """Candidate y for affine x (Montgomery form): sqrt(x^3 + a x + b).
    Returns (y, exists mask); y is garbage where the mask is False."""
    ctx = c.fp_ctx
    A = ctx.const(c.a, like=x)
    B = ctx.const(c.b, like=x)
    rhs = fp.mul(fp.sqr(x, ctx), x, ctx)
    rhs = fp.add(rhs, fp.mul(A, x, ctx), ctx)
    rhs = fp.add(rhs, B, ctx)
    return fp.sqrt(rhs, ctx)
