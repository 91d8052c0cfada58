"""Twisted Edwards curves: batched extended-coordinate point operations.

Port of ``libecc_tpu/curves/edwards.py``. A point is (X : Y : Z : T) with
x = X/Z, y = Y/Z and T = XY/Z, each coordinate an ``int32[K, N]``
canonical Montgomery-form field element; the identity is (0 : 1 : 1 : 0).
The curve is a x^2 + y^2 = 1 + d x^2 y^2. ``point_add`` (the HWCD unified
extended add) and ``point_dbl`` (dbl-2008-hwcd) run as kernels 8a and 8b
(``ops/cuda/edpoint.py``) for tensors on the card, and ``pdbln_add`` (n
doublings and one add, the Straus scan step) as kernel 8c; their plain
versions live beside the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import torch

from ..fp import field as fp
from ..fp.field import FpCtx
from ..ops.cuda import edpoint as kedpoint


class ExtPoint(NamedTuple):
    """Batch of extended points; coords in Montgomery form, int32[K, N]."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


@dataclass
class EdwardsCurve:
    name: str
    fp_ctx: FpCtx
    a: int
    d: int
    gx: int
    gy: int
    q: int              # prime subgroup order
    h: int              # cofactor
    q_ctx: FpCtx | None = None

    def __post_init__(self):
        if self.q_ctx is None:
            self.q_ctx = FpCtx(self.q)
        p = self.fp_ctx.p_int
        self.a_is_m1 = (self.a % p) == (p - 1)
        self.a_is_1 = (self.a % p) == 1
        self.d2 = (2 * self.d) % p

    def point_from_affine_ints(self, xs, ys, device) -> ExtPoint:
        """Host ints -> batched extended point (Z = 1, T = x y)."""
        x = self.fp_ctx.from_ints(xs, device)
        y = self.fp_ctx.from_ints(ys, device)
        one = self.fp_ctx.one(like=x).contiguous()
        return ExtPoint(x, y, one, fp.mul(x, y, self.fp_ctx))

    def generator(self, batch_shape=(), device=None) -> ExtPoint:
        ctx = self.fp_ctx
        return ExtPoint(ctx.const(self.gx, None, batch_shape, device),
                        ctx.const(self.gy, None, batch_shape, device),
                        ctx.const(1, None, batch_shape, device),
                        ctx.const(self.gx * self.gy, None, batch_shape,
                                  device))

    def identity(self, like: ExtPoint | None = None, batch_shape=(),
                 device=None) -> ExtPoint:
        """(0 : 1 : 1 : 0), contiguous (the kernels take it as it is)."""
        if like is not None:
            batch_shape, device = like.x.shape[1:], like.x.device
        ctx = self.fp_ctx
        z0 = ctx.zero(batch_shape=batch_shape, device=device)
        one = ctx.const(1, None, batch_shape, device)
        return ExtPoint(z0, one.contiguous(), one.contiguous(),
                        torch.zeros_like(z0))

    # generic group interface
    def padd(self, P, Q):
        return point_add(self, P, Q)

    def pdbl(self, P):
        return point_dbl(self, P)

    def pdbln_add(self, P, Q, ndbl: int):
        """2^ndbl * P + Q; kernel 8c on the card."""
        return kedpoint.ed_dbln_add(self, P, Q, ndbl)

    def pinf(self, like=None, batch_shape=(), device=None):
        return self.identity(like=like, batch_shape=batch_shape,
                             device=device)

    def scalar_bits(self) -> int:
        return self.q.bit_length()


def point_add(c: EdwardsCurve, P: ExtPoint, Q: ExtPoint) -> ExtPoint:
    """Unified extended addition (add-2008-hwcd-3 for a = -1, add-2008-hwcd
    otherwise). Kernel 8a on the card."""
    return kedpoint.ed_add(c, P, Q)


def point_dbl(c: EdwardsCurve, P: ExtPoint) -> ExtPoint:
    """Extended doubling, dbl-2008-hwcd, any a. Kernel 8b on the card."""
    return kedpoint.ed_dbl(c, P)


def point_neg(c: EdwardsCurve, P: ExtPoint) -> ExtPoint:
    ctx = c.fp_ctx
    return ExtPoint(fp.neg(P.x, ctx), P.y, P.z, fp.neg(P.t, ctx))


def is_identity_mask(c: EdwardsCurve, P: ExtPoint):
    """X == 0 and Y == Z, lanewise."""
    return fp.is_zero_mask(P.x) & fp.eq_mask(P.y, P.z)


def to_affine_plain(c: EdwardsCurve, P: ExtPoint):
    """Affine (x, y) in the PLAIN domain, canonical; the identity gives
    (0, 1)."""
    ctx = c.fp_ctx
    zinv = fp.inv(P.z, ctx)
    return (fp.from_mont(fp.mul(P.x, zinv, ctx), ctx),
            fp.from_mont(fp.mul(P.y, zinv, ctx), ctx))


def on_curve_mask(c: EdwardsCurve, P: ExtPoint):
    """a X^2 Z^2 + Y^2 Z^2 == Z^4 + d X^2 Y^2 (projective check) and
    T Z == X Y (extended-coordinate consistency)."""
    ctx = c.fp_ctx
    Ka = ctx.const(c.a, like=P.x)
    Kd = ctx.const(c.d, like=P.x)
    x2, y2, z2 = fp.sqr(P.x, ctx), fp.sqr(P.y, ctx), fp.sqr(P.z, ctx)
    lhs = fp.mul(fp.add(fp.mul(Ka, x2, ctx), y2, ctx), z2, ctx)
    rhs = fp.add(fp.sqr(z2, ctx), fp.mul(Kd, fp.mul(x2, y2, ctx), ctx), ctx)
    return (fp.eq_mask(lhs, rhs)
            & fp.eq_mask(fp.mul(P.t, P.z, ctx), fp.mul(P.x, P.y, ctx)))


# ---------------------------------------------------------------------------
# Registry (the port's own copy of the reference's data, edwards.py:263-292)
# ---------------------------------------------------------------------------

_ED_CURVES: dict[str, dict] = {}


def _canon(name: str) -> str:
    return name.replace("_", "").replace("-", "").upper()


def register_edwards(name: str, p: int, a: int, d: int, gx: int, gy: int,
                     q: int, h: int, aliases=()):
    """Register a twisted Edwards curve; checks the generator equation."""
    a_, d_ = a % p, d % p
    lhs = (a_ * gx * gx + gy * gy) % p
    rhs = (1 + d_ * gx * gx % p * gy * gy) % p
    if lhs != rhs:
        raise ValueError(f"edwards curve {name}: generator not on curve")
    entry = dict(name=name, p=p, a=a_, d=d_, gx=gx, gy=gy, q=q, h=h)
    for key in (name, *aliases):
        _ED_CURVES[_canon(key)] = entry
    get_edwards_curve.cache_clear()


@lru_cache(maxsize=None)
def get_edwards_curve(name: str) -> EdwardsCurve:
    key = _canon(name)
    if key not in _ED_CURVES:
        raise KeyError(f"unknown edwards curve {name!r}")
    d = _ED_CURVES[key]
    return EdwardsCurve(name=d["name"], fp_ctx=FpCtx(d["p"]), a=d["a"],
                        d=d["d"], gx=d["gx"], gy=d["gy"], q=d["q"], h=d["h"])


P25519 = 2**255 - 19

register_edwards(
    "ED25519",
    p=P25519,
    a=-1,
    d=37095705934669439343138083508754565189542113879843219016388785533085940283555,
    gx=15112221349535400772501151409588531511454012693041857206046113283949847762202,
    gy=46316835694926478169428394003475163141307993866256225615783033603165251855960,
    q=2**252 + 27742317777372353535851937790883648493,
    h=8,
    aliases=("WEI25519-ED", "EDWARDS25519"),
)

P448 = 2**448 - 2**224 - 1

register_edwards(
    # RFC 8032 edwards448: K = 14 limbs, a = 1 (the K = 14 kernels)
    "ED448",
    p=P448,
    a=1,
    d=-39081,
    gx=224580040295924300187604334099896036246789641632564134246125461686950415467406032909029192869357953282578032075146446173674602635247710,
    gy=298819210078481492676017930443930673437544040154080242095928241372331506189835876003536878655418784733982303233503462500531545062832660,
    q=2**446 - 0x8335dc163bb124b65129c96fde933d8d723a70aadc873d6d54a7bb0d,
    h=4,
    aliases=("EDWARDS448", "ED-448"),
)
