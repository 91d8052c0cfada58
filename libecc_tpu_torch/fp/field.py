"""Prime-field layer: FpCtx and batched field operations.

Port of ``libecc_tpu/fp/field.py:22-160``. A field element batch is an
``int32[K, N]`` tensor of canonical 32-bit limbs in the Montgomery domain
R = 2^(32K) (``nn/core.py``). ``mul`` and ``sqr`` go to kernel 1
(``ops/cuda/mont.py``) for tensors on the card, as the reference's
``fp.mul`` / ``fp.sqr`` dispatch to its Pallas kernel. ``to_mont``,
``from_mont`` and ``reduce_wide`` are Montgomery products too and go the
same way. Add, sub and the masks are plain tensor code.
"""

from __future__ import annotations

import torch

from ..nn import core as nn
from ..nn.core import MontCtx
from ..ops.cuda import mont


class FpCtx(MontCtx):
    """Field context for GF(p): K = ceil(bits / 32) limbs, no headroom
    limbs (values stay canonical, so no relaxed-carry headroom is
    needed)."""

    def const(self, x: int, like=None, batch_shape=(), device=None):
        """Host int -> Montgomery-domain constant, broadcast to the batch."""
        if like is not None:
            batch_shape, device = like.shape[1:], like.device
        col = self.col((x % self.p_int) * self.R % self.p_int, device)
        return col.reshape((self.k,) + (1,) * len(batch_shape)).expand(
            (self.k,) + tuple(batch_shape))

    def zero(self, like=None, batch_shape=(), device=None):
        if like is not None:
            batch_shape, device = like.shape[1:], like.device
        return torch.zeros((self.k,) + tuple(batch_shape), dtype=torch.int32,
                           device=device)

    def one(self, like=None, batch_shape=(), device=None):
        return self.const(1, like, batch_shape, device)

    def from_ints(self, xs, device, to_mont=True):
        """Host list[int] (or one int) -> batch in Montgomery form."""
        single = isinstance(xs, int)
        if single:
            xs = [xs]
        if to_mont:
            xs = [x % self.p_int * self.R % self.p_int for x in xs]
        a = nn.upload(nn.batch_to_limbs(xs, self.k), device)
        return a[:, 0] if single else a

    def to_ints(self, a, from_mont=True):
        """Batch (Montgomery form) -> host list[int]."""
        if a.dim() == 1:
            a = a[:, None]
        vals = nn.batch_from_limbs(a)
        if from_mont:
            rinv = pow(self.R, -1, self.p_int)
            vals = [v * rinv % self.p_int for v in vals]
        return vals


def add(a, b, ctx: FpCtx):
    return nn.mod_add(a, b, ctx)


def sub(a, b, ctx: FpCtx):
    return nn.mod_sub(a, b, ctx)


def neg(a, ctx: FpCtx):
    return nn.mod_neg(a, ctx)


def _flat(a):
    return a.reshape(a.shape[0], -1).contiguous()


def mul(a, b, ctx: MontCtx):
    """Montgomery product; kernel 1 for tensors on the card."""
    shape = a.shape if a.shape == b.shape else torch.broadcast_shapes(
        a.shape, b.shape)
    return mont.mont_mul(_flat(a.expand(shape)), _flat(b.expand(shape)),
                         ctx).reshape(shape)


def sqr(a, ctx: MontCtx):
    """Montgomery square; kernel 1 (square variant) for tensors on the card."""
    return mont.mont_sqr(_flat(a), ctx).reshape(a.shape)


def to_mont(a, ctx: MontCtx):
    """a -> a*R mod p, canonical, for any a < R."""
    return mul(a, ctx.col(ctx.r2_int, a.device), ctx)


def from_mont(a, ctx: MontCtx):
    """a*R -> a mod p."""
    return mul(a, ctx.col(1, a.device), ctx)


def reduce_wide(x, ctx: MontCtx):
    """x mod p for x up to 2K limbs wide: x = x_hi*R + x_lo, so
    x mod p = mont(x_hi, R^2) + mont(mont(x_lo, R^2), 1)."""
    k = ctx.k
    if x.shape[0] > 2 * k:
        raise ValueError("reduce_wide takes at most 2K limbs")
    t_lo = from_mont(to_mont(nn._fit(x[:k], k), ctx), ctx)
    if x.shape[0] <= k:
        return t_lo
    return nn.mod_add(to_mont(nn._fit(x[k:], k), ctx), t_lo, ctx)


def canon(a, ctx: FpCtx):
    """Canonical form. Values of this layer are always canonical, so this
    is the identity; it is kept so that callers read as the reference."""
    return a


def pow_static(a, e: int, ctx: FpCtx):
    """a^e (Montgomery domain) for a public exponent: square-and-multiply
    over the exponent's bits, known on the host."""
    if e == 0:
        return ctx.one(like=a)
    acc = a
    for bit in bin(e)[3:]:
        acc = sqr(acc, ctx)
        if bit == "1":
            acc = mul(acc, a, ctx)
    return acc


def inv(a, ctx: FpCtx):
    """Fermat inverse a^(p-2) (Montgomery domain); 0 -> 0."""
    return pow_static(a, ctx.p_int - 2, ctx)


def eq_mask(a, b, ctx: FpCtx = None):
    return nn.eq_mask(a, b)


def is_zero_mask(a, ctx: FpCtx = None):
    return nn.is_zero_mask(a)


def select(cond, a, b):
    return torch.where(cond[None], a, b)


def sqrt(a, ctx: FpCtx):
    """Batched square root (Montgomery domain) -> (root, exists mask).
    Port of ``libecc_tpu/fp/field.py:sqrt`` (:189-213). Where a is not a
    square the root is garbage and the mask False.

    p = 3 (mod 4): r = a^((p+1)/4). p = 5 (mod 8) (Atkin's variant):
    r = a^((p+3)/8), times sqrt(-1) = 2^((p-1)/4) where r^2 != a; a = 0
    gives root 0. The general Tonelli-Shanks branch is not ported: no
    curve of the port needs it yet, and it raises."""
    p = ctx.p_int
    if p % 4 == 3:
        r = pow_static(a, (p + 1) // 4, ctx)
        return r, eq_mask(sqr(r, ctx), a)
    if p % 8 == 5:
        r = pow_static(a, (p + 3) // 8, ctx)
        sqrtm1 = ctx.const(pow(2, (p - 1) // 4, p), like=a)
        fix = ~eq_mask(sqr(r, ctx), a)
        r = select(fix, mul(r, sqrtm1, ctx), r)
        ok = eq_mask(sqr(r, ctx), a)
        z0 = is_zero_mask(a)
        return select(z0, ctx.zero(like=a), r), ok | z0
    raise NotImplementedError(
        "fp.sqrt: Tonelli-Shanks for p = 1 (mod 8) is not ported yet")
