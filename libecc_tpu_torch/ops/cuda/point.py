"""Kernels 2, 3 and 5: complete point addition, doubling and the fused
2^n*P + T step (``csrc/point.cu``; the K = 12 (a = -3) and K = 16 (generic
a) instances in ``csrc/point_wide.cu``, the K = 17 ones in
``csrc/point_p521.cu``, the K = 14 (generic a: WEI448) ones in
``csrc/point_wei448.cu``, kernels 2 and 3 at K = 6, 7 and 10 in
``csrc/point_small.cu``, at K = 12 (generic a) and all three at K = 16
(a = -3) in ``csrc/point_wide_alt.cu``). Kernels 2 and 3 run a group of
threads a lane (``csrc/groupfield.cuh``'s ``formula_group_kernel`` with
``csrc/point.cuh``'s ``PointAdd`` and ``PointDbl``, in the shape its
``AddShape`` sets at each K), kernel 5 one thread a lane.

Counterparts of ``libecc_tpu/ops/pallas/point.py:point_add`` /
``point_dbl`` / ``point_dbln_add``. The plain versions below evaluate the
same formulas operation for operation (``_add_body`` / ``_dbl_body``,
mirroring the reference's bodies at point.py:311-421, and the Jacobian
window block ``dbln_jac_body``, its ``_dbln_jac_block`` :300, which
kernels 4, 5 and 6 share) on plain tensor field operations. Wrappers
launch the kernels for tensors on the card and take the plain versions
only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...nn import core as nn
from . import build
from .build import kernel_name
from .mont import (check_operand, field_ctx_type, field_struct,
                   mont_limbs, _stream)

A_GENERIC, A_M3, A_ZERO = 0, 1, 2
A_NAMES = {A_GENERIC: "generic a", A_M3: "a = -3", A_ZERO: "a = 0"}
# the tag of a (K, a) instance's names where its K is built for more than
# one a under separate entry points ("point_add_k6_m3")
A_TAGS = {A_GENERIC: "ga", A_M3: "m3", A_ZERO: "a0"}
BASES = ("point_add", "point_dbl", "point_dbln_add")
_WIDE = ("point_add", "point_dbl")
# The built instances of kernels 2, 3 and 5: (K, a_kind) -> the library
# (csrc/<stem>.cu), the kernels built there and the instance's tag. K = 8
# takes every a in one entry point a kernel (one formula set per a, chosen
# at launch), and so does each of the first-built wider instances (K = 12,
# a = -3; K = 16, generic a; K = 17, a = -3): their entry points are
# <base>_k<K> and they count under build.kernel_name(base, K). The later
# ones (K = 6 and 7 for every a, K = 10 for a = -3 and generic a, K = 12
# for generic a, K = 16 for a = -3, K = 14 for generic a) have one entry
# point per (K, a), <base>_k<K>_<tag>, counted under that name. Kernel 5
# (the joint-table Straus step) is built at K = 8 and at the (K, a) of the
# curves whose joint-table Straus runs on the card: P-384, the 512-bit
# curves of either a, P-521 and WEI448. The support check, the ctypes
# typing and the launch counts derive from this table.
BUILT = {(8, A_GENERIC): ("point", BASES, ""), (8, A_M3): ("point", BASES, ""),
         (8, A_ZERO): ("point", BASES, ""),
         (12, A_M3): ("point_wide", BASES, ""),
         (16, A_GENERIC): ("point_wide", BASES, ""),
         (17, A_M3): ("point_p521", BASES, ""),
         **{(k, a): ("point_small", _WIDE, A_TAGS[a])
            for k, kinds in ((6, A_TAGS), (7, A_TAGS),
                             (10, (A_M3, A_GENERIC)))
            for a in kinds},
         (12, A_GENERIC): ("point_wide_alt", _WIDE, "ga"),
         (16, A_M3): ("point_wide_alt", BASES, "m3"),
         (14, A_GENERIC): ("point_wei448", BASES, "ga")}


def _entry(base: str, k: int, tag: str) -> str:
    """The C entry point of an instance."""
    return f"{base}_k{k}_{tag}" if tag else f"{base}_k{k}"


def _count_name(base: str, k: int, tag: str) -> str:
    return f"{kernel_name(base, k)}_{tag}" if tag else kernel_name(base, k)


def instance_name(base: str, curve) -> str | None:
    """The name under which the kernel ``base`` built for the curve's
    (K, a) counts its launches, or None where it is not built."""
    stem, bases, tag = BUILT.get((curve.fp_ctx.k, a_kind(curve)),
                                 (None, (), ""))
    return _count_name(base, curve.fp_ctx.k, tag) if base in bases else None


launches = {_count_name(base, k, tag): 0
            for (k, _), (_, bases, tag) in BUILT.items() for base in bases}


@functools.lru_cache(maxsize=None)
def curve_ctx_type(k: int) -> type:
    """ctypes mirror of ecc::CurveCtx<k> (csrc/field.cuh)."""
    fe = ctypes.c_uint32 * k
    return type(f"CurveCtx{k}", (ctypes.Structure,), {"_fields_": [
        ("f", field_ctx_type(k)), ("one", fe), ("a", fe), ("a2", fe),
        ("b3", fe), ("a_kind", ctypes.c_int32)]})


def a_kind(curve) -> int:
    return A_M3 if curve.a_is_m3 else A_ZERO if curve.a_is_0 else A_GENERIC


def curve_struct(curve):
    """Curve constants for the kernels, Montgomery form."""
    s = getattr(curve, "_cuda_struct", None)
    if s is None:
        ctx = curve.fp_ctx
        s = curve_ctx_type(ctx.k)(
            field_struct(ctx), mont_limbs(ctx, 1), mont_limbs(ctx, curve.a),
            mont_limbs(ctx, curve.a2), mont_limbs(ctx, curve.b3),
            a_kind(curve))
        curve._cuda_struct = s
    return s


def ptr_array(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _lib(stem: str):
    lib = build.library(stem)
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for (k, _), (lib_stem, bases, tag) in BUILT.items():
            if lib_stem != stem:
                continue
            cctx = ctypes.POINTER(curve_ctx_type(k))
            for base in bases:
                ndbl = [ctypes.c_int] if base == "point_dbln_add" else []
                fn = getattr(lib, _entry(base, k, tag))
                fn.argtypes = [cctx, vp, vp, ll, *ndbl, vp]
                fn.restype = ctypes.c_int
        lib._typed = True
    return lib


# -- plain versions --------------------------------------------------------

class PlainField:
    """Plain tensor field operations of one curve, for the formula bodies.
    Independent operations of one formula layer are grouped into one call
    over the concatenated lanes (as the reference's shortw._mul_group), so
    the plain versions issue a few wide tensor operations per layer."""

    def __init__(self, curve, like: torch.Tensor):
        self.ctx = ctx = curve.fp_ctx
        self.A = ctx.const(curve.a, like=like)
        self.A2 = ctx.const(curve.a2, like=like)
        self.B3 = ctx.const(curve.b3, like=like)
        self.one = ctx.const(1, like=like)

    @staticmethod
    def _grouped(fn, *cols):
        n = cols[0][0].shape[1]
        out = fn(*[torch.cat(list(c), 1) for c in cols])
        return list(out.split(n, 1))

    def muls(self, *pairs):
        return self._grouped(lambda a, b: nn.mont_mul(a, b, self.ctx),
                             *zip(*pairs))

    def sqrs(self, *items):
        return self._grouped(lambda a: nn.mont_sqr(a, self.ctx), items)

    def adds(self, *pairs):
        return self._grouped(lambda a, b: nn.mod_add(a, b, self.ctx),
                             *zip(*pairs))

    def subs(self, *pairs):
        return self._grouped(lambda a, b: nn.mod_sub(a, b, self.ctx),
                             *zip(*pairs))

    def triples(self, *items):
        doubled = self.adds(*[(a, a) for a in items])
        return self.adds(*zip(doubled, items))


def _add_body(F: PlainField, kind: int, X1, Y1, Z1, X2, Y2, Z2):
    s1, s2, s3, s4, s5, s6 = F.adds((X1, Y1), (X2, Y2), (X1, Z1), (X2, Z2),
                                    (Y1, Z1), (Y2, Z2))
    t0, t1, t2, m3, m4, m5 = F.muls((X1, X2), (Y1, Y2), (Z1, Z2), (s1, s2),
                                    (s3, s4), (s5, s6))
    u1, u2, u3 = F.adds((t0, t1), (t0, t2), (t1, t2))
    t3, t4, t5 = F.subs((m3, u1), (m4, u2), (m5, u3))
    if kind == A_GENERIC:
        b3t2, b3t4, at4, at2, at0, a2t2 = F.muls(
            (t2, F.B3), (t4, F.B3), (t4, F.A), (t2, F.A), (t0, F.A),
            (t2, F.A2))
        (t0_3,) = F.triples(t0)
        (d,) = F.subs((at0, a2t2))
        Z3, t1n = F.adds((at4, b3t2), (t0_3, at2))
        (X3,) = F.subs((t1, Z3))
        Z3, t4n = F.adds((t1, Z3), (b3t4, d))
    else:
        b3t2, b3t4 = F.muls((t2, F.B3), (t4, F.B3))
        if kind == A_ZERO:
            (X3,) = F.subs((t1, b3t2))
            (Z3,) = F.adds((t1, b3t2))
            (t1n,) = F.triples(t0)
            t4n = b3t4
        else:                                   # a = -3
            s02, t2_2 = F.adds((t0, t2), (t2, t2))
            m4_3, s02_3, t0_3, t2_3 = F.triples(m4, s02, t0, t2)
            (t2_4,) = F.adds((t2_2, t2_2))
            (t2_8,) = F.adds((t2_4, t2_4))
            (t2_9,) = F.adds((t2_8, t2))
            z_a, x_a, t1n = F.subs((b3t2, m4_3), (t1, b3t2), (t0_3, t2_3))
            Z3, x_b, u = F.adds((z_a, s02_3), (x_a, m4_3), (t0_3, t2_9))
            X3, t4n = F.subs((x_b, s02_3), (b3t4, u))
            (Z3,) = F.adds((t1, Z3))
    y3a, y3b, x3b, x3a, z3b, z3a = F.muls((X3, Z3), (t1n, t4n), (t5, t4n),
                                          (t3, X3), (t3, t1n), (t5, Z3))
    (X,) = F.subs((x3a, x3b))
    Y, Z = F.adds((y3a, y3b), (z3a, z3b))
    return X, Y, Z


def _dbl_body(F: PlainField, kind: int, X, Y, Z):
    t0, t1, t2 = F.sqrs(X, Y, Z)
    xy, xz, yz = F.muls((X, Y), (X, Z), (Y, Z))
    t3, Z3w, t2d = F.adds((xy, xy), (xz, xz), (yz, yz))
    if kind == A_GENERIC:
        b3t2, b3z3, az3, at2, at0, a2t2 = F.muls(
            (t2, F.B3), (Z3w, F.B3), (Z3w, F.A), (t2, F.A), (t0, F.A),
            (t2, F.A2))
        (t0_3,) = F.triples(t0)
        (d,) = F.subs((at0, a2t2))
        Y3w, t0n, t3n = F.adds((az3, b3t2), (t0_3, at2), (d, b3z3))
        (X3w,) = F.subs((t1, Y3w))
        (Y3w,) = F.adds((t1, Y3w))
    else:
        b3t2, b3z3 = F.muls((t2, F.B3), (Z3w, F.B3))
        if kind == A_ZERO:
            (X3w,) = F.subs((t1, b3t2))
            (Y3w,) = F.adds((t1, b3t2))
            t3n = b3z3
            (t0n,) = F.triples(t0)
        else:                                   # a = -3
            z3x3, t0_3, t2_3 = F.triples(Z3w, t0, t2)
            (t2_2,) = F.adds((t2, t2))
            (t2_4,) = F.adds((t2_2, t2_2))
            (t2_8,) = F.adds((t2_4, t2_4))
            (t2_9,) = F.adds((t2_8, t2))
            y_a, x_a, t0n = F.subs((b3t2, z3x3), (t1, b3t2), (t0_3, t2_3))
            X3w, Y3w, u = F.adds((x_a, z3x3), (t1, y_a), (t0_3, t2_9))
            (t3n,) = F.subs((b3z3, u))
    y3m, y3t, x3t, x3m, z3m = F.muls((X3w, Y3w), (t0n, t3n), (t2d, t3n),
                                     (t3, X3w), (t2d, t1))
    (X3,) = F.subs((x3m, x3t))
    Y3, z2 = F.adds((y3m, y3t), (z3m, z3m))
    (Z3,) = F.adds((z2, z2))
    return X3, Y3, Z3


def to_jac_body(F: PlainField, X, Y, Z):
    """homog -> Jacobian; Z = 0 lanes take the representative (1, 1, 0)."""
    inf = nn.is_zero_mask(Z)[None]
    (zz,) = F.sqrs(Z)
    xz, yzz = F.muls((X, Z), (Y, zz))
    return torch.where(inf, F.one, xz), torch.where(inf, F.one, yzz), Z


def jdbl_body(F: PlainField, kind: int, X, Y, Z):
    """One Jacobian doubling, dbl-2001-b."""
    delta, gamma = F.sqrs(Z, Y)
    if kind == A_M3:
        (xmd,) = F.subs((X, delta))
        xpd, ypz = F.adds((X, delta), (Y, Z))
        beta, m = F.muls((X, gamma), (xmd, xpd))
        (alpha,) = F.triples(m)
    else:
        (ypz,) = F.adds((Y, Z))
        x2, d2 = F.sqrs(X, delta)
        (beta,) = F.muls((X, gamma))
        (x2_3,) = F.triples(x2)
        if kind == A_ZERO:
            alpha = x2_3
        else:
            (ad2,) = F.muls((d2, F.A))
            (alpha,) = F.adds((x2_3, ad2))
    alpha_sq, yz2, g2 = F.sqrs(alpha, ypz, gamma)
    b2, g2_2, gd = F.adds((beta, beta), (g2, g2), (gamma, delta))
    b4, g4 = F.adds((b2, b2), (g2_2, g2_2))
    b8, g8 = F.adds((b4, b4), (g4, g4))
    (b12,) = F.adds((b8, b4))
    X3, Z3, t = F.subs((alpha_sq, b8), (yz2, gd), (b12, alpha_sq))
    (at,) = F.muls((alpha, t))
    (Y3,) = F.subs((at, g8))
    return X3, Y3, Z3


def from_jac_body(F: PlainField, X, Y, Z):
    """Jacobian -> homog (X*Z : Y : Z^3)."""
    (zz,) = F.sqrs(Z)
    xz, z3 = F.muls((X, Z), (zz, Z))
    return xz, Y, z3


def dbln_jac_body(F: PlainField, kind: int, X, Y, Z, ndbl: int):
    """2^ndbl * (X : Y : Z) for public points: to_jac with the identity
    select, ndbl Jacobian doublings, from_jac."""
    J = to_jac_body(F, X, Y, Z)
    for _ in range(ndbl):
        J = jdbl_body(F, kind, *J)
    return from_jac_body(F, *J)


def point_add_plain(curve, P, Q):
    """Plain version of kernel 2."""
    F = PlainField(curve, P.x)
    return type(P)(*_add_body(F, a_kind(curve), *P, *Q))


def point_dbl_plain(curve, P):
    """Plain version of kernel 3."""
    F = PlainField(curve, P.x)
    return type(P)(*_dbl_body(F, a_kind(curve), *P))


def point_dbln_add_plain(curve, P, Q, ndbl: int):
    """Plain version of kernel 5: 2^ndbl * P + Q."""
    F = PlainField(curve, P.x)
    kind = a_kind(curve)
    return type(P)(*_add_body(F, kind, *dbln_jac_body(F, kind, *P, ndbl),
                              *Q))


# -- kernel wrappers -------------------------------------------------------

def _check_point(curve, P, what):
    """Raise unless the coordinates P (of one or more points) are operands
    the kernels take, all of one shape."""
    for i, t in enumerate(P):
        check_operand(t, curve.fp_ctx, f"{what} coordinate {i}")
        if t.shape != P[0].shape:
            raise ValueError(f"{what}: coordinates differ in shape")


def _launch(base, curve, ins, *extra):
    """Launch point_add / point_dbl / point_dbln_add on the card: the three
    output coordinates."""
    k, kind = curve.fp_ctx.k, a_kind(curve)
    stem, bases, tag = BUILT.get((k, kind), (None, (), ""))
    if base not in bases:
        built = ", ".join(f"(K = {k_}, {A_NAMES[a]})"
                          for (k_, a), (_, bs, _) in BUILT.items()
                          if base in bs)
        raise ValueError(f"{base}: the CUDA kernel is built for {built}, "
                         f"not {curve.name} (K = {k}, {A_NAMES[kind]})")
    _check_point(curve, ins, f"{base} operands")
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    rc = getattr(_lib(stem), _entry(base, k, tag))(
        ctypes.byref(curve_struct(curve)), ptr_array(ins), ptr_array(out),
        ins[0].shape[1], *extra, _stream())
    name = _count_name(base, k, tag)
    build.check(rc, name)
    launches[name] += 1
    return out


def point_add(curve, P, Q):
    """P + Q, complete; kernel 2 for tensors on the card."""
    if P.x.device.type == "cpu":
        return point_add_plain(curve, P, Q)
    return type(P)(*_launch("point_add", curve, [*P, *Q]))


def point_dbl(curve, P):
    """2P, complete; kernel 3 for tensors on the card."""
    if P.x.device.type == "cpu":
        return point_dbl_plain(curve, P)
    return type(P)(*_launch("point_dbl", curve, list(P)))


def point_dbln_add(curve, P, Q, ndbl: int):
    """2^ndbl * P + Q for public points; kernel 5 for tensors on the card."""
    if P.x.device.type == "cpu":
        return point_dbln_add_plain(curve, P, Q, ndbl)
    if ndbl < 0:
        raise ValueError("point_dbln_add: ndbl must be >= 0")
    return type(P)(*_launch("point_dbln_add", curve, [*P, *Q], ndbl))
