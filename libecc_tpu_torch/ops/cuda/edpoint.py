"""Kernels 8a, 8b and 8c: twisted-Edwards extended add, double and the
fused n doublings plus one add (``csrc/edpoint.cu``).

Counterparts of ``libecc_tpu/ops/pallas/edpoint.py:point_add`` /
``point_dbl`` / ``point_dbln_add``. The plain versions below evaluate the
reference's bodies (``_add_body`` :49, ``_dbl_body`` :75) operation for
operation on plain tensor field operations, for every a (add-2008-hwcd-3
for a = -1, add-2008-hwcd otherwise; dbl-2008-hwcd). The kernels cover
a = -1, the only K = 8 Edwards curve (Ed25519); on the card any other a
raises. Wrappers launch the kernels for tensors on the card and take the
plain versions only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ...nn import core as nn
from . import build
from .mont import FieldCtx8, field_struct, _stream
from .point import PlainField, _check_point, ptr_array

launches = {"ed_add": 0, "ed_dbl": 0, "ed_dbln_add": 0}

A_M1 = 1                # ecc::ED_A_M1; the kernels refuse any other a


class EdCurveCtx8(ctypes.Structure):
    """ecc::EdCurveCtx<8> of csrc/edpoint.cuh."""
    _fields_ = [("f", FieldCtx8), ("one", ctypes.c_uint32 * 8),
                ("d2", ctypes.c_uint32 * 8), ("a_kind", ctypes.c_int32)]


def curve_struct(curve) -> EdCurveCtx8:
    """Curve constants for the kernels, Montgomery form."""
    s = getattr(curve, "_cuda_struct", None)
    if s is None:
        ctx = curve.fp_ctx
        p = ctx.p_int

        def mont(v):
            return (ctypes.c_uint32 * 8)(
                *[int(x) for x in nn.to_limbs(v % p * ctx.R % p, ctx.k)])

        s = EdCurveCtx8(field_struct(ctx), mont(1), mont(curve.d2),
                        A_M1 if curve.a_is_m1 else 0)
        curve._cuda_struct = s
    return s


def check_curve(curve, what: str) -> None:
    """Raise unless the kernels take this curve (a = -1; K is checked with
    the operands)."""
    if not curve.a_is_m1:
        raise ValueError(f"{what}: the CUDA kernels take a = -1 curves, not "
                         f"{curve.name}")


def _lib():
    lib = build.library("edpoint")
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for fn in (lib.ed_add_k8, lib.ed_dbl_k8):
            fn.argtypes = [ctypes.POINTER(EdCurveCtx8), vp, vp, ll, vp]
            fn.restype = ctypes.c_int
        lib.ed_dbln_add_k8.argtypes = [ctypes.POINTER(EdCurveCtx8), vp, vp,
                                       ll, ctypes.c_int, vp]
        lib.ed_dbln_add_k8.restype = ctypes.c_int
        lib._typed = True
    return lib


# -- plain versions --------------------------------------------------------

class EdPlainField(PlainField):
    """Grouped plain field operations with an Edwards curve's constants."""

    def __init__(self, curve, like: torch.Tensor):
        self.ctx = ctx = curve.fp_ctx
        self.A = ctx.const(curve.a, like=like)
        self.D = ctx.const(curve.d, like=like)
        self.D2 = ctx.const(curve.d2, like=like)
        self.one = ctx.const(1, like=like)


def add_body(fl: EdPlainField, curve, X1, Y1, Z1, T1, X2, Y2, Z2, T2):
    if curve.a_is_m1:
        d1, d2 = fl.subs((Y1, X1), (Y2, X2))
        s1, s2 = fl.adds((Y1, X1), (Y2, X2))
        A, B, tt, Dm = fl.muls((d1, d2), (s1, s2), (T1, T2), (Z1, Z2))
        (Cm,) = fl.muls((tt, fl.D2))
        (Dm,) = fl.adds((Dm, Dm))
        E, F = fl.subs((B, A), (Dm, Cm))
        G, H = fl.adds((Dm, Cm), (B, A))
    else:
        sx1, sx2 = fl.adds((X1, Y1), (X2, Y2))
        A, B, tt, Dm, E0 = fl.muls((X1, X2), (Y1, Y2), (T1, T2), (Z1, Z2),
                                   (sx1, sx2))
        (Cm,) = fl.muls((tt, fl.D))
        E, F = fl.subs((E0, A), (Dm, Cm))
        (E,) = fl.subs((E, B))
        (G,) = fl.adds((Dm, Cm))
        aA = A if curve.a_is_1 else fl.muls((A, fl.A))[0]
        (H,) = fl.subs((B, aA))
    X3, Y3, Z3, T3 = fl.muls((E, F), (G, H), (F, G), (E, H))
    return X3, Y3, Z3, T3


def dbl_body(fl: EdPlainField, curve, X1, Y1, Z1):
    (xy,) = fl.adds((X1, Y1))
    A, B, Cs, E0 = fl.sqrs(X1, Y1, Z1, xy)
    D = A if curve.a_is_1 else fl.muls((A, fl.A))[0]
    (E,) = fl.subs((E0, A))
    (E,) = fl.subs((E, B))
    G, Cs2 = fl.adds((D, B), (Cs, Cs))
    F, H = fl.subs((G, Cs2), (D, B))
    X3, Y3, Z3, T3 = fl.muls((E, F), (G, H), (F, G), (E, H))
    return X3, Y3, Z3, T3


def ed_add_plain(curve, P, Q):
    """Plain version of kernel 8a."""
    return type(P)(*add_body(EdPlainField(curve, P.x), curve, *P, *Q))


def ed_dbl_plain(curve, P):
    """Plain version of kernel 8b (reads X, Y, Z; T is not used)."""
    return type(P)(*dbl_body(EdPlainField(curve, P.x), curve, *P[:3]))


def ed_dbln_add_plain(curve, P, Q, ndbl: int):
    """Plain version of kernel 8c: ndbl doublings of P, then + Q (with
    ndbl = 0, the add of P, T included)."""
    fl = EdPlainField(curve, P.x)
    acc = tuple(P)
    for _ in range(ndbl):
        acc = dbl_body(fl, curve, *acc[:3])
    return type(P)(*add_body(fl, curve, *acc, *Q))


# -- kernel wrappers -------------------------------------------------------

def ed_add(curve, P, Q):
    """P + Q, unified; kernel 8a for tensors on the card."""
    if P.x.device.type == "cpu":
        return ed_add_plain(curve, P, Q)
    check_curve(curve, "ed_add")
    _check_point(curve, P, "ed_add P")
    _check_point(curve, Q, "ed_add Q")
    if Q.x.shape != P.x.shape:
        raise ValueError("ed_add: P and Q differ in shape")
    out = [torch.empty_like(P.x) for _ in range(4)]
    rc = _lib().ed_add_k8(ctypes.byref(curve_struct(curve)),
                          ptr_array([*P, *Q]), ptr_array(out),
                          P.x.shape[1], _stream())
    build.check(rc, "ed_add")
    launches["ed_add"] += 1
    return type(P)(*out)


def ed_dbl(curve, P):
    """2P; kernel 8b for tensors on the card."""
    if P.x.device.type == "cpu":
        return ed_dbl_plain(curve, P)
    check_curve(curve, "ed_dbl")
    _check_point(curve, P[:3], "ed_dbl P")
    out = [torch.empty_like(P.x) for _ in range(4)]
    rc = _lib().ed_dbl_k8(ctypes.byref(curve_struct(curve)),
                          ptr_array(list(P[:3])), ptr_array(out),
                          P.x.shape[1], _stream())
    build.check(rc, "ed_dbl")
    launches["ed_dbl"] += 1
    return type(P)(*out)


def ed_dbln_add(curve, P, Q, ndbl: int):
    """2^ndbl * P + Q; kernel 8c for tensors on the card."""
    if P.x.device.type == "cpu":
        return ed_dbln_add_plain(curve, P, Q, ndbl)
    check_curve(curve, "ed_dbln_add")
    _check_point(curve, P, "ed_dbln_add P")
    _check_point(curve, Q, "ed_dbln_add Q")
    if Q.x.shape != P.x.shape:
        raise ValueError("ed_dbln_add: P and Q differ in shape")
    if ndbl < 0:
        raise ValueError("ed_dbln_add: ndbl must be >= 0")
    out = [torch.empty_like(P.x) for _ in range(4)]
    rc = _lib().ed_dbln_add_k8(ctypes.byref(curve_struct(curve)),
                               ptr_array([*P, *Q]), ptr_array(out),
                               P.x.shape[1], ndbl, _stream())
    build.check(rc, "ed_dbln_add")
    launches["ed_dbln_add"] += 1
    return type(P)(*out)
