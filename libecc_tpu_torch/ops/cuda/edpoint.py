"""Kernels 8a, 8b and 8c: twisted-Edwards extended add, double and the
fused n doublings plus one add (``csrc/edpoint.cu``).

Counterparts of ``libecc_tpu/ops/pallas/edpoint.py:point_add`` /
``point_dbl`` / ``point_dbln_add``. The plain versions below evaluate the
reference's bodies (``_add_body`` :49, ``_dbl_body`` :75) operation for
operation on plain tensor field operations, for every a (add-2008-hwcd-3
for a = -1, add-2008-hwcd otherwise; dbl-2008-hwcd). Kernels 8a and 8b
are built for a = -1 at K = 8 (Ed25519) and a = 1 at K = 14 (Ed448, where
they stand for the TPU's large-K ``rows.py:RowOps`` backend), and so is
kernel 8c (``BUILT``). Kernels 8a and 8b run a group of four threads a
lane (``csrc/groupfield.cuh``'s ``AddShape``), 8c one thread a lane.
On the card any other (K, a) raises.
Wrappers launch the kernels for tensors on the card and take the plain
versions only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .build import kernel_name
from .mont import field_ctx_type, field_struct, mont_limbs, _stream
from .point import PlainField, _check_point, ptr_array

A_M1, A_1 = 1, 2        # ecc::ED_A_M1, ecc::ED_A_1

# The built instances: C entry base -> {K: a_kind}. a = -1 at K = 8
# (Ed25519), a = 1 at K = 14 (Ed448). The support checks, the ctypes typing
# and the launch counts all derive from this table.
BUILT = {"ed_add": {8: A_M1, 14: A_1}, "ed_dbl": {8: A_M1, 14: A_1},
         "ed_dbln_add": {8: A_M1, 14: A_1}}

launches = {kernel_name(base, k): 0 for base, ks in BUILT.items()
            for k in ks}


@functools.lru_cache(maxsize=None)
def ed_curve_ctx_type(k: int) -> type:
    """ctypes mirror of ecc::EdCurveCtx<k> (csrc/edpoint.cuh)."""
    fe = ctypes.c_uint32 * k
    return type(f"EdCurveCtx{k}", (ctypes.Structure,), {"_fields_": [
        ("f", field_ctx_type(k)), ("one", fe), ("d2", fe), ("d", fe),
        ("a_kind", ctypes.c_int32)]})


def a_kind(curve) -> int:
    return A_M1 if curve.a_is_m1 else A_1 if curve.a_is_1 else 0


def curve_struct(curve):
    """Curve constants for the kernels, Montgomery form."""
    s = getattr(curve, "_cuda_struct", None)
    if s is None:
        ctx = curve.fp_ctx
        s = ed_curve_ctx_type(ctx.k)(
            field_struct(ctx), mont_limbs(ctx, 1), mont_limbs(ctx, curve.d2),
            mont_limbs(ctx, curve.d), a_kind(curve))
        curve._cuda_struct = s
    return s


def a_name(kind: int) -> str:
    return "-1" if kind == A_M1 else "1"


def check_curve(curve, built: dict, what: str) -> None:
    """Raise unless a kernel built for {K: a_kind} takes this curve."""
    k, kind = curve.fp_ctx.k, a_kind(curve)
    if kind == 0 or built.get(k) != kind:
        names = ", ".join(f"(K = {k_}, a = {a_name(a)})"
                          for k_, a in built.items())
        raise ValueError(f"{what}: the CUDA kernel is built for {names}, "
                         f"not {curve.name} (K = {k}, a = {curve.a})")


def _lib():
    lib = build.library("edpoint")
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for base, ks in BUILT.items():
            ndbl = [ctypes.c_int] if base == "ed_dbln_add" else []
            for k in ks:
                fn = getattr(lib, f"{base}_k{k}")
                fn.argtypes = [ctypes.POINTER(ed_curve_ctx_type(k)), vp, vp,
                               ll, *ndbl, vp]
                fn.restype = ctypes.c_int
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

def _launch(base, curve, ins, *extra):
    """Launch ed_add / ed_dbl / ed_dbln_add at the curve's K on the card:
    the four output coordinates."""
    check_curve(curve, BUILT[base], base)
    _check_point(curve, ins, f"{base} operands")
    k = curve.fp_ctx.k
    out = [torch.empty_like(ins[0]) for _ in range(4)]
    rc = getattr(_lib(), f"{base}_k{k}")(
        ctypes.byref(curve_struct(curve)), ptr_array(ins), ptr_array(out),
        ins[0].shape[1], *extra, _stream())
    name = kernel_name(base, k)
    build.check(rc, name)
    launches[name] += 1
    return out


def ed_add(curve, P, Q):
    """P + Q, unified; kernel 8a for tensors on the card."""
    if P.x.device.type == "cpu":
        return ed_add_plain(curve, P, Q)
    return type(P)(*_launch("ed_add", curve, [*P, *Q]))


def ed_dbl(curve, P):
    """2P; kernel 8b for tensors on the card."""
    if P.x.device.type == "cpu":
        return ed_dbl_plain(curve, P)
    return type(P)(*_launch("ed_dbl", curve, list(P[:3])))


def ed_dbln_add(curve, P, Q, ndbl: int):
    """2^ndbl * P + Q; kernel 8c for tensors on the card."""
    if P.x.device.type == "cpu":
        return ed_dbln_add_plain(curve, P, Q, ndbl)
    if ndbl < 0:
        raise ValueError("ed_dbln_add: ndbl must be >= 0")
    return type(P)(*_launch("ed_dbln_add", curve, [*P, *Q], ndbl))
