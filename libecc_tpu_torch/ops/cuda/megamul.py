"""Kernels 4, 6, 7 and 6-ed: the whole fixed-window scalar multiply and the
whole Straus dual multiply (``csrc/windowed.cu``; the wide instances in
``csrc/windowed_wide.cu``, ``windowed_p521.cu``, ``straus_wide.cu`` and
``straus_ed448.cu``).

Counterpart of ``libecc_tpu/ops/pallas/megamul.py``: ``windowed_mul``
(npairs 1) and ``straus_mul`` (npairs 2), each in two models. The model
follows the point class: three coordinates is short Weierstrass (kernels 4
and 6, model ``w``), four is twisted Edwards (kernels 7 and 6-ed, model
``ed``).

* Short Weierstrass, per window, most significant first: the Jacobian
  doubling block (to_jac with the identity select, w dbl-2001-b
  doublings, from_jac), then one complete add of the lane's entry of each
  table, in the order the tables are given.
* Twisted Edwards: the accumulator starts at (0 : 1 : 1 : 0); per window
  w dbl-2008-hwcd doublings, then one extended add of the lane's entry of
  each table. The formulas are complete, so there is no identity select.

The kernels read the entry by index, so they serve PUBLIC scalars only
(see the note in the CUDA source). The TPU kernel's VMEM sizing and its
w -> w-1 fallback have no counterpart: the kernels are built at w = 4 for
K = 8 (all four; every a, Edwards a = -1), for kernels 7 and 6-ed at
K = 14 (Edwards a = 1, Ed448), for kernels 4 and 6 at K = 12 (a = -3,
P-384) and K = 16 (generic a: the 512-bit curves), and for kernel 4 at
K = 17 (a = -3, P-521). The K = 14, 16 and 17 instances are the
counterpart of the TPU's large-K ``rows.py:RowOps`` backend. The
wrappers raise on any other shape or a for a tensor on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, edpoint
from .build import kernel_name
from .mont import _stream
from .point import (A_GENERIC, A_M3, A_NAMES, PlainField, _add_body,
                    a_kind, curve_ctx_type, curve_struct, dbln_jac_body,
                    ptr_array)

WINDOW = 4

# The built instances: (K, model, number of pairs) -> kernel name, C entry
# point, the a_kind the formulas are built for (None: every a, one formula
# set per a chosen at launch) and the library (csrc/<stem>.cu). Model "w"
# is short Weierstrass (three coordinates, point.A_* kinds), "ed" twisted
# Edwards (four, edpoint.A_* kinds). The wide instances other than kernel
# 7 at K = 14 (K = 12 for P-384, K = 16 for the 512-bit curves, K = 17 for
# P-521, the Straus kernels at K = 12, 14 and 16) are named by their C
# entry points. The support check, the ctypes typing and the launch counts
# derive from this table.
A_M1, A_1 = edpoint.A_M1, edpoint.A_1
_KERNELS = {
    (8, "w", 1): ("windowed_mul", "windowed_mul_k8_w4", None, "windowed"),
    (8, "ed", 1): ("windowed_mul_ed", "windowed_mul_ed_k8_w4", A_M1,
                   "windowed"),
    (8, "w", 2): ("straus_mul", "straus_mul_k8_w4", None, "windowed"),
    (8, "ed", 2): ("straus_mul_ed", "straus_mul_ed_k8_w4", A_M1,
                   "windowed"),
    (14, "ed", 1): (kernel_name("windowed_mul_ed", 14),
                    "windowed_mul_ed_k14_w4", A_1, "windowed"),
    (12, "w", 1): ("windowed_mul_k12_w4", "windowed_mul_k12_w4", A_M3,
                   "windowed_wide"),
    (16, "w", 1): ("windowed_mul_k16_w4", "windowed_mul_k16_w4", A_GENERIC,
                   "windowed_wide"),
    (17, "w", 1): ("windowed_mul_k17_w4", "windowed_mul_k17_w4", A_M3,
                   "windowed_p521"),
    (12, "w", 2): ("straus_mul_k12_w4", "straus_mul_k12_w4", A_M3,
                   "straus_wide"),
    (16, "w", 2): ("straus_mul_k16_w4", "straus_mul_k16_w4", A_GENERIC,
                   "straus_wide"),
    (14, "ed", 2): ("straus_mul_ed_k14_w4", "straus_mul_ed_k14_w4", A_1,
                    "straus_ed448")}

launches = {inst[0]: 0 for inst in _KERNELS.values()}


def _a_kind(curve, model: str) -> int:
    return edpoint.a_kind(curve) if model == "ed" else a_kind(curve)


def _a_name(kind, model: str) -> str:
    if kind is None:
        return "every a"
    return f"a = {edpoint.a_name(kind)}" if model == "ed" else A_NAMES[kind]


def supported(curve, w: int, model: str, npairs: int) -> bool:
    """Whether a kernel is built for this curve's K and a, the model, the
    number of pairs and the window width."""
    inst = _KERNELS.get((curve.fp_ctx.k, model, npairs))
    return (inst is not None and w == WINDOW
            and inst[2] in (None, _a_kind(curve, model)))


def _lib(stem: str):
    lib = build.library(stem)
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for (k, model, _), (_, cname, _, lib_stem) in _KERNELS.items():
            if lib_stem != stem:
                continue
            ctx = (edpoint.ed_curve_ctx_type(k) if model == "ed"
                   else curve_ctx_type(k))
            fn = getattr(lib, cname)
            fn.argtypes = [ctypes.POINTER(ctx), vp, ctypes.c_int, vp, vp, ll,
                           vp]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _is_edwards(point_cls) -> bool:
    return len(point_cls._fields) == 4


def gather_entry(table: torch.Tensor, idx: torch.Tensor, point_cls):
    """Lane i's entry idx[i] of a per-lane table int32[T, ncoord, K, N]."""
    d = idx.to(torch.int64).view(1, 1, 1, -1).expand((1,) + table.shape[1:])
    return point_cls(*torch.gather(table, 0, d)[0])


def _mul_plain(curve, tables, digits, point_cls):
    """Plain version of kernels 4, 6, 7 and 6-ed: per window, w doublings,
    then one add of each table's entry under its digits, in order."""
    w = (tables[0].shape[0] - 1).bit_length()
    ed = _is_edwards(point_cls)
    if ed:
        F = edpoint.EdPlainField(curve, tables[0][0, 0])
    else:
        kind = a_kind(curve)
        F = PlainField(curve, tables[0][0, 0])
    acc = curve.pinf(like=point_cls(*tables[0][0]))
    for wi in range(digits[0].shape[0]):
        if ed:
            for _ in range(w):
                acc = edpoint.dbl_body(F, curve, *acc[:3])
        else:
            acc = dbln_jac_body(F, kind, *acc, w)
        for table, digs in zip(tables, digits):
            T = gather_entry(table, digs[wi], point_cls)
            acc = (edpoint.add_body(F, curve, *acc, *T) if ed
                   else _add_body(F, kind, *acc, *T))
    return point_cls(*acc)


def windowed_mul_plain(curve, table: torch.Tensor, digs: torch.Tensor,
                       point_cls):
    """Plain version of kernels 4 and 7. table: int32[2^w, ncoord, K, N]
    with entry d = d*P; digs: int32[nwin, N] MSW-first w-bit digits."""
    return _mul_plain(curve, (table,), (digs,), point_cls)


def straus_mul_plain(curve, ptab, du, qtab, dv, point_cls):
    """Plain version of kernels 6 and 6-ed: u*P + v*Q from P's table with
    u's digits and Q's table with v's digits (per window P's entry is
    added first)."""
    return _mul_plain(curve, (ptab, qtab), (du, dv), point_cls)


def _launch(curve, tables, digits, point_cls):
    ed = _is_edwards(point_cls)
    model, npairs = ("ed" if ed else "w"), len(tables)
    k = curve.fp_ctx.k
    w = (tables[0].shape[0] - 1).bit_length()
    if not supported(curve, w, model, npairs):
        built = ", ".join(
            f"(K = {k_}, {_a_name(a, model)})"
            for (k_, m, n_), (_, _, a, _) in _KERNELS.items()
            if (m, n_) == (model, npairs))
        raise ValueError(f"megamul ({model}, {npairs} pair(s)): the CUDA "
                         f"kernel is built for {built} and w = {WINDOW}, "
                         f"not {curve.name} (K = {k}, "
                         f"{_a_name(_a_kind(curve, model), model)}), "
                         f"w = {w}")
    name, cname, _, stem = _KERNELS[(k, model, npairs)]
    n = tables[0].shape[-1]
    ncoord = len(point_cls._fields)
    nwin = digits[0].shape[0]
    for table, digs in zip(tables, digits):
        if (table.dtype != torch.int32 or not table.is_contiguous()
                or tuple(table.shape) != (1 << WINDOW, ncoord, k, n)
                or table.device != tables[0].device):
            raise ValueError(f"{name}: tables must be contiguous int32 "
                             f"[16, {ncoord}, {k}, N] tensors on one device")
        if (digs.dtype != torch.int32 or not digs.is_contiguous()
                or tuple(digs.shape) != (nwin, n)
                or digs.device != table.device):
            raise ValueError(f"{name}: digits must be contiguous int32 "
                             "[nwin, N] tensors on the tables' device")
    out = [torch.empty((k, n), dtype=torch.int32, device=tables[0].device)
           for _ in range(ncoord)]
    cs = edpoint.curve_struct(curve) if ed else curve_struct(curve)
    rc = getattr(_lib(stem), cname)(ctypes.byref(cs), ptr_array(digits),
                                    nwin, ptr_array(tables), ptr_array(out),
                                    n, _stream())
    build.check(rc, name)
    launches[name] += 1
    return point_cls(*out)


def windowed_mul(curve, table: torch.Tensor, digs: torch.Tensor, point_cls):
    """Whole windowed m*P for public scalars; kernel 4 (three coordinates)
    or kernel 7 (four) on the card."""
    if table.device.type == "cpu":
        return windowed_mul_plain(curve, table, digs, point_cls)
    return _launch(curve, (table,), (digs,), point_cls)


def straus_mul(curve, ptab, du, qtab, dv, point_cls):
    """Whole Straus u*P + v*Q for public scalars with separate per-base
    tables; kernel 6 (three coordinates) or kernel 6-ed (four) on the
    card."""
    if ptab.device.type == "cpu":
        return straus_mul_plain(curve, ptab, du, qtab, dv, point_cls)
    return _launch(curve, (ptab, qtab), (du, dv), point_cls)
