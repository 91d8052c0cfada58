"""Kernels 4, 6, 7 and 6-ed: the whole fixed-window scalar multiply and the
whole Straus dual multiply (``csrc/windowed.cu``; the other instances in
``csrc/windowed_wide.cu``, ``windowed_wide_alt.cu``, ``windowed_small.cu``,
``windowed_p521.cu``, ``windowed_wei448.cu``, ``windowed_ed448.cu``,
``straus_wide.cu``, ``straus_wide_alt.cu``, ``straus_small.cu``,
``straus_p521.cu``, ``straus_wei448.cu`` and ``straus_ed448.cu``).

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
K = 14 (Edwards a = 1, Ed448), and for kernels 4 and 6 at K = 6 and 7
(every a), K = 10 and 12 (a = -3 and generic a), K = 14 (generic a:
WEI448), K = 16 (a = -3 and generic a: the 512-bit curves) and K = 17
(a = -3, P-521). The K = 14, 16 and 17 instances are the counterpart of
the TPU's large-K ``rows.py:RowOps`` backend. All four kernels run a
group of two or four threads a lane at every K (``csrc/groupfield.cuh``,
whose ``GroupShape`` sets the shape at each K); the wrappers and the
layouts are the same. The
wrappers raise on any other shape or a for a tensor on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, edpoint
from .build import kernel_name
from .mont import _stream
from .point import (A_GENERIC, A_M3, A_NAMES, A_TAGS, PlainField,
                    _add_body, a_kind, curve_ctx_type, curve_struct,
                    dbln_jac_body, ptr_array)

WINDOW = 4

# The built instances: (K, model, number of pairs, a_kind) -> kernel name,
# C entry point and library (csrc/<stem>.cu). a_kind None: every a, one
# formula set per a chosen at launch (K = 8). Model "w" is short
# Weierstrass (three coordinates, point.A_* kinds), "ed" twisted Edwards
# (four, edpoint.A_* kinds). The instances other than K = 8 and kernel 7
# at K = 14 are named by their C entry points; those of a K built for
# more than one a carry the a's tag (point.A_TAGS: "straus_mul_k6_m3_w4").
# The support check, the ctypes typing and the launch counts derive from
# this table.
A_M1, A_1 = edpoint.A_M1, edpoint.A_1
_KERNELS = {
    (8, "w", 1, None): ("windowed_mul", "windowed_mul_k8_w4", "windowed"),
    (8, "ed", 1, A_M1): ("windowed_mul_ed", "windowed_mul_ed_k8_w4",
                         "windowed"),
    (8, "w", 2, None): ("straus_mul", "straus_mul_k8_w4", "windowed"),
    (8, "ed", 2, A_M1): ("straus_mul_ed", "straus_mul_ed_k8_w4",
                         "windowed"),
    (14, "ed", 1, A_1): (kernel_name("windowed_mul_ed", 14),
                         "windowed_mul_ed_k14_w4", "windowed_ed448"),
    (12, "w", 1, A_M3): ("windowed_mul_k12_w4", "windowed_mul_k12_w4",
                         "windowed_wide"),
    (16, "w", 1, A_GENERIC): ("windowed_mul_k16_w4", "windowed_mul_k16_w4",
                              "windowed_wide"),
    (17, "w", 1, A_M3): ("windowed_mul_k17_w4", "windowed_mul_k17_w4",
                         "windowed_p521"),
    (12, "w", 2, A_M3): ("straus_mul_k12_w4", "straus_mul_k12_w4",
                         "straus_wide"),
    (16, "w", 2, A_GENERIC): ("straus_mul_k16_w4", "straus_mul_k16_w4",
                              "straus_wide"),
    (17, "w", 2, A_M3): ("straus_mul_k17_w4", "straus_mul_k17_w4",
                         "straus_p521"),
    (14, "ed", 2, A_1): ("straus_mul_ed_k14_w4", "straus_mul_ed_k14_w4",
                         "straus_ed448")}
# kernels 4 and 6 at K = 6, 7 (every a) and 10 (a = -3, generic a), at
# K = 12 (generic a) and 16 (a = -3), and at K = 14 (generic a: WEI448)
for _k, _kinds, _sfx in ((6, A_TAGS, "small"), (7, A_TAGS, "small"),
                         (10, (A_M3, A_GENERIC), "small"),
                         (12, (A_GENERIC,), "wide_alt"),
                         (16, (A_M3,), "wide_alt"),
                         (14, (A_GENERIC,), "wei448")):
    for _a in _kinds:
        for _np, _base in ((1, "windowed"), (2, "straus")):
            _name = f"{_base}_mul_k{_k}_{A_TAGS[_a]}_w4"
            _KERNELS[(_k, "w", _np, _a)] = (_name, _name, f"{_base}_{_sfx}")

launches = {inst[0]: 0 for inst in _KERNELS.values()}


def _a_kind(curve, model: str) -> int:
    return edpoint.a_kind(curve) if model == "ed" else a_kind(curve)


def _a_name(kind, model: str) -> str:
    if kind is None:
        return "every a"
    return f"a = {edpoint.a_name(kind)}" if model == "ed" else A_NAMES[kind]


def instance(curve, model: str, npairs: int):
    """The built instance (kernel name, C entry point, library stem) of
    the model and number of pairs for the curve's K and a, or None."""
    k = curve.fp_ctx.k
    return (_KERNELS.get((k, model, npairs, _a_kind(curve, model)))
            or _KERNELS.get((k, model, npairs, None)))


def kernel_name_of(curve, npairs: int, model: str = "w") -> str:
    """The name under which the curve's kernel 4 (npairs 1) or 6 (npairs
    2) counts its launches (7 and 6-ed with model "ed"); KeyError where it
    is not built."""
    inst = instance(curve, model, npairs)
    if inst is None:
        raise KeyError(f"no {model} kernel with {npairs} pair(s) is built "
                       f"for {curve.name}")
    return inst[0]


def supported(curve, w: int, model: str, npairs: int) -> bool:
    """Whether a kernel is built for this curve's K and a, the model, the
    number of pairs and the window width."""
    return w == WINDOW and instance(curve, model, npairs) is not None


def _lib(stem: str):
    lib = build.library(stem)
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for (k, model, _, _), (_, cname, lib_stem) in _KERNELS.items():
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
            for (k_, m, n_, a) in _KERNELS if (m, n_) == (model, npairs))
        raise ValueError(f"megamul ({model}, {npairs} pair(s)): the CUDA "
                         f"kernel is built for {built} and w = {WINDOW}, "
                         f"not {curve.name} (K = {k}, "
                         f"{_a_name(_a_kind(curve, model), model)}), "
                         f"w = {w}")
    name, cname, stem = instance(curve, model, npairs)
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
