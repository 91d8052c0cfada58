"""Kernels 4 and 7: the whole fixed-window scalar multiply
(``csrc/windowed.cu``).

Counterpart of ``libecc_tpu/ops/pallas/megamul.py:windowed_mul`` with
npairs 1, in its two models. The model follows the point class: three
coordinates is short Weierstrass (kernel 4, model ``w``), four is twisted
Edwards (kernel 7, model ``ed``).

* Short Weierstrass, per window, most significant first: the Jacobian
  doubling block (to_jac with the identity select, w dbl-2001-b
  doublings, from_jac), then the complete add of the lane's table entry.
* Twisted Edwards (a = -1): the accumulator starts at (0 : 1 : 1 : 0);
  per window w dbl-2008-hwcd doublings, then one extended add of the
  lane's entry. The formulas are complete, so there is no identity select.

The kernels read the entry by index, so they serve PUBLIC scalars only
(see the note in the CUDA source). The TPU kernel's VMEM sizing and its
w -> w-1 fallback have no counterpart: the kernels are built for K = 8 at
w = 4, and ``windowed_mul`` raises on any other shape for a tensor on the
card.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, edpoint
from .mont import _stream, _ptr
from .point import (PlainField, _add_body, a_kind, curve_struct,
                    from_jac_body, jdbl_body, ptr_array, to_jac_body,
                    CurveCtx8)

launches = {"windowed_mul": 0, "windowed_mul_ed": 0}

WINDOW = 4


def supported(curve, w: int) -> bool:
    return curve.fp_ctx.k == 8 and w == WINDOW


def _lib():
    lib = build.library("windowed")
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.windowed_mul_k8_w4.argtypes = [
            ctypes.POINTER(CurveCtx8), vp, ctypes.c_int, vp, vp, ll, vp]
        lib.windowed_mul_ed_k8_w4.argtypes = [
            ctypes.POINTER(edpoint.EdCurveCtx8), vp, ctypes.c_int, vp, vp,
            ll, vp]
        for fn in (lib.windowed_mul_k8_w4, lib.windowed_mul_ed_k8_w4):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _is_edwards(point_cls) -> bool:
    return len(point_cls._fields) == 4


def windowed_mul_plain(curve, table: torch.Tensor, digs: torch.Tensor,
                       point_cls):
    """Plain version of kernels 4 and 7. table: int32[2^w, ncoord, K, N]
    with entry d = d*P; digs: int32[nwin, N] MSW-first w-bit digits."""
    w = (table.shape[0] - 1).bit_length()
    ed = _is_edwards(point_cls)
    if ed:
        F = edpoint.EdPlainField(curve, table[0, 0])
    else:
        kind = a_kind(curve)
        F = PlainField(curve, table[0, 0])
    acc = curve.pinf(like=point_cls(*table[0]))
    idx_shape = (1,) + table.shape[1:]
    for wi in range(digs.shape[0]):
        if ed:
            for _ in range(w):
                acc = edpoint.dbl_body(F, curve, *acc[:3])
        else:
            Xj, Yj, Zj = to_jac_body(F, *acc)
            for _ in range(w):
                Xj, Yj, Zj = jdbl_body(F, kind, Xj, Yj, Zj)
            acc = from_jac_body(F, Xj, Yj, Zj)
        d = digs[wi].to(torch.int64).view(1, 1, 1, -1).expand(idx_shape)
        T = torch.gather(table, 0, d)[0]
        acc = (edpoint.add_body(F, curve, *acc, *T) if ed
               else _add_body(F, kind, *acc, *T))
    return point_cls(*acc)


def windowed_mul(curve, table: torch.Tensor, digs: torch.Tensor, point_cls):
    """Whole windowed m*P for public scalars; kernel 4 (three coordinates)
    or kernel 7 (four) on the card."""
    if table.device.type == "cpu":
        return windowed_mul_plain(curve, table, digs, point_cls)
    ed = _is_edwards(point_cls)
    if ed:
        edpoint.check_curve(curve, "windowed_mul")
    k = curve.fp_ctx.k
    w = (table.shape[0] - 1).bit_length()
    if not supported(curve, w):
        raise ValueError(f"windowed_mul: the CUDA kernel takes K = 8 and "
                         f"w = {WINDOW}, not K = {k}, w = {w}")
    n = table.shape[-1]
    ncoord = len(point_cls._fields)
    if (table.dtype != torch.int32 or not table.is_contiguous()
            or tuple(table.shape) != (1 << WINDOW, ncoord, k, n)):
        raise ValueError("windowed_mul: table must be a contiguous int32 "
                         f"[16, {ncoord}, {k}, N] tensor")
    if (digs.dtype != torch.int32 or not digs.is_contiguous()
            or digs.dim() != 2 or digs.shape[1] != n
            or digs.device != table.device):
        raise ValueError("windowed_mul: digits must be a contiguous int32 "
                         "[nwin, N] tensor on the table's device")
    out = [torch.empty((k, n), dtype=torch.int32, device=table.device)
           for _ in range(ncoord)]
    if ed:
        rc = _lib().windowed_mul_ed_k8_w4(
            ctypes.byref(edpoint.curve_struct(curve)), _ptr(digs),
            digs.shape[0], _ptr(table), ptr_array(out), n, _stream())
        name = "windowed_mul_ed"
    else:
        rc = _lib().windowed_mul_k8_w4(
            ctypes.byref(curve_struct(curve)), _ptr(digs), digs.shape[0],
            _ptr(table), ptr_array(out), n, _stream())
        name = "windowed_mul"
    build.check(rc, name)
    launches[name] += 1
    return point_cls(*out)
