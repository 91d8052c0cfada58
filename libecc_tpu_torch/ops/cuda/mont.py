"""Kernel 1: batched Montgomery multiply and square (``csrc/mont.cu``).

Counterpart of ``libecc_tpu/ops/pallas/mont.py``, built for K = 6 (192-bit
moduli), K = 7 (224-bit), K = 8 (256-bit), K = 10 (320-bit), K = 12
(384-bit: P-384, the 384-bit Brainpool curves), K = 14 (448-bit: Ed448),
K = 16 (512-bit: the 512-bit curves) and K = 17 (521-bit: P-521; with
kernels 8a, 8b and 7 at K = 14 and kernels 2-4 and 6 at K = 16 and 17 the
counterpart of the TPU's large-K ``rows.py:RowOps`` backend). The
wrappers launch the CUDA kernel for tensors on the card and take the plain
version (``nn.core.mont_mul`` / ``mont_sqr``) only for tensors on the CPU.
There is no other switch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...nn import core as nn
from . import build
from .build import kernel_name

SUPPORTED_K = (6, 7, 8, 10, 12, 14, 16, 17)

# launches of each kernel (incremented only where the kernel is launched);
# the other instances count under their own names ("mont_mul_k12")
launches = {name: 0 for k in SUPPORTED_K
            for name in (kernel_name("mont_mul", k),
                         kernel_name("mont_sqr", k))}

mont_mul_plain = nn.mont_mul
mont_sqr_plain = nn.mont_sqr


@functools.lru_cache(maxsize=None)
def field_ctx_type(k: int) -> type:
    """ctypes mirror of ecc::FieldCtx<k> (csrc/field.cuh)."""
    return type(f"FieldCtx{k}", (ctypes.Structure,), {
        "_fields_": [("p", ctypes.c_uint32 * k), ("pinv", ctypes.c_uint32)]})


def mont_limbs(ctx: nn.MontCtx, v: int) -> ctypes.Array:
    """v in ctx's Montgomery form as a ctypes uint32[K] (a curve constant
    of the kernels' context structs)."""
    p = ctx.p_int
    return (ctypes.c_uint32 * ctx.k)(
        *[int(x) for x in nn.to_limbs(v % p * ctx.R % p, ctx.k)])


def field_struct(ctx: nn.MontCtx):
    """The kernels' modulus context: p and p' = -p^-1 mod 2^32."""
    s = getattr(ctx, "_cuda_struct", None)
    if s is None:
        s = field_ctx_type(ctx.k)(
            (ctypes.c_uint32 * ctx.k)(*[int(v) for v in ctx.p]), ctx.pinv32)
        ctx._cuda_struct = s
    return s


def check_operand(t: torch.Tensor, ctx: nn.MontCtx, what: str) -> None:
    """Raise unless t is a contiguous int32[K, N] CUDA tensor the kernels
    take."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32 limbs, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != ctx.k:
        raise ValueError(f"{what}: expected shape [{ctx.k}, N], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _check_k(ctx: nn.MontCtx, what: str) -> None:
    if ctx.k not in SUPPORTED_K:
        raise ValueError(f"{what}: the CUDA kernels are built for K in "
                         f"{SUPPORTED_K}, not K = {ctx.k}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _lib():
    lib = build.library("mont")
    if not getattr(lib, "_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        for k in SUPPORTED_K:
            fctx = ctypes.POINTER(field_ctx_type(k))
            mul, sqr = getattr(lib, f"mont_mul_k{k}"), getattr(
                lib, f"mont_sqr_k{k}")
            mul.argtypes = [fctx, vp, vp, vp, ll, vp]
            sqr.argtypes = [fctx, vp, vp, ll, vp]
            mul.restype = sqr.restype = ctypes.c_int
        lib._typed = True
    return lib


def mont_mul(a: torch.Tensor, b: torch.Tensor, ctx: nn.MontCtx):
    """a*b*R^-1 mod p on canonical int32[K, N] limbs."""
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, ctx)
    _check_k(ctx, "mont_mul")
    check_operand(a, ctx, "mont_mul a")
    check_operand(b, ctx, "mont_mul b")
    if b.shape != a.shape or b.device != a.device:
        raise ValueError("mont_mul: operands differ in shape or device")
    out = torch.empty_like(a)
    rc = getattr(_lib(), f"mont_mul_k{ctx.k}")(
        ctypes.byref(field_struct(ctx)), _ptr(a), _ptr(b), _ptr(out),
        a.shape[1], _stream())
    name = kernel_name("mont_mul", ctx.k)
    build.check(rc, name)
    launches[name] += 1
    return out


def mont_sqr(a: torch.Tensor, ctx: nn.MontCtx):
    """a^2*R^-1 mod p on canonical int32[K, N] limbs."""
    if a.device.type == "cpu":
        return mont_sqr_plain(a, ctx)
    _check_k(ctx, "mont_sqr")
    check_operand(a, ctx, "mont_sqr a")
    out = torch.empty_like(a)
    rc = getattr(_lib(), f"mont_sqr_k{ctx.k}")(
        ctypes.byref(field_struct(ctx)), _ptr(a), _ptr(out), a.shape[1],
        _stream())
    name = kernel_name("mont_sqr", ctx.k)
    build.check(rc, name)
    launches[name] += 1
    return out
