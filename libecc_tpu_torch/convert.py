"""Carry state across from the JAX package (libecc_tpu) to this port.

The JAX package holds field elements as 15-bit limbs ``uint32[K_j, ...]``
in its Montgomery domain R_j = 2^(15 K_j), possibly relaxed (limbs above
15 bits, values above p). These functions take such arrays AS NUMPY and
return the port's tensors: each decodes sum(limb_i * 2^(15 i)), maps R_j to
the port's R = 2^(32 K) and re-encodes as canonical 32-bit limbs. They
carry their own copy of the 15-bit codec and import nothing of the JAX
package; the tests use them to feed both packages the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .nn import core as nn
from .curves.edwards import ExtPoint
from .curves.shortw import PrjPoint
from .sig.keys import KeyBatch

JAX_LIMB_BITS = 15


def ints_from_limbs15(arr) -> list[int]:
    """uint32[K_j, N] 15-bit limbs (relaxed allowed) -> list of N ints."""
    a = np.asarray(arr).astype(object)
    if a.ndim == 1:
        a = a[:, None]
    return [sum(int(a[i, j]) << (JAX_LIMB_BITS * i) for i in range(a.shape[0]))
            for j in range(a.shape[1])]


def limbs15_from_ints(vals, k_jax: int) -> np.ndarray:
    """list of ints -> canonical uint32[k_jax, N] 15-bit limbs."""
    out = np.zeros((k_jax, len(vals)), np.uint32)
    for j, v in enumerate(vals):
        if v < 0 or v >> (JAX_LIMB_BITS * k_jax):
            raise ValueError("value does not fit the 15-bit limbs")
        for i in range(k_jax):
            out[i, j] = (v >> (JAX_LIMB_BITS * i)) & ((1 << JAX_LIMB_BITS) - 1)
    return out


def fe_from_jax(arr, ctx, device) -> torch.Tensor:
    """JAX Montgomery-domain field elements -> the port's (canonical)."""
    arr = np.asarray(arr)
    p = ctx.p_int
    rj_inv = pow(1 << (JAX_LIMB_BITS * arr.shape[0]), -1, p)
    vals = [v * rj_inv % p * ctx.R % p for v in ints_from_limbs15(arr)]
    return nn.upload(nn.batch_to_limbs(vals, ctx.k), device)


def fe_to_jax(t: torch.Tensor, ctx, k_jax: int) -> np.ndarray:
    """The port's field elements -> canonical JAX Montgomery-domain limbs."""
    p = ctx.p_int
    r_inv = pow(ctx.R, -1, p)
    rj = 1 << (JAX_LIMB_BITS * k_jax)
    vals = [v * r_inv % p * rj % p for v in nn.batch_from_limbs(t)]
    return limbs15_from_ints(vals, k_jax)


def point_from_jax(curve, x, y, z, device) -> PrjPoint:
    """JAX PrjPoint coordinates (numpy) -> the port's PrjPoint."""
    ctx = curve.fp_ctx
    return PrjPoint(fe_from_jax(x, ctx, device), fe_from_jax(y, ctx, device),
                    fe_from_jax(z, ctx, device))


def ext_point_from_jax(curve, x, y, z, t, device) -> ExtPoint:
    """JAX ExtPoint coordinates (numpy) -> the port's ExtPoint."""
    ctx = curve.fp_ctx
    return ExtPoint(*[fe_from_jax(v, ctx, device) for v in (x, y, z, t)])


def ext_point_to_jax(P: ExtPoint, ctx, k_jax: int) -> tuple:
    """The port's ExtPoint -> JAX Montgomery-domain coordinates (numpy),
    for ``libecc_tpu.curves.edwards.ExtPoint(*map(jnp.asarray, ...))``."""
    return tuple(fe_to_jax(v, ctx, k_jax) for v in P)


def keys_from_jax(curve, x, y, z, device, alg: str = "ECDSA") -> KeyBatch:
    """A JAX KeyBatch's pub coordinates (numpy) -> the port's public-key
    KeyBatch on `device`."""
    pub = point_from_jax(curve, x, y, z, device)
    return KeyBatch(curve=curve, alg=alg, n=pub.x.shape[1], pub=pub)


def scalars_from_jax(arr, k: int, device) -> torch.Tensor:
    """Plain-domain JAX limbs (no reduction) -> the port's int32[k, N]."""
    return nn.upload(nn.batch_to_limbs(ints_from_limbs15(arr), k), device)


def scalars_to_jax(t: torch.Tensor, k_jax: int) -> np.ndarray:
    return limbs15_from_ints(nn.batch_from_limbs(t), k_jax)


def comb_table_from_jax(tab, ctx) -> np.ndarray:
    """The JAX comb table np.uint32[rows, ncoord, K_j] (its Montgomery
    domain) -> the port's layout np.uint32[rows, ncoord, K], as
    ``curves.scalar_mul._comb_table_host`` returns it."""
    tab = np.asarray(tab)
    rows, ncoord, kj = tab.shape
    flat = tab.reshape(rows * ncoord, kj).T
    p = ctx.p_int
    rj_inv = pow(1 << (JAX_LIMB_BITS * kj), -1, p)
    vals = [v * rj_inv % p * ctx.R % p for v in ints_from_limbs15(flat)]
    return np.ascontiguousarray(
        nn.batch_to_limbs(vals, ctx.k).T.reshape(rows, ncoord, ctx.k))
