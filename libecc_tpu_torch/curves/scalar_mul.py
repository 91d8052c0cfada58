"""Batched scalar multiplication for public scalars (verification).

Port of the public paths of ``libecc_tpu/curves/scalar_mul.py``:

* ``fixed_base_mul``: m*G by the comb table, nbits/w table lookups and
  complete adds (kernel 2), no doublings. The lookup is an indexed gather
  on int32 tensors; the reference's one-hot float32 matmul is not carried
  over (32-bit limbs do not fit a float32 mantissa, and a float32 product
  on the card may run in TF32). This is the PUBLIC lookup: its memory
  access depends on the digits.
* ``windowed_mul_public``: m*P with a per-lane [0..15]P table (kernels 2
  and 3) and the whole window loop as kernel 4, at kernel 4's window
  width ``megamul.WINDOW`` (the reference's w -> w-1 fallback has no
  counterpart, so the width is not a parameter).
* ``fixed_base_double_mul_public``: u*G + v*Q for ECDSA and EdDSA
  verification.
* ``straus_double_mul_public_w4``: u*P + v*Q with one [0..15] table per
  base and the whole window loop as kernel 6 (batch verification).
* ``straus_double_mul_public``: u*P + v*Q with one joint 2-bit table
  iP + jQ and nbits/2 steps of ``pdbln_add`` (kernel 5 or 8c).

Each works on both point classes: short-Weierstrass projective points
(three coordinates; kernels 2, 3, 4, 5 and 6) and twisted-Edwards extended
points (four; kernels 8a, 8b, 7, 8c and 6-ed).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import stages
from ..nn import core as nn
from ..ops.cuda import megamul
from ..ref import hostref
from .edwards import EdwardsCurve

COMB_W = 8              # comb window width: 2^8-entry tables, nbits/8 adds
JOINT_W = 2             # joint Straus window: a 2^(2w) = 16-entry table

# (curve name, p, w, nbits) -> (np.uint32[nwin*2^w, ncoord, K], nwin)
_COMB_CACHE: dict = {}
# (same key, device) -> int32[nwin, ncoord*K, 2^w] on that device
_COMB_DEV: dict = {}


def _comb_rows_shortw(c, nwin: int, w: int):
    """The host oracle's affine comb, projective with Z = 1."""
    ref = hostref.WCurve(c.fp_ctx.p_int, c.a, c.b, c.gx, c.gy, c.q, c.h)
    return [(0, 1, 0) if P is None else (P[0], P[1], 1)
            for row in hostref.ec_base_comb(ref, nwin, w) for P in row]


def _comb_rows_edwards(c, nwin: int, w: int):
    """The host oracle's extended comb, made affine."""
    p = c.fp_ctx.p_int
    ref = hostref.EdCurve(p, c.a, c.d, c.gx, c.gy, c.q, c.h)
    rows = []
    for row in hostref.ed_base_comb(ref, nwin, w):
        for x, y, z, _t in row:
            zi = pow(z, -1, p)
            x, y = x * zi % p, y * zi % p
            rows.append((x, y, 1, x * y % p))
    return rows


def _comb_table_host(c, nbits: int):
    """Host-precomputed comb table as (np.uint32[nwin*2^w, ncoord, K],
    nwin), w = COMB_W: row j*2^w + d holds d * 2^(w j) * G in the port's
    Montgomery domain; affine entries have Z = 1 (and T = x y on Edwards
    curves), the identity at d = 0 is (0 : 1 : 0) or (0 : 1 : 1 : 0).
    The same table as the reference's, in the port's limb layout. Built
    once per process (Ed25519: 32 x 256 host Edwards adds)."""
    ctx = c.fp_ctx
    p, w = ctx.p_int, COMB_W
    key = (c.name, p, w, nbits)
    if key in _COMB_CACHE:
        return _COMB_CACHE[key]
    nwin = -(-nbits // w)
    rows = (_comb_rows_edwards if isinstance(c, EdwardsCurve)
            else _comb_rows_shortw)(c, nwin, w)
    ncoord = len(rows[0])
    vals = [v * ctx.R % p for row in rows for v in row]
    out = nn.batch_to_limbs(vals, ctx.k).T.reshape(len(rows), ncoord, ctx.k)
    _COMB_CACHE[key] = (np.ascontiguousarray(out), nwin)
    return _COMB_CACHE[key]


def _comb_table_dev(c, nbits: int, device):
    w = COMB_W
    key = (c.name, c.fp_ctx.p_int, w, nbits, str(torch.device(device)))
    if key not in _COMB_DEV:
        tab, nwin = _comb_table_host(c, nbits)
        t = tab.reshape(nwin, 1 << w, -1).transpose(0, 2, 1)
        _COMB_DEV[key] = nn.upload(np.ascontiguousarray(t), device)
    return _COMB_DEV[key]


def _digits(m, nbits: int, w: int, msw_first: bool):
    """w-bit digits of the scalars m (int32[K, N]) as int64[nwin, N]."""
    nwin = -(-nbits // w)
    u = nn._u(m)
    u = torch.cat([u, torch.zeros_like(u[:1])], 0)     # room for straddles
    lo = torch.arange(nwin, device=m.device) * w
    limb = lo // 32
    sh = (lo % 32)[:, None]
    v = (u[limb] >> sh) | ((u[limb + 1] << (32 - sh)) & nn.MASK32)
    width = (nbits - lo).clamp(max=w)[:, None]           # last window may be short
    d = v & ((torch.ones_like(width) << width) - 1)
    return d.flip(0) if msw_first else d


def fixed_base_mul(c, m, nbits: int | None = None):
    """m*G for PUBLIC scalars m (int32[Kq, N], plain domain) via the comb
    table: nbits/w gathered lookups and complete adds."""
    if nbits is None:
        nbits = c.scalar_bits()
    k = c.fp_ctx.k
    tab = _comb_table_dev(c, nbits, m.device)      # (nwin, ncoord*K, 2^w)
    digs = _digits(m, nbits, COMB_W, msw_first=False)
    acc = c.pinf(batch_shape=m.shape[1:], device=m.device)
    cls = type(acc)
    for j in range(tab.shape[0]):
        sel = tab[j].index_select(1, digs[j])         # (ncoord*K, N)
        acc = c.padd(acc, cls(*sel.split(k)))
    return acc


def _window_digits(m, nbits: int):
    """Split scalars into WINDOW-bit windows, MSW first: int32[nwin, N]."""
    return _digits(m, nbits, megamul.WINDOW, msw_first=True).to(
        torch.int32).contiguous()


def _build_mul_table(c, P, size: int = 1 << megamul.WINDOW):
    """[0..size-1]P stacked as int32[size, ncoord, K, N]: even entries by
    doubling (kernel 3 or 8b), odd entries by adding P (kernel 2 or 8a)."""
    table = [c.pinf(like=P), P]
    for i in range(2, size):
        table.append(c.pdbl(table[i // 2]) if i % 2 == 0
                     else c.padd(table[i - 1], P))
    return torch.stack([torch.stack(list(t)) for t in table])


def windowed_mul_public(c, m, P, nbits: int | None = None):
    """Fixed-window m*P for PUBLIC scalars: per-lane [0..2^w-1]P table,
    then nbits/w windows of (w doublings + one table add), all windows in
    one launch of kernel 4 (or 7, Edwards) on the card (w =
    megamul.WINDOW)."""
    if nbits is None:
        nbits = c.scalar_bits()
    table = _build_mul_table(c, P)
    digs = _window_digits(m, nbits)
    return megamul.windowed_mul(c, table, digs, type(P))


def fixed_base_double_mul_public(c, u, v, Q, nbits: int | None = None):
    """u*G + v*Q for PUBLIC scalars: comb for the fixed base G, windowed
    multiply for Q, one final complete add."""
    if nbits is None:
        nbits = c.scalar_bits()
    uG = fixed_base_mul(c, u, nbits=nbits)
    stages.mark("comb", uG)
    table = _build_mul_table(c, Q)
    digs = _window_digits(v, nbits)
    stages.mark("table", table, digs)
    vQ = megamul.windowed_mul(c, table, digs, type(Q))
    stages.mark("windowed", vQ)
    return c.padd(uG, vQ)


def straus_double_mul_public_w4(c, u, P, v, Q, nbits: int | None = None):
    """u*P + v*Q for PUBLIC scalars with SEPARATE [0..15] tables per base
    and 4-bit windows: per window 4 doublings, then P's entry, then Q's
    entry; all windows in one launch of kernel 6 (6-ed, Edwards) on the
    card. The digits cover the full nbits (default the scalars' width),
    leading zero windows included: they add identities, which changes the
    projective values the reference computes."""
    if nbits is None:
        nbits = c.scalar_bits()
    ptab = _build_mul_table(c, P)
    qtab = _build_mul_table(c, Q)
    du = _window_digits(u, nbits)
    dv = _window_digits(v, nbits)
    stages.mark("table", ptab, du, qtab, dv)
    return megamul.straus_mul(c, ptab, du, qtab, dv, type(P))


def straus_double_mul_public(c, u, P, v, Q, nbits: int | None = None):
    """u*P + v*Q for PUBLIC scalars, interleaved (Straus-Shamir) over ONE
    joint per-lane table T[i * 4 + j] = iP + jQ (JOINT_W = 2; kernels 2 and
    3, or 8a and 8b): nbits/2 steps of acc = 4*acc + T[d_u * 4 + d_v], each
    one ``pdbln_add`` (kernel 5, or 8c on an Edwards curve)."""
    if nbits is None:
        nbits = c.scalar_bits()
    cls = type(P)
    tw = 1 << JOINT_W
    ptab = _build_mul_table(c, P, tw)
    qtab = _build_mul_table(c, Q, tw)
    rows = []
    for i in range(tw):
        for j in range(tw):
            if i == 0:
                rows.append(qtab[j])
            elif j == 0:
                rows.append(ptab[i])
            else:
                rows.append(torch.stack(list(c.padd(cls(*ptab[i]),
                                                    cls(*qtab[j])))))
    table = torch.stack(rows)
    idx = (_digits(u, nbits, JOINT_W, msw_first=True) * tw
           + _digits(v, nbits, JOINT_W, msw_first=True))
    acc = c.pinf(like=P)
    for wi in range(idx.shape[0]):
        acc = c.pdbln_add(acc, megamul.gather_entry(table, idx[wi], cls),
                          JOINT_W)
    return acc
