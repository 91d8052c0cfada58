"""SHA-3 and SHAKE (FIPS 202) for the verify path: host packing and a
batched tensor Keccak.

Port of ``libecc_tpu/hash/sha3.py``: ``pack_blocks_keccak`` (:264),
``_keccak_absorb_device`` (:219), ``keccak_f_device`` (:174) and
``make_sha3_device`` (:234), with the parameters of the six SHA-3 hashes
(``PARAMS``). SHAKE256 at 114 bytes is Ed448's challenge hash.

Keccak-f[1600] is plain tensor code, as the JAX package computes it in XLA
outside any Pallas kernel. The state is ``int64[25, 2, N]``: lane
i = x + 5y as its (hi, lo) 32-bit halves (torch on the CPU has no uint32
shifts, and int64 shifts are signed, so a 64-bit lane is held in two).
Each step of a round is one tensor operation over all 25 lanes at once
(rho by per-lane shift tensors, pi by one fixed index permutation), about
30 launches a round, instead of the 25 unrolled lanes of the JAX code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.core import _narrow

M32 = 0xFFFFFFFF

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y]
ROT = [[0, 36, 3, 41, 18],
       [1, 44, 10, 45, 2],
       [62, 6, 43, 15, 61],
       [28, 55, 25, 21, 56],
       [27, 20, 39, 8, 14]]

# name -> (rate in bytes, output bytes, domain-separation byte)
PARAMS = {
    "SHA3_224": (144, 28, 0x06),
    "SHA3_256": (136, 32, 0x06),
    "SHA3_384": (104, 48, 0x06),
    "SHA3_512": (72, 64, 0x06),
    "SHAKE128": (168, 32, 0x1F),
    "SHAKE256": (136, 114, 0x1F),      # Ed448's 114-byte challenge
}


def nblocks_keccak(mlen: int, rate: int) -> int:
    """Padded block count of a message of mlen bytes (at least one pad
    byte)."""
    return mlen // rate + 1


def pack_blocks_keccak(msgs: list[bytes], rate: int,
                       dsbyte: int = 0x06) -> np.ndarray:
    """Pad and pack messages of one padded block count -> np.uint32[nblk,
    rate // 4, N]: each 64-bit little-endian lane as (hi, lo). Raises
    ValueError on mixed block counts."""
    padded = []
    for m in msgs:
        pad = bytearray(rate - len(m) % rate)
        pad[0] = dsbyte
        pad[-1] |= 0x80
        padded.append(m + bytes(pad))
    nblk = {len(p) // rate for p in padded}
    if len(nblk) != 1:
        raise ValueError("all messages in a batch must pad to the same "
                         "block count")
    nblk = nblk.pop()
    rl = rate // 8
    lanes = np.frombuffer(b"".join(padded), dtype="<u8").reshape(
        len(msgs), nblk, rl).transpose(1, 2, 0)
    out = np.empty((nblk, 2 * rl, len(msgs)), np.uint32)
    out[:, 0::2] = (lanes >> np.uint64(32)).astype(np.uint32)
    out[:, 1::2] = (lanes & np.uint64(M32)).astype(np.uint32)
    return out


def _pi_source() -> list[int]:
    """B[y][(2x + 3y) % 5] = rot(A[x][y]): for each destination lane
    j = x' + 5y', the source lane i = x + 5y."""
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return src


_CONSTS: dict = {}


def _consts(device):
    """Per-device constant tensors (made once): per-lane rho shifts and
    half swaps, the pi permutation, the round constants as (hi, lo)."""
    key = str(device)
    if key not in _CONSTS:
        rot = [ROT[i % 5][i // 5] for i in range(25)]
        shift = torch.tensor([r % 32 for r in rot], dtype=torch.int64,
                             device=device).view(25, 1, 1)
        swap = torch.tensor([r >= 32 for r in rot],
                            device=device).view(25, 1, 1)
        pi = torch.tensor(_pi_source(), dtype=torch.int64, device=device)
        rc = torch.tensor([[c >> 32, c & M32] for c in RC],
                          dtype=torch.int64, device=device).view(24, 2, 1)
        _CONSTS[key] = (shift, swap, pi, rc)
    return _CONSTS[key]


def _rol1(c: torch.Tensor) -> torch.Tensor:
    """64-bit left rotation by one of (hi, lo) halves along dim 1."""
    return ((c << 1) | (c.flip(1) >> 31)) & M32


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """One Keccak-f[1600] permutation of int64[25, 2, N] (lane x + 5y as
    (hi, lo), each half in [0, 2^32))."""
    shift, swap, pi, rc = _consts(state.device)
    a = state
    for rnd in range(24):
        # theta: column parities C[x], D[x] = C[x-1] ^ rol(C[x+1], 1)
        s = a.view(5, 5, 2, -1)                       # [y, x, half, N]
        c = s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4]          # [x, half, N]
        d = c.roll(1, 0) ^ _rol1(c.roll(-1, 0))
        a = (s ^ d).view(25, 2, -1)
        # rho: per-lane rotation (halves swapped for offsets >= 32), then
        # pi: one fixed lane permutation
        a = torch.where(swap, a.flip(1), a)
        a = (((a << shift) | (a.flip(1) >> (32 - shift))) & M32)[pi]
        # chi: A[x] ^= ~A[x+1] & A[x+2] within each row y
        s = a.view(5, 5, 2, -1)
        s = s ^ (~s.roll(-1, 1) & s.roll(-2, 1))
        a = s.reshape(25, 2, -1)
        # iota
        a = torch.cat([a[:1] ^ rc[rnd], a[1:]], 0)
    return a


def keccak_absorb(blocks: torch.Tensor, rate_lanes: int) -> torch.Tensor:
    """Pre-padded sponge input int32[nblk, 2 * rate_lanes, N] -> the state
    int64[25, 2, N] after absorbing every block."""
    b = blocks.to(torch.int64) & M32
    n = b.shape[2]
    st = torch.zeros((25, 2, n), dtype=torch.int64, device=b.device)
    for blk in range(b.shape[0]):
        lanes = b[blk].view(rate_lanes, 2, n)
        st = keccak_f(torch.cat([st[:rate_lanes] ^ lanes,
                                 st[rate_lanes:]], 0))
    return st


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


def sha3_device(blocks: torch.Tensor, rate: int,
                outlen: int) -> torch.Tensor:
    """Batched SHA-3 / SHAKE (one squeeze, outlen <= rate): packed blocks
    int32[nblk, rate // 4, N] -> int32[ceil(outlen / 4), N] digest words in
    the big-endian word convention of the other hashes (each 64-bit lane
    read as bswap(lo), bswap(hi)), as ``make_sha3_device`` returns them."""
    if outlen > rate:
        raise ValueError("sha3_device squeezes one block: outlen <= rate")
    st = keccak_absorb(blocks, rate // 8)
    nlanes = -(-outlen // 8)
    words = _bswap32(st[:nlanes].flip(1)).reshape(2 * nlanes, -1)
    return _narrow(words[:-(-outlen // 4)]).contiguous()
