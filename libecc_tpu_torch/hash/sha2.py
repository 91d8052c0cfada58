"""The SHA-2 family for the verify paths: host packing and batched tensor
code for SHA-224, SHA-256, SHA-384 and SHA-512.

Port of ``libecc_tpu/hash/sha2.py:pack_blocks_sha256`` (:201),
``blocks_from_bytes_dev`` (:229), ``sha256_device`` (:255) and
``sha224_device`` (:292), and of the SHA-512 half below. A batch of
same-block-count messages is ``int32[nblk, 16, N]`` big-endian words; the
rounds run as plain tensor code over the batch on int64 copies of the
words (the JAX package computes them in XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..nn.core import _narrow, upload

M32 = 0xFFFFFFFF

K256 = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

H256 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

H224 = [0xc1059ed8, 0x367cd507, 0x3070dd17, 0xf70e5939,
        0xffc00b31, 0x68581511, 0x64f98fa7, 0xbefa4fa4]

DIGEST_BITS = 256


def _padding(mlen: int) -> bytes:
    return (b"\x80" + b"\x00" * ((55 - mlen) % 64)
            + struct.pack(">Q", mlen * 8))


def nblocks_sha256(mlen: int) -> int:
    """Padded 64-byte block count of a message of mlen bytes."""
    return (mlen + 9 + 63) // 64


def pack_blocks_sha256(msgs: list[bytes]) -> np.ndarray:
    """Pad and pack messages of one padded block count -> np.uint32[nblk,
    16, N] big-endian words. Raises ValueError on mixed block counts."""
    padded = [m + _padding(len(m)) for m in msgs]
    nblk = {len(p) // 64 for p in padded}
    if len(nblk) != 1:
        raise ValueError("all messages in a batch must pad to the same "
                         "block count")
    nblk = nblk.pop()
    arr = np.frombuffer(b"".join(padded), dtype=">u4")
    return np.ascontiguousarray(
        arr.reshape(len(msgs), nblk, 16).transpose(1, 2, 0)).astype(
            np.uint32)


_TAILS: dict = {}


def _tail(mlen: int, device) -> torch.Tensor:
    key = (mlen, str(device))
    if key not in _TAILS:
        _TAILS[key] = upload(np.frombuffer(_padding(mlen), np.uint8),
                             device)
    return _TAILS[key]


def blocks_from_bytes_dev(msg_u8: torch.Tensor, mlen: int) -> torch.Tensor:
    """Pad and pack on the device: uint8[N, mlen] -> int32[nblk, 16, N].
    Bit-identical to pack_blocks_sha256."""
    n = msg_u8.shape[0]
    tail = _tail(mlen, msg_u8.device)
    padded = torch.cat([msg_u8, tail[None].expand(n, -1)], 1)
    b = padded.to(torch.int64).view(n, -1, 4)
    words = (b[:, :, 0] << 24) | (b[:, :, 1] << 16) | (b[:, :, 2] << 8) \
        | b[:, :, 3]                                       # (N, nblk*16)
    return _narrow(words.T.reshape(-1, 16, n)).contiguous()


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_device(blocks: torch.Tensor, iv=H256) -> torch.Tensor:
    """Batched SHA-256: int32[nblk, 16, N] -> int32[8, N] digest words."""
    b = blocks.to(torch.int64) & M32
    n = b.shape[2]
    h = [torch.full((n,), v, dtype=torch.int64, device=b.device) for v in iv]
    for blk in range(b.shape[0]):
        w = list(b[blk].unbind(0))
        a, bb, c, d, e, f, g, hh = h
        for t in range(64):
            if t >= 16:
                x, y = w[t - 15], w[t - 2]
                s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
                s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
                w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = hh + S1 + ch + K256[t] + w[t]
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & bb) ^ (a & c) ^ (bb & c)
            hh, g, f, e, d, c, bb, a = (g, f, e, (d + t1) & M32, c, bb, a,
                                        (t1 + S0 + maj) & M32)
        h = [(x + y) & M32 for x, y in zip(h, [a, bb, c, d, e, f, g, hh])]
    return _narrow(torch.stack(h))


def sha224_device(blocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-224: SHA-256 from its own IV, cut to 7 words."""
    return sha256_device(blocks, iv=H224)[:7]


# ---------------------------------------------------------------------------
# SHA-512: 64-bit words as (hi, lo) 32-bit halves
# ---------------------------------------------------------------------------
# Port of libecc_tpu/hash/sha2.py:pack_blocks_sha512 (:300), sha512_device
# (:342) and sha384_device (:414). Torch has no uint64, and int64 shifts
# and overflow are signed, so every 64-bit word is held as its two 32-bit
# halves in an int64[2, N] tensor (row 0 the high half). Bitwise operations
# act on both halves at once; a sum of several words is taken unreduced
# (each half stays far below 2^63) and then carried once: the low half's
# carry goes into the high half, the high half's carry out of 2^64 is
# dropped.

K512 = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f,
    0xe9b5dba58189dbbc, 0x3956c25bf348b538, 0x59f111f1b605d019,
    0x923f82a4af194f9b, 0xab1c5ed5da6d8118, 0xd807aa98a3030242,
    0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235,
    0xc19bf174cf692694, 0xe49b69c19ef14ad2, 0xefbe4786384f25e3,
    0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65, 0x2de92c6f592b0275,
    0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f,
    0xbf597fc7beef0ee4, 0xc6e00bf33da88fc2, 0xd5a79147930aa725,
    0x06ca6351e003826f, 0x142929670a0e6e70, 0x27b70a8546d22ffc,
    0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6,
    0x92722c851482353b, 0xa2bfe8a14cf10364, 0xa81a664bbc423001,
    0xc24b8b70d0f89791, 0xc76c51a30654be30, 0xd192e819d6ef5218,
    0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99,
    0x34b0bcb5e19b48a8, 0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb,
    0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3, 0x748f82ee5defb2fc,
    0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915,
    0xc67178f2e372532b, 0xca273eceea26619c, 0xd186b8c721c0c207,
    0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178, 0x06f067aa72176fba,
    0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc,
    0x431d67c49c100d4c, 0x4cc5d4becb3e42b6, 0x597f299cfc657e2a,
    0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
]

H512 = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
        0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
        0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]

H384 = [0xcbbb9d5dc1059ed8, 0x629a292a367cd507, 0x9159015a3070dd17,
        0x152fecd8f70e5939, 0x67332667ffc00b31, 0x8eb44a8768581511,
        0xdb0c2e0d64f98fa7, 0x47b5481dbefa4fa4]

SHA512_DIGEST_BYTES = 64


def _padding512(mlen: int) -> bytes:
    return (b"\x80" + b"\x00" * ((111 - mlen) % 128)
            + struct.pack(">QQ", 0, mlen * 8))


def nblocks_sha512(mlen: int) -> int:
    """Padded 128-byte block count of a message of mlen bytes."""
    return (mlen + 17 + 127) // 128


def pack_blocks_sha512(msgs: list[bytes]) -> np.ndarray:
    """Pad and pack messages of one padded block count -> np.uint32[nblk,
    32, N]: 16 big-endian 64-bit words per block, each as (hi, lo). Raises
    ValueError on mixed block counts."""
    padded = [m + _padding512(len(m)) for m in msgs]
    nblk = {len(p) // 128 for p in padded}
    if len(nblk) != 1:
        raise ValueError("all messages in a batch must pad to the same "
                         "block count")
    nblk = nblk.pop()
    arr = np.frombuffer(b"".join(padded), dtype=">u4")
    return np.ascontiguousarray(
        arr.reshape(len(msgs), nblk, 32).transpose(1, 2, 0)).astype(
            np.uint32)


def _pairs(vals, device) -> torch.Tensor:
    """64-bit constants -> int64[len, 2, 1] (hi, lo) columns."""
    arr = np.array([[v >> 32, v & M32] for v in vals], np.int64)
    return torch.from_numpy(arr).reshape(len(vals), 2, 1).to(device)


_CONSTS512: dict = {}


def _consts512(device, iv):
    """(round constants, IV, low-half mask) on `device`, made once."""
    key = (str(device), tuple(iv))
    if key not in _CONSTS512:
        lo_only = torch.tensor([[0], [M32]], dtype=torch.int64, device=device)
        _CONSTS512[key] = (_pairs(K512, device), _pairs(iv, device), lo_only)
    return _CONSTS512[key]


def _carry(s: torch.Tensor) -> torch.Tensor:
    """Unreduced (hi, lo) sums -> the 64-bit sum mod 2^64 as halves."""
    return torch.stack([(s[0] + (s[1] >> 32)) & M32, s[1] & M32])


def _rotrs(x: torch.Tensor, ns) -> torch.Tensor:
    """XOR of the 64-bit right rotations of x by each n in ns."""
    xf = x.flip(0)                          # (lo, hi): rotation by 32
    out = None
    for n in ns:
        a, b = (x, xf) if n < 32 else (xf, x)
        n %= 32
        r = (a >> n) | ((b << (32 - n)) & M32)
        out = r if out is None else out ^ r
    return out


def _shr(x: torch.Tensor, n: int, lo_only: torch.Tensor) -> torch.Tensor:
    """64-bit logical right shift by 0 < n < 32."""
    return (x >> n) | ((x.flip(0) << (32 - n)) & lo_only)


def sha512_device(blocks: torch.Tensor, iv=H512) -> torch.Tensor:
    """Batched SHA-512: int32[nblk, 32, N] -> int32[16, N] (8 digest words
    as (hi, lo) pairs, big-endian word order)."""
    b = blocks.to(torch.int64) & M32
    nblk, _, n = b.shape
    k_pairs, iv_pairs, lo_only = _consts512(b.device, iv)
    h = list(iv_pairs.expand(8, 2, n).unbind(0))
    for blk in range(nblk):
        w = list(b[blk].view(16, 2, n).unbind(0))
        a, bb, c, d, e, f, g, hh = h
        for t in range(80):
            if t >= 16:
                x, y = w[t - 15], w[t - 2]
                s0 = _rotrs(x, (1, 8)) ^ _shr(x, 7, lo_only)
                s1 = _rotrs(y, (19, 61)) ^ _shr(y, 6, lo_only)
                w.append(_carry(w[t - 16] + s0 + w[t - 7] + s1))
            S1 = _rotrs(e, (14, 18, 41))
            ch = (e & f) ^ (~e & g)
            t1 = hh + S1 + ch + k_pairs[t] + w[t]
            S0 = _rotrs(a, (28, 34, 39))
            maj = (a & bb) ^ (a & c) ^ (bb & c)
            hh, g, f, e, d, c, bb, a = (g, f, e, _carry(d + t1), c, bb, a,
                                        _carry(t1 + S0 + maj))
        h = [_carry(x + y) for x, y in zip(h, [a, bb, c, d, e, f, g, hh])]
    return _narrow(torch.cat(h, 0))


def sha384_device(blocks: torch.Tensor) -> torch.Tensor:
    """Batched SHA-384: SHA-512 from its own IV, cut to 6 64-bit words
    (12 32-bit words)."""
    return sha512_device(blocks, iv=H384)[:12]
