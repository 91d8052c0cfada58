"""The port's SHA-512 (host packing, the batched rounds on 32-bit halves)
and the signature layer's bucketed batch_digests, against the SHA512 rows
of tests/vectors/hash_kats.jsonl, hashlib and the JAX package's packer and
sha512_device, on the CPU."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.hash import sha2 as jsha2

from libecc_tpu_torch.hash import sha2
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.sig import common

VEC = os.path.join(os.path.dirname(__file__), "vectors", "hash_kats.jsonl")
LENS = [0, 3, 55, 56, 64, 65, 137, 1000]       # test_hash_parity.py's set


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _msg(ln):
    """The KAT message of each length (as tests/test_hash_parity.py)."""
    if ln == 0:
        return b""
    if ln == 3:
        return b"abc"
    idx = LENS.index(ln)
    return bytes(((j * 7 + idx * 31) & 0xFF) for j in range(ln))


def _digests(words, n):
    raw = nn.to_host(words).T.astype(">u4").tobytes()
    return [raw[64 * i:64 * (i + 1)] for i in range(n)]


def _kats():
    with open(VEC) as f:
        return [k for k in map(json.loads, f) if k["alg"] == "SHA512"]


@pytest.mark.parametrize("kat", _kats(), ids=lambda k: f"len{k['len']}")
def test_sha512_device_kats(kat):
    m = _msg(kat["len"])
    blocks = sha2.pack_blocks_sha512([m])
    assert blocks.shape[0] == sha2.nblocks_sha512(len(m))
    got = _digests(sha2.sha512_device(nn.upload(blocks, "cpu")), 1)[0]
    assert got.hex() == kat["digest"]


def test_sha512_kat_count():
    assert sorted(k["len"] for k in _kats()) == LENS


@pytest.mark.parametrize("mlen", [0, 96, 111, 112, 200])
def test_sha512_device_matches_jax_and_hashlib(mlen):
    """Block boundaries at 111/112 bytes; 96 bytes is the Ed25519
    challenge buffer R || A || M for a 32-byte message."""
    rng = np.random.RandomState(61 + mlen)
    msgs = [rng.bytes(mlen) for _ in range(8)]
    blocks = sha2.pack_blocks_sha512(msgs)
    assert np.array_equal(blocks, np.asarray(jsha2.pack_blocks_sha512(msgs)))
    got = sha2.sha512_device(nn.upload(blocks, "cpu"))
    want = np.asarray(jsha2.sha512_device(jnp.asarray(blocks)))
    assert np.array_equal(nn.to_host(got), want)
    assert _digests(got, 8) == [hashlib.sha512(m).digest() for m in msgs]


def test_batch_digests_buckets_mixed_lengths():
    rng = np.random.RandomState(62)
    msgs = [rng.bytes(n) for n in (0, 200, 5, 111, 112, 300, 96, 1)]
    assert common.batch_digests("SHA512", msgs, "cpu") == [
        hashlib.sha512(m).digest() for m in msgs]
    assert common.batch_digests("SHA-512", [], "cpu") == []
    with pytest.raises(ValueError):
        common.batch_digests("SM3", msgs, "cpu")
    with pytest.raises(ValueError):
        sha2.pack_blocks_sha512([b"a", b"b" * 120])
