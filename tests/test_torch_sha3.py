"""The port's SHA-3 / SHAKE (host packing, the batched Keccak-f[1600] on
(hi, lo) halves) and the signature layer's SHAKE256 batch_digests, against
the SHAKE256 and SHA3_256 rows of tests/vectors/hash_kats.jsonl, hashlib
and the JAX package's packer and make_sha3_device, on the CPU."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.hash import sha3 as jsha3

from libecc_tpu_torch.hash import sha3
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.sig import common

VEC = os.path.join(os.path.dirname(__file__), "vectors", "hash_kats.jsonl")
LENS = [0, 3, 55, 56, 64, 65, 137, 1000]       # test_hash_parity.py's set
HASHLIB = {"SHA3_224": hashlib.sha3_224, "SHA3_256": hashlib.sha3_256,
           "SHA3_384": hashlib.sha3_384, "SHA3_512": hashlib.sha3_512}


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


def _hash(name, msgs):
    """The port's batched digests of msgs (one padded block count)."""
    rate, outlen, ds = sha3.PARAMS[name]
    words = sha3.sha3_device(nn.upload(
        sha3.pack_blocks_keccak(msgs, rate, ds), "cpu"), rate, outlen)
    raw = nn.to_host(words).T.astype(">u4").tobytes()
    stride = 4 * words.shape[0]
    return [raw[stride * i:stride * i + outlen] for i in range(len(msgs))]


def _want(name, m):
    if name in HASHLIB:
        return HASHLIB[name](m).digest()
    shake = hashlib.shake_128 if name == "SHAKE128" else hashlib.shake_256
    return shake(m).digest(sha3.PARAMS[name][1])


def _kats():
    with open(VEC) as f:
        return [k for k in map(json.loads, f)
                if k["alg"] in ("SHAKE256", "SHA3_256")]


@pytest.mark.parametrize("kat", _kats(),
                         ids=lambda k: f"{k['alg']}-len{k['len']}")
def test_sha3_device_kats(kat):
    m = _msg(kat["len"])
    rate = sha3.PARAMS[kat["alg"]][0]
    assert kat["block_size"] == rate
    assert kat["digest_size"] == sha3.PARAMS[kat["alg"]][1]
    assert sha3.pack_blocks_keccak([m], rate).shape[0] == (
        sha3.nblocks_keccak(len(m), rate))
    assert _hash(kat["alg"], [m])[0].hex() == kat["digest"]


def test_sha3_kat_count():
    assert sorted((k["alg"], k["len"]) for k in _kats()) == sorted(
        [(a, n) for a in ("SHAKE256", "SHA3_256") for n in LENS])


@pytest.mark.parametrize("name", list(sha3.PARAMS))
def test_sha3_family_matches_hashlib(name):
    """Every length from 0 to 300 bytes in steps of 23 and the rate's block
    edges (rate - 1, rate, rate + 1, 2 rate + 1): 1-3 absorb blocks."""
    rate = sha3.PARAMS[name][0]
    rng = np.random.RandomState(sum(map(ord, name)))
    lens = sorted(set(range(0, 301, 23)) | {rate - 1, rate, rate + 1,
                                               2 * rate + 1})
    msgs = [rng.bytes(n) for n in lens]
    for m in msgs:
        assert _hash(name, [m]) == [_want(name, m)], len(m)
    assert {sha3.nblocks_keccak(n, rate) for n in lens} >= {1, 2, 3}


@pytest.mark.parametrize("mlen", [0, 156, 300])
def test_shake256_matches_jax_word_for_word(mlen):
    """The JAX package's packer and make_sha3_device, called eagerly on the
    same packed blocks (156 bytes: Ed448's challenge buffer dom4 || R || A
    || M for a 32-byte message, two absorb blocks)."""
    rate, outlen, ds = sha3.PARAMS["SHAKE256"]
    rng = np.random.RandomState(63 + mlen)
    msgs = [rng.bytes(mlen) for _ in range(4)]
    blocks = sha3.pack_blocks_keccak(msgs, rate, ds)
    assert np.array_equal(blocks, np.asarray(
        jsha3.pack_blocks_keccak(msgs, rate, ds)))
    got = sha3.sha3_device(nn.upload(blocks, "cpu"), rate, outlen)
    want = np.asarray(jsha3.make_sha3_device(rate, outlen, ds)(
        jnp.asarray(blocks)))
    assert got.shape == (29, 4)
    assert np.array_equal(nn.to_host(got), want)


def test_batch_digests_shake256_buckets():
    """Mixed block counts in one call: one bucket each, 114-byte digests
    cut from 29 big-endian words."""
    rng = np.random.RandomState(64)
    msgs = [rng.bytes(n) for n in (0, 156, 135, 136, 300, 10, 272)]
    assert common.batch_digests("SHAKE256", msgs, "cpu") == [
        hashlib.shake_256(m).digest(114) for m in msgs]
    assert common.batch_digests("SHA3-256", msgs[:2], "cpu") == [
        hashlib.sha3_256(m).digest() for m in msgs[:2]]
    assert common.batch_digests("SHAKE256", [], "cpu") == []
    with pytest.raises(ValueError):
        common.batch_digests("SHAKE512", msgs, "cpu")
    with pytest.raises(ValueError):
        sha3.pack_blocks_keccak([b"a", b"b" * 140], 136, 0x1F)
    with pytest.raises(ValueError):
        sha3.sha3_device(nn.upload(sha3.pack_blocks_keccak([b""], 72), "cpu"),
                         72, 100)
