"""The port's Ed25519 verification (the slice as a whole) against the JAX
package's verify_core called eagerly, the Ed25519 Wycheproof rows and the
EDDSA25519 KAT rows, and the port's RFC 8032 host signer against the KAT
bytes, on the CPU."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import edwards as jed
from libecc_tpu.nn import core as jnn
from libecc_tpu.sig import eddsa as jeddsa

from libecc_tpu_torch import stages
from libecc_tpu_torch.curves import edwards as ed
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import eddsa

C = ed.get_edwards_curve("ED25519")
P, Q = C.fp_ctx.p_int, C.q
HC = H.EdCurve(P, C.a, C.d, C.gx, C.gy, Q, C.h)
VEC = os.path.join(os.path.dirname(__file__), "vectors")
VARIANT = {"EDDSA25519": "ed25519", "EDDSA25519CTX": "ed25519ctx",
           "EDDSA25519PH": "ed25519ph"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wycheproof():
    with open(os.path.join(VEC, "wycheproof_subset.jsonl")) as f:
        return [v for v in map(json.loads, f)
                if v["scheme"] == "EDDSA" and v["curve"] == "ED25519"]


def _kats():
    with open(os.path.join(VEC, "kats_full.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("alg") in VARIANT]


def _no_x_y():
    """The least y whose (y^2 - 1)/(d y^2 + 1) is not a square."""
    return next(y for y in range(2, 100) if pow(
        (y * y - 1) * pow(C.d * y * y + 1, -1, P) % P, (P - 1) // 2, P) != 1)


def _lanes():
    """16 lanes of (pub, R, S, message) wire values: valid signatures and
    every corruption class the verifier must reject."""
    rng = np.random.RandomState(91)
    lanes = []
    for _ in range(16):
        seed, msg = rng.bytes(32), rng.bytes(32)
        pub, sig = H.ed25519_sign(HC, seed, msg)
        lanes.append([pub, sig[:32], int.from_bytes(sig[32:], "little"), msg])
    lanes[3][1] = bytes([lanes[3][1][0] ^ 1]) + lanes[3][1][1:]  # R bit flip
    lanes[4][2] += Q                                         # S + q
    lanes[5][2] = Q                                          # S = q
    lanes[6][3] = lanes[6][3][::-1]                          # other message
    lanes[7][0] = _no_x_y().to_bytes(32, "little")           # y has no x
    lanes[8][0] = (P + 1).to_bytes(32, "little")             # y >= p
    lanes[9][1] = (P + 3).to_bytes(32, "little")             # R: y >= p
    lanes[10][0] = (1 | 1 << 255).to_bytes(32, "little")     # x = 0, sign 1
    lanes[11][1] = _no_x_y().to_bytes(32, "little")          # R: y has no x
    r = 12345                                                # A = identity:
    lanes[12][0] = (1).to_bytes(32, "little")                # S*B == R
    lanes[12][1] = H.ed25519_encode(H.ed_base_mul(HC, r))
    lanes[12][2] = r
    return lanes


def _split(enc):
    v = int.from_bytes(enc, "little")
    return v & ((1 << 255) - 1), v >> 255


@pytest.fixture(scope="module")
def core_inputs():
    lanes = _lanes()
    ay, asign = zip(*[_split(ln[0]) for ln in lanes])
    ry, rsign = zip(*[_split(ln[1]) for ln in lanes])
    S = [ln[2] for ln in lanes]
    k = [int.from_bytes(hashlib.sha512(ln[1] + ln[0] + ln[3]).digest(),
                        "little") % Q for ln in lanes]
    return ay, asign, ry, rsign, S, k


@pytest.fixture(scope="module")
def jax_core(core_inputs):
    """The JAX package's verify_core, called eagerly (its jitted form takes
    minutes to compile on the CPU)."""
    ay, asign, ry, rsign, S, k = core_inputs
    jc = jed.get_edwards_curve("ED25519")
    fk, qk = jc.fp_ctx.k, jc.q_ctx.k
    return np.asarray(jeddsa.verify_core(
        jc, jnp.asarray(jnn.batch_to_limbs(list(ay), fk)),
        jnp.asarray(np.array(asign, np.uint32)),
        jnp.asarray(jnn.batch_to_limbs(list(ry), fk)),
        jnp.asarray(np.array(rsign, np.uint32)),
        jnp.asarray(jnn.batch_to_limbs(S, qk)),
        jnp.asarray(jnn.batch_to_limbs(k, qk)))).tolist()


def test_verify_core_matches_jax(core_inputs, jax_core):
    ay, asign, ry, rsign, S, k = core_inputs

    def up(vals, kk=8):
        return nn.upload(nn.batch_to_limbs(list(vals), kk), "cpu")

    def signs(vals):
        return torch.tensor(vals, dtype=torch.int32)

    got = eddsa.verify_core(C, up(ay), signs(asign), up(ry), signs(rsign),
                            up(S), up(k)).tolist()
    want = [True] * 3 + [False] * 9 + [True] * 4
    assert got == jax_core == want


def test_decode_core_against_the_oracle():
    """Decoded points are the oracle's; the ok mask rejects y >= p, y with
    no x, and x = 0 with the sign bit set."""
    pts = [H.ed_base_mul(HC, v) for v in (1, 2, 3, 12345)]
    encs = [H.ed25519_encode(pt) for pt in pts] + [
        _no_x_y().to_bytes(32, "little"), (P + 1).to_bytes(32, "little"),
        (1 | 1 << 255).to_bytes(32, "little"), (1).to_bytes(32, "little")]
    ys, sg = zip(*[_split(e) for e in encs])
    Pt, ok = eddsa.decode_core(C, nn.upload(nn.batch_to_limbs(list(ys), 8),
                                            "cpu"),
                               torch.tensor(sg, dtype=torch.int32))
    assert ok.tolist() == [True] * 4 + [False] * 3 + [True]
    x, y = ed.to_affine_plain(C, Pt)
    got = list(zip(nn.batch_from_limbs(x), nn.batch_from_limbs(y)))
    assert got[:4] == pts and got[7] == (0, 1)
    assert ed.on_curve_mask(C, Pt)[[0, 1, 2, 3, 7]].all()


def test_wycheproof_ed25519_rows():
    """The rows give their recorded results; the verify passes its stage
    marks in order, and the marked accept mask is the returned one."""
    rows = _wycheproof()
    assert len(rows) == 15
    assert sum(v["result"] == "valid" for v in rows) == 3
    marks = []
    with stages.on_mark(lambda name, *vals: marks.append((name, vals))):
        acc = eddsa.verify_batch("ed25519", [bytes.fromhex(v["pub"])
                                             for v in rows],
                                 [bytes.fromhex(v["msg"]) for v in rows],
                                 [bytes.fromhex(v["sig"]) for v in rows],
                                 device="cpu")
    fails = [(v["tcId"], v["comment"]) for v, a in zip(rows, acc)
             if bool(a) != (v["result"] == "valid")]
    assert not fails
    assert [m[0] for m in marks] == ["parse", "challenge", "decode", "comb",
                                     "table", "windowed", "accept"]
    assert (marks[-1][1][0].numpy() & marks[0][1][0]["pre_ok"]
            == acc).all()
    table, digs = marks[4][1]
    assert table.shape == (16, 4, 8, 15) and digs.shape == (64, 15)


@pytest.mark.parametrize("row", _kats(), ids=lambda r: r["name"])
def test_kat_rows_sign_and_verify(row):
    """The host signer reproduces the KAT signature byte for byte (the
    KATs' "pub" is the reference's Weierstrass export, so the key comes
    from "priv"); the port's verify accepts it and rejects a flipped bit
    and another message."""
    variant = VARIANT[row["alg"]]
    ctx = bytes.fromhex(row["adata_hex"]) if row["adata_hex"] else b""
    msg = bytes.fromhex(row["msg_hex"])
    pub, sig = H.ed25519_sign(HC, bytes.fromhex(row["priv"]), msg, variant,
                              ctx)
    assert sig.hex() == row["sig"]
    bad = bytes([sig[0] ^ 1]) + sig[1:]
    acc = eddsa.verify_batch(variant, [pub] * 3, [msg, msg + b"x", msg],
                             [sig, sig, bad], context=ctx, device="cpu")
    assert acc.tolist() == [True, False, False]


def test_kat_count_and_signer_key():
    assert sorted(VARIANT[r["alg"]] for r in _kats()) == (
        ["ed25519"] * 3 + ["ed25519ctx"] * 4 + ["ed25519ph"])
    seed = bytes.fromhex("9d61b19deffd5a60ba844af492ec2cc4"
                         "4449c5697b326919703bac031cae7f60")
    assert H.ed25519_public(HC, seed).hex() == _wycheproof()[0]["pub"]


def test_verify_batch_api():
    rng = np.random.RandomState(92)
    seed, msg = rng.bytes(32), rng.bytes(20)
    pub, sig = H.ed25519_sign(HC, seed, msg, "ed25519ctx", b"ctx")
    acc = eddsa.verify_batch("ed25519ctx", [pub, pub, pub[:31], pub],
                             [msg] * 4, [sig, sig[:63], sig, sig],
                             context=b"ctx", device="cpu")
    assert acc.tolist() == [True, False, False, True]
    assert not eddsa.verify_batch("ed25519ctx", [pub], [msg], [sig],
                                  context=b"other", device="cpu")[0]
    pub2, sig2 = H.ed25519_sign(HC, seed, msg)
    assert eddsa.verify_batch(C, [pub2], [msg], [sig2], device="cpu")[0]
    assert eddsa.verify_batch("ed25519", [], [], [], device="cpu").size == 0
    with pytest.raises(ValueError):
        eddsa.verify_batch("ed25519", [pub2], [msg], [sig2], context=b"c",
                           device="cpu")
    with pytest.raises(ValueError):
        eddsa.verify_batch("ed25519ctx", [pub], [msg], [sig], device="cpu")
    # Ed448 verifies now; Ed25519-length keys and signatures reject there
    assert eddsa.verify_batch("ed448", [pub], [msg], [sig],
                              device="cpu").tolist() == [False]
    with pytest.raises(ValueError):
        eddsa.verify_batch("ed25519", [pub2, pub2], [msg], [sig2],
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            eddsa.verify_batch("ed25519", [pub2], [msg], [sig2])


@pytest.mark.slow
def test_verify_batch_matches_jitted_jax():
    """The JAX package's jitted verify_batch on the Wycheproof rows (about
    a minute and a half of compiling on the CPU)."""
    rows = _wycheproof()
    args = ([bytes.fromhex(v["pub"]) for v in rows],
            [bytes.fromhex(v["msg"]) for v in rows],
            [bytes.fromhex(v["sig"]) for v in rows])
    want = np.asarray(jeddsa.verify_batch("ed25519", *args)).tolist()
    assert eddsa.verify_batch("ed25519", *args, device="cpu").tolist() == want
