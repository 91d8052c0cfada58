"""The port's user-facing verify API on the CPU: the fused bytes-in path
against verify_batch, the pipelined verify_batches, the card-by-default
rule, and that the port runs without JAX or the JAX package."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libecc_tpu_torch.curves import params
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import ecdsa, keys as K

C = params.get_curve("P-256")
Q = C.q
WC = H.WCurve(C.fp_ctx.p_int, C.a, C.b, C.gx, C.gy, Q)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker (several workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(n, seed):
    """n (key, 32-byte message, signature) tuples from the host oracle,
    and a corrupted copy with its expected accept mask."""
    rng = np.random.RandomState(seed)
    privs = [1 + int.from_bytes(rng.bytes(32), "big") % (Q - 1)
             for _ in range(n)]
    pubs = [H.ec_mul(WC, d, (C.gx, C.gy)) for d in privs]
    msgs = [rng.bytes(32) for _ in range(n)]
    sigs = []
    for d, m in zip(privs, msgs):
        e = H.trunc_msb_mod_q(hashlib.sha256(m).digest(), Q)
        k = 1 + int.from_bytes(rng.bytes(32), "big") % (Q - 1)
        r, s = H.ecdsa_sign_ref(WC, d, e, k)
        sigs.append(r.to_bytes(32, "big") + s.to_bytes(32, "big"))
    bad_m, bad_s = list(msgs), list(sigs)
    r0 = int.from_bytes(sigs[0][:32], "big") + 1
    bad_s[0] = r0.to_bytes(32, "big") + sigs[0][32:]          # r + 1
    bad_s[1] = sigs[1][:32] + bytes(32)                        # s = 0
    bad_s[2] = sigs[2][:32] + Q.to_bytes(32, "big")            # s = q
    bad_m[3] = bytes([msgs[3][0] ^ 1]) + msgs[3][1:]           # message
    want = np.ones(n, bool)
    want[:4] = False
    kb = K.pubkey_batch_from_affine_ints(C, "ECDSA", [pt[0] for pt in pubs],
                                         [pt[1] for pt in pubs],
                                         device="cpu")
    return kb, msgs, sigs, bad_m, bad_s, want


@pytest.fixture(scope="module")
def fx():
    return _fixture(64, 61)


def test_fused_path_matches_verify_batch(fx):
    kb, msgs, sigs, bad_m, bad_s, want = fx
    assert ecdsa._fused_applicable(bad_m, bad_s, 32)
    fused = ecdsa.verify_batch_async(kb, bad_m, bad_s)
    assert isinstance(fused, torch.Tensor) and fused.dtype == torch.bool
    plain = ecdsa.verify_batch(kb, bad_m, bad_s)
    assert fused.numpy().tolist() == plain.tolist() == want.tolist()


def test_verify_batches_pipeline(fx):
    kb, msgs, sigs, bad_m, bad_s, want = fx
    outs = list(ecdsa.verify_batches(kb, [(msgs, sigs)], depth=2))
    assert len(outs) == 1 and outs[0].all()
    with pytest.raises(ValueError):
        next(ecdsa.verify_batches(kb, [(msgs, sigs[:-1] + [b"\x01" * 63])]))
    with pytest.raises(ValueError):
        ecdsa.verify_batch(kb, msgs, sigs, hash_name="SM3")


def test_adata_is_accepted_and_ignored(fx):
    """The three ECDSA verify entry points take adata, as the reference's
    do, and ignore it: each gives the mask it gives without it (want, which
    test_fused_path_matches_verify_batch holds both paths to)."""
    import inspect

    from libecc_tpu.sig import ecdsa as ref_ecdsa
    names = ("verify_batch", "verify_digests_batch", "verify_batch_async")
    for mod in (ecdsa, ref_ecdsa):
        for name in names:
            par = inspect.signature(getattr(mod, name)).parameters
            assert "adata" in par and par["adata"].default is None, \
                (mod.__name__, name)
    kb, msgs, sigs, bad_m, bad_s, want = fx
    ad = b"\x01\x02"
    digs = [hashlib.sha256(m).digest() for m in bad_m]
    got = [ecdsa.verify_batch(kb, bad_m, bad_s, adata=ad),
           ecdsa.verify_digests_batch(kb, digs, bad_s, adata=ad),
           ecdsa.verify_batch_async(kb, bad_m, bad_s, adata=ad).numpy()]
    assert all(g.tolist() == want.tolist() for g in got)


def test_entry_points_default_to_the_card():
    """Without device="cpu" an entry point runs on the card, and raises
    where there is none rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        K.pubkey_batch_from_affine_ints(C, "ECDSA", [C.gx], [C.gy])
    with pytest.raises(RuntimeError, match="CUDA"):
        K.import_pub_raw(C, "ECDSA", [C.gx.to_bytes(32, "big")
                                      + C.gy.to_bytes(32, "big")])


def test_keys_from_jax_takes_the_device():
    """convert.keys_from_jax has no default device: without one it raises
    TypeError; with "cpu" it gives the key batch on the CPU, whose public
    points are the coordinates it was given (15-bit limbs of the JAX
    package's Montgomery domain R = 2^(15 K_j))."""
    from libecc_tpu_torch import convert
    p, kj = C.fp_ctx.p_int, 20
    rj = 1 << (15 * kj)
    pub = H.ec_mul(WC, 7, (C.gx, C.gy))
    x, y, z = (convert.limbs15_from_ints([v * rj % p], kj)
               for v in (pub[0], pub[1], 1))
    with pytest.raises(TypeError):
        convert.keys_from_jax(C, x, y, z)
    kb = convert.keys_from_jax(C, x, y, z, "cpu")
    assert kb.n == 1 and kb.alg == "ECDSA"
    assert all(v.device.type == "cpu" for v in kb.pub)
    assert [C.fp_ctx.to_ints(v)[0] for v in kb.pub] == [pub[0], pub[1], 1]


HYGIENE = r"""
import hashlib, sys
import torch
torch.set_num_threads(1)
from libecc_tpu_torch.curves import params
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import ecdsa, keys as K
c = params.get_curve("P-256")
wc = H.WCurve(c.fp_ctx.p_int, c.a, c.b, c.gx, c.gy, c.q)
pub = H.ec_mul(wc, 7, (c.gx, c.gy))
msg = b"import hygiene"
r, s = H.ecdsa_sign_ref(wc, 7, H.trunc_msb_mod_q(hashlib.sha256(msg).digest(),
                                                 c.q), 11)
kb = K.pubkey_batch_from_affine_ints(c, "ECDSA", [pub[0]] * 2, [pub[1]] * 2,
                                     device="cpu")
sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
acc = ecdsa.verify_batch(kb, [msg, msg + b"!"], [sig, sig])
assert acc.tolist() == [True, False], acc
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "libecc_tpu.")))
assert not bad, bad
print("clean")
"""


def test_port_imports_no_jax():
    """In a fresh interpreter (this process has jax loaded by conftest),
    importing the port and verifying on the CPU loads neither jax nor any
    module of the JAX package."""
    out = subprocess.run([sys.executable, "-c", HYGIENE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors every kernel wrapper returns its plain version's
    result and counts no launch."""
    from libecc_tpu_torch.curves import scalar_mul
    from libecc_tpu_torch.curves.shortw import PrjPoint
    from libecc_tpu_torch.nn import core as nn
    from libecc_tpu_torch.ops.cuda import megamul, mont, point
    counters = [mont.launches, point.launches, megamul.launches]
    before = [dict(d) for d in counters]
    ctx = C.fp_ctx
    a = ctx.from_ints([3, 5, 7], "cpu")
    b = ctx.from_ints([11, 13, 17], "cpu")
    assert torch.equal(mont.mont_mul(a, b, ctx), nn.mont_mul(a, b, ctx))
    assert torch.equal(mont.mont_sqr(a, ctx), nn.mont_sqr(a, ctx))
    G = C.generator(batch_shape=(3,), device="cpu")
    G = PrjPoint(*[t.contiguous() for t in G])
    assert all(torch.equal(x, y) for x, y in zip(
        point.point_add(C, G, G), point.point_add_plain(C, G, G)))
    assert all(torch.equal(x, y) for x, y in zip(
        point.point_dbl(C, G), point.point_dbl_plain(C, G)))
    m = C.q_ctx.from_ints([0, 9, Q - 1], "cpu", to_mont=False)
    table = scalar_mul._build_mul_table(C, G)
    digs = scalar_mul._window_digits(m, 256)
    assert all(torch.equal(x, y) for x, y in zip(
        megamul.windowed_mul(C, table, digs, PrjPoint),
        megamul.windowed_mul_plain(C, table, digs, PrjPoint)))
    assert [dict(d) for d in counters] == before


def test_chip_check_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
