"""The port's batch verification on the large-K curves, on the CPU: Ed448
and Ed448ph (K = 14, a = 1: kernels 6-ed and 8a at K = 14) and ECFSDSA on
P-384 (K = 12, a = -3: kernels 6 and 2), each on a valid batch (whose
check sides equal the host oracle's c*G and sum of z_i R_i + z_i e_i
Y_i), a batch with one flipped bit of s and a batch with one changed
message; the Ed448 challenge against the reference's _xof (dom4, a
context, the prehash); the early returns of Ed448 encodings whose y is at
or above p (y >= 2^448 does not fit the K = 14 limbs); the hash names
refused. Exact: projective values mod p and bools.

Each batch runs the whole check through the plain versions of the
kernels, about 3-6 s here. The other files of these paths, each kept under
a minute: test_torch_batch_verify_bp512.py (the same cases on
BrainpoolP512r1, K = 16, generic a), test_torch_batch_verify_wide_jax.py
(the comparisons with the JAX package's entry points) and
test_torch_batch_verify_wide_kat.py (the KAT rows and the plain Straus
multiply against the host oracle)."""

import random

import pytest
import torch

from libecc_tpu.sig import eddsa as jeddsa

from libecc_tpu_torch.curves import edwards as ed, params
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import batch_verify as bv, eddsa, keys

N = 4
# scheme -> (variant or curve, hash name)
SCHEMES = {"ed448": ("ed448", "SHAKE256"), "ed448ph": ("ed448ph", "SHAKE256"),
           "ecfsdsa_p384": ("SECP384R1", "SHA384"),
           "ecfsdsa_bp512": ("BRAINPOOLP512R1", "SHA512")}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """The JAX package on its XLA path; one intra-op thread for the port's
    tiny tensors, in inference mode."""
    monkeypatch.setenv("LIBECC_TPU_PALLAS", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


def rng_of(seed):
    r = random.Random(seed)
    return lambda n: bytes(r.randrange(256) for _ in range(n))


def ed448():
    c = ed.get_edwards_curve("ED448")
    return c, H.EdCurve(c.fp_ctx.p_int, c.a, c.d, c.gx, c.gy, c.q, c.h)


def host_w(name):
    c = params.get_curve(name)
    return c, H.WCurve(c.fp_ctx.p_int, c.a, c.b, c.gx, c.gy, c.q)


def fixture(scheme, context=b""):
    """(keys or public-key bytes, messages, signatures) of N signatures
    from the host signers."""
    msgs = [bytes([i]) * 20 for i in range(N)]
    what, hash_name = SCHEMES[scheme]
    if scheme.startswith("ed448"):
        _, hc = ed448()
        pairs = [H.ed448_sign(hc, bytes([i + 1]) * 57, m, what, context)
                 for i, m in enumerate(msgs)]
        return [a for a, _ in pairs], msgs, [s for _, s in pairs]
    c, wc = host_w(what)
    ds = [i + 2 for i in range(N)]
    pubs = [H.ec_base_mul(wc, d) for d in ds]
    sigs = [H.ecfsdsa_sign_ref(wc, d, 5 * i + 11, m, hash_name)
            for i, (d, m) in enumerate(zip(ds, msgs))]
    kb = keys.pubkey_batch_from_affine_ints(c, "ECFSDSA", [P[0] for P in pubs],
                                            [P[1] for P in pubs],
                                            device="cpu")
    return kb, msgs, sigs


def verify(scheme, first, msgs, sigs, seed, context=b""):
    what, hash_name = SCHEMES[scheme]
    if scheme.startswith("ed448"):
        return bv.eddsa_verify_batch(what, first, msgs, sigs, context,
                                     rng=rng_of(seed), device="cpu")
    return bv.ecfsdsa_verify_batch(first, msgs, sigs, hash_name,
                                   rng=rng_of(seed), device="cpu")


def ed448_decode(b: bytes):
    """RFC 8032 5.2.3 on the host (p = 3 mod 4)."""
    c, _ = ed448()
    p = c.fp_ctx.p_int
    y = int.from_bytes(b, "little") & ((1 << 455) - 1)
    x2 = (y * y - 1) * pow(c.d * y * y - 1, -1, p) % p
    x = pow(x2, (p + 1) // 4, p)
    assert x * x % p == x2
    if x & 1 != b[56] >> 7:
        x = p - x
    return (x, y)


def host_sides(scheme, first, msgs, sigs, seed, context=b""):
    """The host oracle's c*G and sum_i (z_i R_i + z_i e_i Y_i), affine, for
    the z_i the seeded rng gives."""
    zs = bv._rand_zs(N, rng_of(seed))
    what, hash_name = SCHEMES[scheme]
    if scheme.startswith("ed448"):
        c, hc = ed448()
        q = c.q
        v = eddsa.get_variant(what)
        acc, cc = (0, 1), 0
        for z, a, m, s in zip(zs, first, msgs, sigs):
            k = int.from_bytes(H._shake256(
                H.ed448_dom(what, context) + s[:57] + a
                + (H._shake256(m, 64) if v.phflag else m)), "little") % q
            term = H.ed_add(hc, H.ed_mul(hc, z, ed448_decode(s[:57])),
                            H.ed_mul(hc, z * k % q, ed448_decode(a)))
            acc = H.ed_add(hc, acc, term)
            cc = (cc + z * int.from_bytes(s[57:], "little")) % q
        return H.ed_mul(hc, cc, (c.gx, c.gy)), acc
    c, wc = host_w(what)
    q, pl = c.q, (c.fp_ctx.bits + 7) // 8
    h = bv._host_hash(hash_name)
    xs, ys, _ = first.pub_affine_ints()
    acc, cc = None, 0
    for z, x, y, m, sg in zip(zs, xs, ys, msgs, sigs):
        R = (int.from_bytes(sg[:pl], "big"),
             int.from_bytes(sg[pl:2 * pl], "big"))
        e = int.from_bytes(h(sg[:2 * pl] + m).digest(), "big") % q
        term = H.ec_add(wc, H.ec_mul(wc, z, R), H.ec_mul(wc, z * e % q,
                                                         (x, y)))
        acc = H.ec_add(wc, acc, term)
        cc = (cc + z * int.from_bytes(sg[2 * pl:], "big")) % q
    return H.ec_mul(wc, cc, (c.gx, c.gy)), acc


def affine(c, P):
    p = c.fp_ctx.p_int
    x, y, z = [c.fp_ctx.to_ints(v)[0] for v in P[:3]]
    if z == 0:
        return None
    return (x * pow(z, -1, p) % p, y * pow(z, -1, p) % p)


def flip_s(scheme, sig):
    """The lowest bit of s (little-endian S of Ed448 at byte 57, big-endian
    s of ECFSDSA at the last byte)."""
    i = 57 if scheme.startswith("ed448") else len(sig) - 1
    return sig[:i] + bytes([sig[i] ^ 1]) + sig[i + 1:]


def check_accept_reject(scheme, case, monkeypatch):
    """A valid batch accepts (and the check's two sides equal the host
    oracle's); one flipped bit of s, or one changed message, rejects the
    whole batch."""
    first, msgs, sigs = fixture(scheme)
    sides = []
    real = bv._combined_sides

    def spy(*a):
        out = real(*a)
        sides.append(out)
        return out
    monkeypatch.setattr(bv, "_combined_sides", spy)
    if case == "valid":
        assert verify(scheme, first, msgs, sigs, 1) is True
        c = (ed448()[0] if scheme.startswith("ed448")
             else params.get_curve(SCHEMES[scheme][0]))
        lhs, rhs = sides[0]
        assert [affine(c, P) for P in (lhs, rhs)] == list(
            host_sides(scheme, first, msgs, sigs, 1))
    elif case == "sig_bit":
        bad = list(sigs)
        bad[2] = flip_s(scheme, bad[2])
        assert verify(scheme, first, msgs, bad, 2) is False
    else:
        bad = list(msgs)
        bad[0] = b"evil"
        assert verify(scheme, first, bad, sigs, 3) is False
    assert len(sides) == 1


CASES = ["valid", "sig_bit", "message"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("scheme", ["ecfsdsa_p384", "ed448", "ed448ph"])
def test_batch_accept_reject(scheme, case, monkeypatch):
    check_accept_reject(scheme, case, monkeypatch)


@pytest.mark.parametrize("variant,context", [("ed448", b""),
                                             ("ed448", b"foo"),
                                             ("ed448ph", b""),
                                             ("ed448ph", b"context")])
def test_ed448_challenge_matches_the_reference_xof(variant, context):
    """eddsa._xof over dom4 || R || A || PH(M) gives the reference's _xof
    bytes (SHAKE256 at 114 bytes) with and without a context and for the
    prehash; for Ed25519 it stays SHA-512."""
    pub, msgs, sigs = fixture(variant, context)
    v, jv = eddsa.get_variant(variant), jeddsa.get_variant(variant)
    pre, jpre = eddsa._dom(v, context), jeddsa._dom(jv, context)
    assert pre == jpre == H.ed448_dom(variant, context)
    for a, m, s in zip(pub, msgs, sigs):
        ph, jph = eddsa._prehash(v, m), jeddsa._prehash(jv, m)
        assert ph == jph
        got = eddsa._xof(v, pre, s[:57], a, ph)
        assert len(got) == 114
        assert got == jeddsa._xof(jv, jpre, s[:57], a, jph)
    v25 = eddsa.get_variant("ed25519")
    assert eddsa._xof(v25, b"ab", b"c") == jeddsa._xof(
        jeddsa.get_variant("ed25519"), b"ab", b"c")


def _y_cases():
    """name -> (public keys, signatures) of N Ed448 signatures with one A
    or R encoding whose y is p, p + 1 or has a bit of 448-454 set."""
    pub, msgs, sigs = fixture("ed448")
    p = ed448()[0].fp_ctx.p_int

    def enc(y, sign=0):
        return (y | sign << 455).to_bytes(57, "little")

    y_r = int.from_bytes(sigs[1][:57], "little")
    return {
        "a_y_eq_p": ([enc(p)] + pub[1:], sigs),
        "a_y_bit_450": ([enc(int.from_bytes(pub[0], "little") | 1 << 450)]
                        + pub[1:], sigs),
        "r_y_p_plus_1": (pub, sigs[:1] + [enc(p + 1) + sigs[1][57:]]
                         + sigs[2:]),
        "r_y_bit_454": (pub, sigs[:1] + [enc(y_r | 1 << 454) + sigs[1][57:]]
                        + sigs[2:]),
    }, msgs


@pytest.mark.parametrize("case", ["a_y_eq_p", "a_y_bit_450", "r_y_p_plus_1",
                                  "r_y_bit_454"])
def test_ed448_y_out_of_range_returns_early(case, monkeypatch):
    """An A or R whose y is at or above p rejects before the decode (the
    reference's decode rejects y >= p; a y of 449-455 bits does not fit
    the port's K = 14 limbs, so it must not reach the limb conversion)."""
    cases, msgs = _y_cases()
    pub, sigs = cases[case]

    def never(*a):
        raise AssertionError("decoded")
    monkeypatch.setattr(eddsa, "decode_core", never)
    assert verify("ed448", pub, msgs, sigs, 4) is False


def test_refusals():
    """A hash outside SHA-2 and SHA-3 raises NotImplementedError, naming the
    hash layer's queue item; the SHA-3 and underscore names are taken."""
    kb, msgs, sigs = fixture("ecfsdsa_p384")
    for name in ("SM3", "STREEBOG512", "SHA512/256", "SHAKE256"):
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            bv.ecfsdsa_verify_batch(kb, msgs, sigs, name, device="cpu")
    for name in ("SHA3_256", "SHA_256", "sha3-512", "SHA-384"):
        assert bv._host_hash(name)().name.replace("-", "_") in (
            "sha3_256", "sha256", "sha3_512", "sha384")
