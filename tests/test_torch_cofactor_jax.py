"""The cofactor > 1 curves against the JAX package, on the CPU. Default
tier: neither package runs the q*P subgroup check of public-key import on
an h == 1 curve by default or where it is switched off. Slow, because
the JAX package's order check is one jitted call of 55-80 s here and its
eager verify_core on WEI25519 about 75 s (a file's default tier has 60
s): on WEI25519 (h = 8) and GOST R 34.10-2012 256 paramSetA (h = 4), 8
keys d*G, three with a point of small order added, and a ninth key, the
curve's point T2 of order 2 (y = 0) (test_torch_cofactor.mixed_keys):
the masks that both packages' order_check_mask give inside the default
import (spies) are taken, and the port's equals the host oracle's on
every lane. The host oracle gives q*T2 = T2, so T2 is refused, and the
port refuses it; the JAX package passes it, a fault that the reference
keeps: the complete addition formulas (Renes-Costello-Batina) are not
complete on a curve with points of order 2, so the windowed multiply
adds the identity (0 : Y : 0) to T2 and gets (0 : 0 : 0), which reads as
the identity. The port tests y = 0 beside the multiply. So the two masks
differ exactly at T2, and the two imports raise naming the same keys but
T2. Then the two verify_core on WEI25519's 16 adversarial lanes, lane for
lane. The port's check against the host oracle, without JAX, is in
test_torch_cofactor.py. Exact."""

import jax.numpy as jnp
import numpy as np
import pytest

from libecc_tpu.curves import params as jparams
from libecc_tpu.nn import core as jnn
from libecc_tpu.sig import ecdsa as jecdsa, keys as jkeys

from libecc_tpu_torch import convert
from libecc_tpu_torch.curves import params
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import ecdsa, keys as K

from test_torch_cofactor import CURVES, cofactor_lanes, mixed_keys
from test_torch_registry import _one_torch_thread, digest, host

assert _one_torch_thread                # the module's autouse fixture


def import_both(name, pts, monkeypatch):
    """Import the affine keys pts with both packages' defaults, spying on
    their order_check_mask: (the port's ValueError or None, the JAX
    package's, {package: mask})."""
    c, jc = params.get_curve(name), jparams.get_curve(name)
    xs, ys = [P[0] for P in pts], [P[1] for P in pts]
    masks = {}
    for mod, key in ((K, "port"), (jkeys, "jax")):
        def spy(cv, pub, real=mod.order_check_mask, key=key):
            return masks.setdefault(key, np.asarray(real(cv, pub)))
        monkeypatch.setattr(mod, "order_check_mask", spy)
    errs = []
    for call in (lambda: K.pubkey_batch_from_affine_ints(
                     c, "ECDSA", xs, ys, device="cpu"),
                 lambda: jkeys.pubkey_batch_from_affine_ints(
                     jc, "ECDSA", xs, ys)):
        try:
            call()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    return errs[0], errs[1], masks


@pytest.mark.slow
@pytest.mark.parametrize("name,seed", [
    ("WEI25519", 403), ("GOST_R3410_2012_256_PARAMSETA", 405)])
def test_order_check_matches_jax(name, seed, monkeypatch):
    c = params.get_curve(name)
    pts, want = mixed_keys(c, seed, order2=True)
    t2 = len(pts) - 1
    assert pts[t2][1] == 0 and H.ec_mul(host(c), c.q, pts[t2]) == pts[t2]
    err, jerr, masks = import_both(name, pts, monkeypatch)
    msg = "public key(s) {}: point not in the order-q subgroup"
    assert err == msg.format([1, 4, 6, t2])
    assert jerr == msg.format([1, 4, 6])
    assert masks["port"].tolist() == want
    # the fault that the JAX package keeps: T2 passes its check
    assert np.flatnonzero(masks["port"] != masks["jax"]).tolist() == [t2]


def test_neither_checks_where_it_should_not(monkeypatch):
    """h == 1 (P-256) by default, and WEI25519 with check_order=False or
    validate=False: no order_check_mask call in either package."""
    calls = []
    for mod in (K, jkeys):
        monkeypatch.setattr(mod, "order_check_mask",
                            lambda cv, pub: calls.append(cv.name))
    for name, kw in (("P-256", {}), ("WEI25519", {"check_order": False}),
                     ("WEI25519", {"validate": False})):
        c, jc = params.get_curve(name), jparams.get_curve(name)
        K.pubkey_batch_from_affine_ints(c, "ECDSA", [c.gx], [c.gy],
                                        device="cpu", **kw)
        jkeys.pubkey_batch_from_affine_ints(jc, "ECDSA", [c.gx], [c.gy],
                                            **kw)
    assert calls == []


@pytest.mark.slow
def test_verify_core_matches_jax_lane_for_lane():
    """The port's and the JAX package's verify_core (the affine accept
    test) on cofactor_lanes, lane for lane, and the host oracle."""
    name = "WEI25519"
    c, jc = params.get_curve(name), jparams.get_curve(name)
    hash_name = CURVES[name]
    _, lanes, want = cofactor_lanes(c, hash_name, 404)
    es = [H.trunc_msb_mod_q(digest(hash_name, m), c.q) for _, m, _, _ in
          lanes]
    pub_j = jc.point_from_affine_ints([ln[0][0] for ln in lanes],
                                      [ln[0][1] for ln in lanes])
    esr = [jnn.batch_to_limbs(v, jc.q_ctx.k)
           for v in (es, [ln[2] for ln in lanes], [ln[3] for ln in lanes])]
    jax_acc = np.asarray(jecdsa.verify_core(
        jc, pub_j, *[jnp.asarray(v) for v in esr])).tolist()
    kb = convert.keys_from_jax(c, *[np.asarray(v) for v in pub_j],
                               "cpu")
    e, r, s = [convert.scalars_from_jax(v, c.q_ctx.k, "cpu") for v in esr]
    got = ecdsa.verify_core(c, kb.pub, e, r, s).tolist()
    assert got == jax_acc == want
