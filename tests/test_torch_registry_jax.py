"""The port's plain kernels and ECDSA verify_core on the cofactor-1 curves of
this slice against the JAX package, on the CPU, one file per limb count
(the JAX package compiles its eager operations once per shape, 10-40 s a
limb count here): K = 6 here (the JAX package's K = 15), K = 7 in
test_torch_registry_jax_224.py (17), K = 10 in
test_torch_registry_jax_k10.py (24), K = 12 and 16 in
test_torch_registry_jax_wide.py (28, 37). Kernel 1's plain version
against the JAX package's relaxed product under p and q, through
convert.py (secp224k1's 225-bit q: the port's K = 8 against the JAX
package's 17); kernels 2 and 3's plain versions against the JAX
package's point_add and point_dbl as projective values mod p, on one
curve of each new (K, a) instance; and the JAX verify_core, called
eagerly on the 16 lanes of test_torch_registry.ecdsa_lanes (16 is not a
multiple of 1024, so the JAX package takes no Pallas kernel), lane for
lane: P-192 here, P-224 in test_torch_registry_jax_224.py, secp224k1 in
test_torch_registry_jax_224k1.py, BrainpoolP320r1 (and, slow,
BrainpoolP384r1, BrainpoolP512t1 and the JAX ECFSDSA P-521 batch) in
test_torch_registry_jax_wide.py. Kernel 4's plain version runs against
the host oracle in test_torch_registry_wide.py. Exact everywhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libecc_tpu.curves import params as jparams, shortw as jshortw
from libecc_tpu.nn import core as jnn
from libecc_tpu.sig import ecdsa as jecdsa

from libecc_tpu_torch import convert
from libecc_tpu_torch.curves import params, shortw
from libecc_tpu_torch.nn import core as nn
from libecc_tpu_torch.ref import hostref as H
from libecc_tpu_torch.sig import ecdsa

from test_torch_ecdsa_wide import _affine, _affine_pairs, _jax_point
from test_torch_registry import (HASH, _one_torch_thread, digest,
                                 ecdsa_lanes, host, ints)

assert _one_torch_thread                # the module's autouse fixture
# one curve for each new (K, a) instance at K = 6
K6 = ["SECP192R1", "BRAINPOOLP192R1", "SECP192K1"]
# (port K, JAX K) of p, and of q where it differs
LIMBS = {"SECP192R1": (6, 15), "SECP224R1": (7, 17), "SECP224K1": (8, 17),
         "BRAINPOOLP320R1": (10, 24)}


def check_mont(name, which):
    """Kernel 1's plain version against the JAX package's relaxed product,
    edge operands included: m - 1 squared and times m - 2 take the
    reduction's conditional subtraction at its largest."""
    c, jc = params.get_curve(name), jparams.get_curve(name)
    ctx, jctx = (c.fp_ctx, jc.fp_ctx) if which == "p" else (c.q_ctx,
                                                           jc.q_ctx)
    assert (ctx.k, jctx.k) == LIMBS[name]
    m = ctx.p_int
    rng = np.random.RandomState(321)
    edges = [0, 1, 2, m - 1, m - 2, (1 << (m.bit_length() - 1)) % m]
    xs = edges + ints(rng, 10, m)
    ys = edges[::-1] + ints(rng, 10, m)
    aj = jnn.batch_to_limbs([x * jctx.R % m for x in xs], jctx.k)
    bj = jnn.batch_to_limbs([y * jctx.R % m for y in ys], jctx.k)
    pj = np.asarray(jnn.mont_mul_relaxed(jnp.asarray(aj), jnp.asarray(bj),
                                         jctx))
    sj = np.asarray(jnn.mont_sqr_relaxed(jnp.asarray(aj), jctx))
    a = convert.fe_from_jax(aj, ctx, "cpu")
    b = convert.fe_from_jax(bj, ctx, "cpu")
    assert ctx.to_ints(a) == xs and ctx.to_ints(b) == ys
    got = nn.mont_mul(a, b, ctx)
    assert torch.equal(got, convert.fe_from_jax(pj, ctx, "cpu"))
    assert torch.equal(nn.mont_sqr(a, ctx), convert.fe_from_jax(sj, ctx,
                                                                "cpu"))
    assert ctx.to_ints(got) == [x * y % m for x, y in zip(xs, ys)]


def check_add_dbl(name):
    """Kernels 2 and 3's plain versions for the curve's formula set against
    the JAX package's shortw.point_add and point_dbl, as projective values
    mod p: identity, P = Q and P = -Q lanes included. 16 lanes, as
    verify_core's: the JAX package compiles its eager operations once for
    both."""
    c, jc = params.get_curve(name), jparams.get_curve(name)
    rng = np.random.RandomState(322)
    A, B = _affine_pairs(c, rng, 16)
    Aj, Bj = _jax_point(jc, A, rng), _jax_point(jc, B, rng)

    def port(Pj):
        return convert.point_from_jax(c, *[np.asarray(v) for v in Pj], "cpu")

    def vals_jax(Pj):
        return [jc.fp_ctx.to_ints(v) for v in Pj]

    want = vals_jax(jshortw.point_add(jc, Aj, Bj))
    got = shortw.point_add(c, port(Aj), port(Bj))
    assert [c.fp_ctx.to_ints(v) for v in got] == want
    assert _affine(c, want) == [H.ec_add(host(c), a, b)
                                for a, b in zip(A, B)]
    want = vals_jax(jshortw.point_dbl(jc, Aj))
    got = shortw.point_dbl(c, port(Aj))
    assert [c.fp_ctx.to_ints(v) for v in got] == want
    assert _affine(c, want) == [H.ec_add(host(c), a, a) for a in A]


def verify_core_case(name, seed):
    """The port's and the JAX package's verify_core on ecdsa_lanes (the
    curve's hash), the JAX one called eagerly: (port mask, JAX mask,
    wanted mask)."""
    c, jc = params.get_curve(name), jparams.get_curve(name)
    hash_name = HASH.get(name, "SHA256")
    _, lanes, want = ecdsa_lanes(c, hash_name, seed)
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
    return got, jax_acc, want


@pytest.mark.parametrize("which", ["p", "q"])
def test_plain_mont_mul_sqr_against_jax(which):
    check_mont("SECP192R1", which)


@pytest.mark.parametrize("name", K6)
def test_plain_point_add_dbl_against_jax(name):
    check_add_dbl(name)


def test_verify_core_matches_jax_lane_for_lane():
    got, jax_acc, want = verify_core_case("SECP192R1", 331)
    assert got == jax_acc == want
