"""Stage marks inside the verify paths, for per-stage breakdowns.

The verify paths call ``mark(name, *values)`` where each stage ends, with
the stage's outputs. Nothing happens unless a caller has installed a
callback with ``on_mark``; a breakdown (``chip_smoke.py``) installs one that
synchronises the device and reads the clock, so it times the stages of the
code a user calls rather than a copy of it.

Marks, in the order one batch passes them:

* ``sig.eddsa.verify_batch``: "parse", "challenge", then the core's;
* ``sig.ecdsa.verify_batch_async``: "hash" on the fused bytes-in path
  (the padding, the hash and the limb unpacking on the device) or
  "digest" on the unfused one (the messages packed on the host, then the
  tensor hash: SHA-384, SHA-512, SHA-3), then the core's;
* ``sig.ecdsa.verify_core``: "scalars" (u, v), "key on curve", then the
  double multiply's, then "accept";
* ``sig.eddsa.verify_core``: "decode" (the 2N-lane point), then the double
  multiply's, then "accept";
* ``curves.scalar_mul.fixed_base_double_mul_public``: "comb" (u*G),
  "table" (the table and the window digits), "windowed" (v*Q);
* ``sig.keys.pubkey_batch_from_affine_ints``, where the q*P subgroup
  check runs (h > 1 by default): "import" (the host range and on-curve
  checks, the keys uploaded), then ``order_check_mask``'s "order
  check";
* ``sig.batch_verify``'s three entry points: "keys" (BIP0340 only: the
  keys' affine coordinates), "parse" (the host loop: lengths, ranges,
  challenges, z_i, c), "lift" (ECFSDSA: R uploaded; BIP0340: R lifted
  from x, the even-y keys) or "decode" (Ed25519, Ed448: A and R as one
  2N-lane batch), then "table" (both tables and digit arrays, in
  ``straus_double_mul_public_w4``), "straus", "reduce" (the lane-tree
  sum), "comb" (c*G) and "accept".
"""

from __future__ import annotations

from contextlib import contextmanager

_callback = None


def mark(name: str, *values) -> None:
    """End of stage ``name``; ``values`` are its outputs."""
    if _callback is not None:
        _callback(name, *values)


@contextmanager
def on_mark(callback):
    """Call ``callback(name, *values)`` at every mark inside the block."""
    global _callback
    prev, _callback = _callback, callback
    try:
        yield
    finally:
        _callback = prev
