"""BIP-340 (Schnorr signatures over secp256k1): the tagged hash.

Port of ``libecc_tpu/sig/bip0340.py:tagged_hash`` (:34), which batch
verification needs for its challenges. Signing and single verification
are not ported yet.
"""

from __future__ import annotations


def tagged_hash(alg, tag: bytes, *chunks: bytes) -> bytes:
    """BIP-340 tagged hash H(H(tag) || H(tag) || chunks...); ``alg`` is a
    hashlib constructor (``hashlib.sha256`` for BIP-340 itself)."""
    th = alg(tag).digest()
    st = alg(th + th)
    for c in chunks:
        st.update(c)
    return st.digest()
