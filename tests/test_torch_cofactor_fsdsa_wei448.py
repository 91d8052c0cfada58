"""ECFSDSA batch verification on WEI448 (h = 4, K = 14, generic a, under
SHA-512: kernel 6 at K = 14 on the card), on the CPU, as
test_torch_cofactor_fsdsa.py does at K = 8: a host-signed batch whose
keys come through the checked import (the q*P subgroup check) accepts,
and one flipped bit of s rejects it (another message is tried at K = 8
and on every curve on the card: each batch call costs about 10 s here).
Exact."""

from test_torch_cofactor import check_accepts_and_rejects
from test_torch_registry import _one_torch_thread

assert _one_torch_thread                # the module's autouse fixture


def test_ecfsdsa_batch_accepts_and_rejects():
    check_accepts_and_rejects("WEI448", other_message=False)
