"""The port's batch verification on BrainpoolP512r1 (K = 16, generic a:
kernel 6 at K = 16 and kernel 2), on the CPU: ECFSDSA on a valid batch
(whose check sides equal the host oracle's), a batch with one flipped bit
of s and a batch with one changed message, the BRAINPOOLP512R1 ECFSDSA
row of kats_full.jsonl (SHA-512) as a batch, and the plain separate-table
Straus multiply (128 windows) against the host oracle. The checks are
those of test_torch_batch_verify_wide.py and
test_torch_batch_verify_wide_kat.py, in a file of their own so that each
file's tier stays under a minute (a batch here is about 7 s)."""

import pytest
import torch

from test_torch_batch_verify_wide import CASES, check_accept_reject
from test_torch_batch_verify_wide_kat import (check_ecfsdsa_kat_row,
                                              check_plain_straus)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.inference_mode():
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES)
def test_batch_accept_reject(case, monkeypatch):
    check_accept_reject("ecfsdsa_bp512", case, monkeypatch)


def test_ecfsdsa_kat_row_as_a_batch():
    check_ecfsdsa_kat_row("BRAINPOOLP512R1", "SHA512")


def test_plain_straus_against_the_oracle():
    check_plain_straus("BRAINPOOLP512R1")
