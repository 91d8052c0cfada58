"""test_torch_joint_wide.py at K = 14: the joint-table Straus
(straus_double_mul_public) on WEI448 (kernel 5 at K = 14, generic a) and
Ed448 (kernel 8c at K = 14, a = 1), on the CPU through the plain
versions, against straus_double_mul_public_w4 and the host oracle in
affine form. Exact."""

import pytest

from test_torch_joint_wide import check_joint_straus
from test_torch_registry import _one_torch_thread

assert _one_torch_thread                # the module's autouse fixture


@pytest.mark.parametrize("name", ["WEI448", "ED448"])
def test_joint_straus_matches_w4_and_the_oracle(name):
    check_joint_straus(name)
