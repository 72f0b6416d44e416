"""The second half of `tests/test_torch_train.py`'s `ARCHS` in bf16 against
the reference: `test_torch_train_bf16_archs.check_arch` (its docstring
holds the harness and the tolerances), on a worker of its own."""

import pytest

from test_torch_train import ARCHS
from test_torch_train_bf16_archs import check_arch


@pytest.mark.parametrize("name", ARCHS[5:])
def test_lm_loss_and_every_gradient_in_bf16_match_the_reference(name):
    check_arch(name)
