"""The `loft*` and `foveated` goldens through the port's lockstep walk, the
walk that rendered them (see tests/test_torch_goldens_lockstep.py), within
sqrt-space RMSE 2e-3; a file of their own, as their lockstep renders are
the longest on one CPU thread."""
import pytest
import torch

from tests.test_torch_goldens_lockstep import check

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["loft_s", "loft", "foveated"])
def test_golden_through_the_lockstep_walk(name):
    check(name)
