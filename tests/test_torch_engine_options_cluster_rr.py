"""`nee_rr` against the JAX cluster walk on the open golden scene: the
third option case of tests/test_torch_engine_options_cluster.py, in a
file of its own for time, with its tolerances."""
import torch

from tests.test_torch_engine_options_cluster import test_option_equal_to_jax_cluster_walk as check

torch.set_num_threads(1)


def test_nee_rr_equal_to_jax_cluster_walk():
    check(dict(nee_rr=0.5))
