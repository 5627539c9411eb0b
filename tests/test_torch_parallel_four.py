"""Port parity, parallel/tiles over 4 gloo CPU ranks: tests/test_torch_parallel.py's
comparison with the JAX `DistributedRenderer` on a 4-device mesh (its own
file: each JAX interpret-mode compile takes 15-20 s on one CPU thread)."""
from test_torch_parallel import check_vs_jax


def test_distributed_renderer_vs_jax_four_ranks(tmp_path):
    check_vs_jax(tmp_path, 4)
