"""Port parity, ops/gather (kernel K6) and the gather probe: the plain
version `table.index_select(0, idx)` against `jnp.take(table, idx, axis=0)`
(the reference probe's baseline), bit for bit, on the same numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu_torch.experiments import gather_probe
from optixpathtracer_tpu_torch.ops import gather


@pytest.mark.parametrize("rows, width, n", [(4096, 128, 20000), (1000, 7, 333), (64, 4, 0)])
def test_gather_rows_torch_matches_jnp_take(rows, width, n):
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((rows, width)).astype(np.float32)
    table.reshape(-1)[:4] = [np.inf, -np.inf, -0.0, np.nan]  # bits move as they are
    idx = rng.integers(0, rows, n).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    for fn in (gather.gather_rows_torch, gather.gather_rows):  # the wrapper takes it on CPU
        got = fn(torch.as_tensor(table), torch.as_tensor(idx))
        assert got.shape == (n, width) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_gather_dispatch_has_no_fallback():
    table = torch.zeros((16, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gather.gather_rows(table, torch.zeros(3, dtype=torch.int32, device="meta"))


def test_gather_probe_inputs_match_reference_probe():
    """The probe's table and indices are the reference probe's (arange
    table, numpy seed-0 row indices); it measures only a CUDA device."""
    table = gather_probe.probe_table(torch.device("cpu"), n_rows=256, row_width=8)
    idx = gather_probe.probe_indices(torch.device("cpu"), 1000, n_rows=256)
    np.testing.assert_array_equal(table.numpy(), np.asarray(
        jnp.arange(256 * 8, dtype=jnp.float32).reshape(256, 8)))
    want = np.random.default_rng(0).integers(0, 256, size=1000)
    np.testing.assert_array_equal(idx.numpy(), want.astype(np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_probe.measure(torch.device("cpu"))
