"""Port parity, ops/sc_worklist (kernels K5a and K5b): the plain PyTorch
versions against the reference's XLA contracts `compact_indices_xla` and
`pair_worklist_xla`, bit for bit, on the same numpy inputs.

The cases cover capacity above the input size, capacity below the count
(truncation, with the count still the full popcount), all-zero and
all-set inputs. On CPU tensors the wrappers take the plain versions; on
any other device they launch their CUDA kernel or raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.ops.sc_worklist import compact_indices_xla, pair_worklist_xla
from optixpathtracer_tpu_torch.ops import sc_worklist as sw

# name -> (n, capacity, probability of a set flag)
COMPACT_CASES = {
    "capacity_above_n": (257, 300, 0.3),
    "capacity_below_count": (3000, 500, 0.5),
    "all_zero": (700, 64, 0.0),
    "all_set": (700, 900, 1.0),
    "all_set_truncated": (700, 128, 1.0),
}

# name -> (rows, capacity, probability of a set bit)
PAIR_CASES = {
    "dense_capacity_exact": (37, 37 * 32, 0.5),
    "sparse_capacity_above": (300, 300 * 32 + 50, 0.05),
    "capacity_below_count": (200, 700, 0.3),
    "all_zero": (64, 128, 0.0),
    "all_set": (33, 33 * 32, 1.0),
    "all_set_truncated": (33, 100, 1.0),
}


def _bits(rng, r, p):
    """(r,) uint32 words whose bits are set with probability p."""
    b = rng.random((r, 32)) < p
    return (b.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compact_indices_torch_matches_xla(case):
    n, cap, p = COMPACT_CASES[case]
    flags = np.random.default_rng(n).random(n) < p
    want_idx, want_cnt = compact_indices_xla(jnp.asarray(flags), cap)
    for fn in (sw.compact_indices_torch, sw.compact_indices):  # the wrapper takes it on CPU
        idx, cnt = fn(torch.as_tensor(flags), cap)
        assert idx.dtype == torch.int32 and idx.shape == (cap,)
        assert cnt.dtype == torch.int32 and cnt.shape == ()
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        assert int(cnt) == int(want_cnt) == int(flags.sum())


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pair_worklist_torch_matches_xla(case):
    r, cap, p = PAIR_CASES[case]
    bits = _bits(np.random.default_rng(r), r, p)
    want = pair_worklist_xla(jnp.asarray(bits), cap)
    for fn in (sw.pair_worklist_torch, sw.pair_worklist):
        got = fn(torch.as_tensor(bits.view(np.int32)), cap)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) == sum(int(b).bit_count() for b in bits)


def test_worklist_dispatch_has_no_fallback():
    flags = torch.ones(64, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sw.compact_indices(flags, 64)
    with pytest.raises(ValueError, match="no kernel"):
        sw.pair_worklist(torch.ones(8, dtype=torch.int32, device="meta"), 64)
