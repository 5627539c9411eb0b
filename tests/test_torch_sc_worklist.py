"""Port parity, ops/sc_worklist (kernels K5a and K5b): the plain PyTorch
versions against the reference's XLA contracts `compact_indices_xla` and
`pair_worklist_xla`, bit for bit, on the same numpy inputs.

The cases cover capacity above the input size (and far above it), capacity
below the count (truncation, with the count still the full popcount),
capacity 0, one element, all-zero and all-set inputs. The kernels' launch
plan (`launch_plan`: grid, vectors per thread, buffer layout) is checked
here too, as plain arithmetic. On CPU tensors the wrappers take the plain versions; on
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
    "capacity_zero": (300, 0, 0.4),
    "capacity_far_above_n": (50, 5000, 0.5),
    "one_flag": (1, 4, 1.0),
}

# name -> (rows, capacity, probability of a set bit)
PAIR_CASES = {
    "dense_capacity_exact": (37, 37 * 32, 0.5),
    "sparse_capacity_above": (300, 300 * 32 + 50, 0.05),
    "capacity_below_count": (200, 700, 0.3),
    "all_zero": (64, 128, 0.0),
    "all_set": (33, 33 * 32, 1.0),
    "all_set_truncated": (33, 100, 1.0),
    "capacity_zero": (40, 0, 0.3),
    "capacity_far_above_n": (5, 5 * 32 * 20, 0.5),
    "one_row": (1, 40, 0.5),
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


# (items per 16-byte vector, outputs, counts per block): K5a, K5b
PLAN_KINDS = {"compact": (sw.FLAGS_PER_VEC, 1, 1), "pair_worklist": (sw.WORDS_PER_VEC, 2, sw.WORD_BITS)}


@pytest.mark.parametrize("kind", sorted(PLAN_KINDS))
@pytest.mark.parametrize("max_blocks", [1, 7, 132, 264])
def test_launch_plan_covers_every_element(kind, max_blocks):
    per_vec, outputs, per_block = PLAN_KINDS[kind]
    span = sw.THREADS * per_vec  # items of one vector step of a block
    wave = max_blocks * span
    sizes = sorted({0, 1, per_vec - 1, per_vec + 1, span - 1, span, span + 1, wave - 1, wave, wave + 1,
                    2 * wave - 1, 2 * wave + 1, 3 * wave - 1, 3 * wave}
                   | set(np.random.default_rng(max_blocks).integers(0, 3 * wave, 20).tolist()))
    for n in sizes:
        cap = 3 + n // 7
        plan = sw.launch_plan(n, cap, per_vec, outputs, per_block, max_blocks)
        assert 1 <= plan.grid <= max_blocks and plan.steps * span >= n > (plan.steps - 1) * span or n == 0
        assert plan.grid == min(max_blocks, plan.steps)  # one block per step up to one wave
        # the blocks' steps tile [0, steps) in block order, none empty, at most vec each
        # the kernels' `block_steps`: block b takes [b steps / grid, (b + 1) steps / grid)
        taken = [range(b * plan.steps // plan.grid, (b + 1) * plan.steps // plan.grid) for b in range(plan.grid)]
        assert [s for r in taken for s in r] == list(range(plan.steps))
        assert all(1 <= len(r) <= plan.vec for r in taken)
        assert plan.vec == -(-plan.steps // plan.grid) and plan.items_per_thread == plan.vec * per_vec
        # every element lies in a step some block takes, in order
        assert (n == 0 and plan.steps == 1) or (n - 1) // span == plan.steps - 1
        # one buffer: outputs, then the count, then the counts table
        assert plan.count_at == outputs * cap and plan.counts_at == plan.count_at + 1
        assert plan.buffer_ints == plan.counts_at + per_block * plan.grid


def test_launch_plan_refuses_a_card_without_room():
    with pytest.raises(ValueError, match="no block"):
        sw.launch_plan(100, 10, sw.FLAGS_PER_VEC, 1, 1, 0)
