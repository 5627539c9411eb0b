"""Port parity, instanced traversal: `closest_hit_cluster` on both walks of
the TLAS of tests/test_torch_instancing.py (rotations, a non-uniform
scale, a mirror, two instances overlapping exactly) against the JAX
package's Pallas kernels in interpret mode. `any_hit_cluster` is in
tests/test_torch_instancing_any.py (each interpret-mode compile takes
12-22 s on one CPU thread; the files stay under a minute each).

Tolerances: winning triangles bit-exact; t within 1e-6 relative to
max(1, |t|) (a few ulps); u / v within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.ops import traverse_cluster as jtc
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
from tests.test_torch_instancing import aimed_rays, jrays, tlas_pair, trays

torch.set_num_threads(1)
N = 128  # one ray block: the interpret-mode compile dominates, not the rays


@pytest.fixture(scope="module")
def tlas():
    return tlas_pair()


def _rel_close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= tol


@pytest.mark.parametrize("walk", ["node", "flat"])
def test_closest_hit_equal_to_jax(tlas, walk):
    got_cs, want_cs, insts = tlas
    o, d = aimed_rays(np.stack([m for _, m in insts]), N, 1)
    t_max = np.where(np.arange(N) % 5 == 0, 9.0, 1e16).astype(np.float32)
    t_max[7] = 0.0  # a dead ray
    hier = walk == "node"
    got = tc.closest_hit_cluster(got_cs.clusters, *trays(o, d), 1e-3, torch.as_tensor(t_max), hier=hier)
    jfn = jtc.closest_hit_cluster_hier if hier else jtc.closest_hit_cluster
    want = jfn(want_cs.clusters, *jrays(o, d), 1e-3, jnp.asarray(t_max), interpret=True)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    hit = got.hit.numpy()
    assert 0.3 < hit.mean() < 0.95
    # the exact overlap: instances 4 and 5 tie; the first visited wins in both
    _rel_close(got.t.numpy()[hit], np.asarray(want.t)[hit])
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-5)
