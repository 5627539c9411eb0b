"""Port parity, instanced occlusion: `any_hit_cluster` on both walks of the
TLAS of tests/test_torch_instancing.py (rotations, a non-uniform scale, a
mirror, an exact overlap) against the JAX package's Pallas kernels in
interpret mode; occlusion bit-exact, at a shadow ray's t_min and a finite
t_max. (The closest hit is in tests/test_torch_instancing_walks.py.)
"""
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.ops import traverse_cluster as jtc
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
from tests.test_torch_instancing import aimed_rays, jrays, tlas_pair, trays

torch.set_num_threads(1)
N = 128


@pytest.fixture(scope="module")
def tlas():
    return tlas_pair()


@pytest.mark.parametrize("walk", ["node", "flat"])
def test_any_hit_equal_to_jax(tlas, walk):
    got_cs, want_cs, insts = tlas
    o, d = aimed_rays(np.stack([m for _, m in insts]), N, 2)
    hier = walk == "node"
    got, _ = tc.any_hit_cluster(got_cs.clusters, *trays(o, d), 1e-2, 60.0, hier=hier)
    jfn = jtc.any_hit_cluster_hier if hier else jtc.any_hit_cluster
    want, _ = jfn(want_cs.clusters, *jrays(o, d), 1e-2, 60.0, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.2 < float(got.float().mean()) < 0.95
