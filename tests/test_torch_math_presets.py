"""Port parity, the core/math helpers the presets use (`reflect`, `length`,
`clamp`, `vmin`, `vmax`) and `SceneData.geometric_normal`, against the JAX
package on the same seeded numpy inputs.

Tolerances: reflect, clamp, vmin, vmax bit-exact (a mul, add, min or max
each, the same op order); length (XLA's sqrt and PyTorch's may round a ulp
apart) and the geometric normal (rsqrt) rtol 1e-6 / atol 1e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core import math as jm
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core import math as tm
from tests.golden_scenes import _open_scene

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _vecs(seed, n=2048):
    a = np.random.default_rng(seed).normal(0, 2, (n, 3)).astype(np.float32)
    return jm.Vec3(*(jnp.asarray(a[:, i]) for i in range(3))), tm.Vec3(*(torch.as_tensor(a[:, i].copy()) for i in range(3)))


def _eq(tv, jv):
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_reflect():
    (ja, ta), (jb, tb) = _vecs(1), _vecs(2)
    _eq(tm.reflect(ta, tb), jm.reflect(ja, jb))


def test_length():
    ja, ta = _vecs(3)
    np.testing.assert_allclose(tm.length(ta).numpy(), np.asarray(jm.length(ja)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("lo, hi", [(-1.0, 1.0), (0.0, 0.5)])
def test_clamp_vec3_and_tensor(lo, hi):
    ja, ta = _vecs(4)
    _eq(tm.clamp(ta, lo, hi), jm.clamp(ja, lo, hi))
    np.testing.assert_array_equal(tm.clamp(ta.x, lo, hi).numpy(), np.asarray(jm.clamp(ja.x, lo, hi)))


def test_vmin_vmax():
    (ja, ta), (jb, tb) = _vecs(5), _vecs(6)
    _eq(tm.vmin(ta, tb), jm.vmin(ja, jb))
    _eq(tm.vmax(ta, tb), jm.vmax(ja, jb))


def test_geometric_normal():
    jcs = jax_compile(_open_scene(), build_wide_bvh=False)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    tri = np.random.default_rng(7).integers(0, jcs.num_triangles, 512).astype(np.int32)
    want = jcs.scene.geometric_normal(jnp.asarray(tri))
    got = pcs.scene.geometric_normal(torch.as_tensor(tri, dtype=torch.int64))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert np.allclose(tm.length(got).numpy(), 1.0, atol=1e-6)
