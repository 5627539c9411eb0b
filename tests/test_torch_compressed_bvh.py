"""Port parity, the wide BVH and its bf16-compressed nodes (the cases of
tests/test_compressed_bvh.py): `bvh/wide.py` against the JAX package on
the same numpy-seeded scenes. The rounding is bit operations on the f32
pattern (no bfloat16 cast rounds outwards), held bit for bit; the tables
(plain and compressed rows) are compared as bit patterns, since their ref
columns hold integers whose f32 view may be NaN.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.bvh.wide import _bf16_down as j_down, _bf16_up as j_up
from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.core.scene import HostScene as JHost, Mesh as JMesh
from optixpathtracer_tpu.ops.traverse_bfs import closest_hit_bfs as jax_bfs
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.bvh.wide import _bf16_down, _bf16_up
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.core.scene import HostScene, Mesh
from optixpathtracer_tpu_torch.ops.traverse_bfs import closest_hit_bfs

CPU = torch.device("cpu")


def _bits(t) -> np.ndarray:
    return np.asarray(t).view(np.uint32)


def test_bf16_rounding_conservative_and_equal_to_reference(rng):
    x = (rng.normal(size=20000) * np.exp(rng.normal(size=20000) * 5)).astype(np.float32)
    x = np.concatenate([x, [0.0, -0.0, 1e-40, -1e-40, 3e38, -3e38, np.inf, -np.inf]]).astype(np.float32)
    dn, up = _bf16_down(x), _bf16_up(x)
    assert np.all(dn <= x) and np.all(up >= x)
    big = (np.abs(x) > 1e-30) & np.isfinite(x)
    assert np.all(np.abs(dn[big] - x[big]) <= np.abs(x[big]) * 2**-6)
    assert np.all(np.abs(up[big] - x[big]) <= np.abs(x[big]) * 2**-6)
    assert np.all(_bits(dn) & 0xFFFF == 0) and np.all(_bits(up) & 0xFFFF == 0)
    np.testing.assert_array_equal(_bits(dn), _bits(j_down(x)))
    np.testing.assert_array_equal(_bits(up), _bits(j_up(x)))


def _soup(rng, n_tris=250):
    c = (rng.random((n_tris, 3)) * 4 - 2).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.2
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.2
    verts = np.concatenate([c, c + e1, c + e2]).astype(np.float32)
    idx = np.stack([np.arange(n_tris), np.arange(n_tris) + n_tris,
                    np.arange(n_tris) + 2 * n_tris], axis=1).astype(np.int32)
    hs, jhs = HostScene(), JHost()
    hs.add_mesh(Mesh(vertices=verts, indices=idx, material=make_material()))
    jhs.add_mesh(JMesh(vertices=verts, indices=idx, material=jmake()))
    return hs, jhs


@pytest.mark.parametrize("width", [4, 8])
def test_compressed_traversal_matches_uncompressed_and_reference(rng, width):
    hs, jhs = _soup(rng)
    o = (rng.random((256, 3)) * 6 - 3).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ov, dv = (Vec3(*(torch.as_tensor(a[:, k]) for k in range(3))) for a in (o, d))
    jo, jd = (JVec3(*(jnp.asarray(a[:, k]) for k in range(3))) for a in (o, d))
    recs = {}
    for comp in (False, True):
        cs = compile_scene(hs, CPU, wide_width=width, compressed_nodes=comp)
        jcs = jax_compile(jhs, wide_width=width, compressed_nodes=comp)
        assert cs.wide.compressed == comp and cs.wide.depth == jcs.wide.depth
        np.testing.assert_array_equal(_bits(cs.wide.table.numpy()), _bits(jcs.wide.table))
        np.testing.assert_array_equal(cs.wide.leaf_rows.numpy(), np.asarray(jcs.wide.leaf_rows))
        np.testing.assert_array_equal(cs.wide.leaf_tri0.numpy(), np.asarray(jcs.wide.leaf_tri0))
        r = closest_hit_bfs(cs.wide, ov, dv, cap_factor=8)
        jr = jax_bfs(jcs.wide, jo, jd, cap_factor=8)
        assert float(r.overflow) == float(jr.overflow) == 0.0
        for f in ("t", "tri", "u", "v"):  # the eager BFS: the same float ops
            np.testing.assert_array_equal(getattr(r.record, f).numpy(), np.asarray(getattr(jr.record, f)))
        recs[comp] = r.record
    # dilated boxes only add candidates; the triangle tests are identical
    np.testing.assert_array_equal(recs[True].tri.numpy(), recs[False].tri.numpy())
    np.testing.assert_array_equal(recs[True].t.numpy(), recs[False].t.numpy())
