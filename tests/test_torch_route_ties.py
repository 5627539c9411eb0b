"""The port's route rule against the reference's, where they part: exact-t
ties (ROADMAP C.7, a pinned departure).

`closest_hit_cluster(hier=None)` takes the node walk from
`HIER_MIN_ENTRIES` entries: 8 in the port (measured on the H100), 3072 in
the reference. On a scene of 8 to 3071 entries the port walks nodes where
the reference walks flat. Both walks are exact, so t is the same on every
ray; but where two triangles of different entries are hit at exactly the
same t, the first one visited wins, and the two walks visit in different
orders (the flat walk sorts entries by one key per 128-ray block, the node
walk nodes first), so the winning triangle may differ there and only there.

The scene: a floor of unit tiles at y = 0 and boxes standing on it, their
bottom faces coplanar with the floor tiles beneath them (different
triangles, different materials), at cluster_size 8: 11 entries. The rays
come from below (origin y = -1, direction (a, 1, b), a and b dyadic), so the
Moller-Trumbore arithmetic is exact and every hit of the plane is at t = 1
exactly: a floor tile and the box bottom above it tie, as do two floor
tiles along their shared edge. Each 128-ray block shares an origin patch
and a direction, as a camera's blocks do, so the blocks' keys differ.

Tolerances: none. t and the hit flags bit-equal on every ray; the port's
flat walk (hier=False) equal to the reference's triangle on every ray.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.materials import make_material
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.core.scene import HostScene, Mesh
from optixpathtracer_tpu.ops import traverse_cluster as jtc
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc

torch.set_num_threads(1)
CPU = torch.device("cpu")
K = 8  # the floor spans [-K, K]^2
N = 1024  # 8 ray blocks


def _scene(n_boxes=16, seed=3) -> HostScene:
    hs = HostScene()
    v, f = [], []
    for i in range(-K, K):
        for j in range(-K, K):
            b = len(v)
            v += [[i, 0, j], [i + 1, 0, j], [i + 1, 0, j + 1], [i, 0, j + 1]]
            f += [[b, b + 2, b + 1], [b, b + 3, b + 2]]
    hs.add_mesh(Mesh(vertices=np.array(v, np.float32), indices=np.array(f, np.int32),
                     material=make_material(color=(0.7, 0.7, 0.7))))
    rng = np.random.default_rng(seed)
    for _ in range(n_boxes):
        x, z = rng.integers(-K + 1, K - 1, 2)
        hs.add_box(make_material(color=tuple(rng.uniform(0.2, 0.9, 3))), pos=(float(x), 1.0, float(z)),
                   extent=(1, 1, 1))
    return hs


def _rays(seed):
    """N rays from below in blocks of 128 that share an origin patch and a
    direction: dyadic origins (1/64) and directions (1/32), dy = 1."""
    rng = np.random.default_rng(seed)
    nb = N // 128
    cx, cz = (rng.integers(-K * 4, K * 4, nb) / 4 for _ in range(2))
    a, b = (rng.integers(-16, 17, nb) / 16 for _ in range(2))
    ox = np.repeat(cx, 128) + rng.integers(-32, 33, N) / 64
    oz = np.repeat(cz, 128) + rng.integers(-32, 33, N) / 64
    dx = np.repeat(a, 128) + rng.integers(-2, 3, N) / 32
    dz = np.repeat(b, 128) + rng.integers(-2, 3, N) / 32
    o = np.stack([ox, -np.ones(N), oz], 1).astype(np.float32)
    d = np.stack([dx, np.ones(N), dz], 1).astype(np.float32)
    return o, d


@pytest.fixture(scope="module")
def walks():
    jcs = jax_compile(_scene(), build_wide_bvh=False, cluster_size=8)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    o, d = _rays(5)
    jo, jd = (JVec3(*(jnp.asarray(a[:, i]) for i in range(3))) for a in (o, d))
    to, td = (Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3))) for a in (o, d))
    want = jtc.closest_hit_cluster(jcs.clusters, jo, jd, 1e-3, 1e16)  # hier=None: flat below 3072
    port = tc.closest_hit_cluster(pcs.clusters, to, td, 1e-3, 1e16)  # hier=None: nodes from 8
    port_flat = tc.closest_hit_cluster(pcs.clusters, to, td, 1e-3, 1e16, hier=False)
    return pcs, (o, d), want, port, port_flat


def _plane_t(pcs, o, d, tri):
    """(hit, t) of ray i against scene triangle tri[i], by the sweeps'
    Moller-Trumbore expressions (`_mt_block`, `_mt_t`)."""
    r = pcs.scene.shade_rows[torch.as_tensor(tri, dtype=torch.int64)]
    v0 = r[:, 0:3]
    tri9 = torch.cat([v0, r[:, 3:6] - v0, r[:, 6:9] - v0], 1)[:, :, None]  # (P, 9, 1)
    col = [torch.as_tensor(np.ascontiguousarray(a))[:, None, None] for a in (*o.T, *d.T)]
    ok, t = tc._mt_t(*tc._mt_block(tuple(col[:3]), tuple(col[3:]), tri9))
    return ok[:, 0, 0].numpy(), t[:, 0, 0].numpy()


def test_scene_takes_different_walks_in_the_two_packages(walks):
    pcs = walks[0]
    assert tc.HIER_MIN_ENTRIES <= pcs.clusters.num_entries < jtc.HIER_MIN_ENTRIES
    assert pcs.clusters.num_entries == 11


def test_node_walk_parts_from_the_reference_only_on_exact_t_ties(walks):
    pcs, (o, d), want, port, _ = walks
    np.testing.assert_array_equal(port.t.numpy(), np.asarray(want.t))  # t bit-equal on every ray
    np.testing.assert_array_equal(port.hit.numpy(), np.asarray(want.tri) >= 0)
    differ = np.nonzero(port.tri.numpy() != np.asarray(want.tri))[0]
    assert differ.size >= 1, "the scene no longer exercises the departure"
    assert differ.size < N // 10
    # where the triangles differ, both hit the ray at exactly the winning t
    for tri in (port.tri.numpy()[differ], np.asarray(want.tri)[differ]):
        ok, t = _plane_t(pcs, o[differ], d[differ], tri)
        assert ok.all()
        np.testing.assert_array_equal(t, port.t.numpy()[differ])
    # a floor tile against the box bottom above it (different materials),
    # or two floor tiles along their shared edge
    mats = pcs.scene.shade_rows[:, 24]
    assert (mats[port.tri[differ].long()] != mats[torch.as_tensor(want.tri)[differ].long()]).any()


def test_flat_walk_equal_to_the_reference_on_every_ray(walks):
    _, _, want, _, port_flat = walks
    np.testing.assert_array_equal(port_flat.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(port_flat.t.numpy(), np.asarray(want.t))


def test_threshold_is_pinned():
    assert tc.HIER_MIN_ENTRIES == 8 and jtc.HIER_MIN_ENTRIES == 3072
