"""Port parity, instancing and the TLAS: `bvh/clusters`' instanced builders
and transform updates, `builder.compile_instanced` / `compile_tlas`,
`interop` of instanced scenes, both cluster walks and `_hit_geometry` on
instanced sets, against the JAX package on the scenes of
tests/test_instancing.py and tests/test_tlas.py; and the port's own
instanced-against-baked renders and update-without-rebuild checks. (The
render against the JAX renderer is tests/test_torch_instancing_render.py,
both walks against the JAX kernels tests/test_torch_instancing_walks.py and
tests/test_torch_instancing_any.py.)

Tolerances: every host table bit-exact (the same float64 numpy arithmetic,
cast to float32); winning triangles and occlusion bit-exact, t within 1e-6
relative to max(1, |t|) (a few ulps); world normals within 1e-6; renders
against the baked scene at the reference's RMSE 2e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu import builder as jbuilder
from optixpathtracer_tpu.bvh import clusters as jcl
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.ops import traverse_cluster as jtc
from optixpathtracer_tpu_torch import builder, interop
from optixpathtracer_tpu_torch.bvh import clusters as tcl
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.core.scene import HostScene, Mesh
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.lights.probe import build_probe
from optixpathtracer_tpu_torch.ops import traverse_cluster as tc
from tests import test_instancing as ti
from tests import test_tlas as tt

torch.set_num_threads(1)
CPU = torch.device("cpu")
CLUSTER_FIELDS = ("rows", "spheres", "super_spheres", "scene_aabb", "entry_row", "entry_xf",
                  "xf_inv", "xf_fwd", "xf_invt")
ENTRY_FIELDS = ("spheres", "super_spheres", "scene_aabb", "entry_row", "entry_xf", "xf_inv",
                "xf_fwd", "xf_invt")


@pytest.fixture(autouse=True)
def numpy_reference(monkeypatch):
    """Both packages on the numpy builders (the native ones are held
    against each other in tests/test_torch_accel_native.py)."""
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_set(got, want):
    assert got.instanced and want.instanced and got.cluster_size == want.cluster_size
    assert got.tri_map is None and want.tri_map is None
    for f in CLUSTER_FIELDS:
        _eq(getattr(got, f), getattr(want, f), f)


def _xf_mirror():
    """Rotations, a non-uniform scale, a mirror (negative determinant) and
    two instances overlapping exactly."""
    xfs = ti._transforms(6, seed=3)
    xfs[1, :3, :3] = xfs[1, :3, :3] @ np.diag([1.7, 0.6, 1.1])
    xfs[2, :3, :3] = xfs[2, :3, :3] @ np.diag([-1.0, 1.0, 1.0])
    xfs[4] = xfs[3]
    return xfs


# -- tables ------------------------------------------------------------------

def _proto_tables(cluster_size=64):
    flat = ti._proto().flatten()
    v0, v1, v2 = flat["v"]
    return jcl._cluster_tables_np(v0, v1, v2, len(v0), cluster_size), tcl._cluster_tables_np(
        v0, v1, v2, len(v0), cluster_size)


def test_cluster_tables_carry_the_local_aabb():
    want, got = _proto_tables()
    assert set(got) == set(want)
    for k in want:
        _eq(got[k], want[k], k)


@pytest.mark.parametrize("xfs", [ti._transforms(100), _xf_mirror()], ids=["scatter", "mirror"])
def test_entry_tables_equal(xfs):
    tb = _proto_tables()[0]
    got, want = tcl._entry_tables(tb, xfs), jcl._entry_tables(tb, xfs)
    assert set(got) == set(want)
    for k in ENTRY_FIELDS:
        _eq(got[k], want[k], k)


def test_instance_world_tables_equal():
    hs, groups = tt._host_with_protos()
    insts = tt._instances(40)
    jcs, tables = jbuilder.compile_tlas(hs, groups, insts, cluster_size=64, return_tables=True)
    inst_proto = np.asarray([p for p, _ in insts])
    xfs = np.stack([m for _, m in insts])
    got = tcl._instance_world_tables(interop.proto_tables(tables), inst_proto, xfs)
    want = jcl._instance_world_tables(tables, inst_proto, xfs)
    for k in ENTRY_FIELDS:
        _eq(got[k], want[k], k)


def test_build_instanced_and_tlas_clusters_equal():
    flat = ti._proto().flatten()
    v0, v1, v2 = flat["v"]
    xfs = _xf_mirror()
    _same_set(tcl.build_instanced_clusters(v0, v1, v2, len(v0), xfs, CPU, cluster_size=64),
              jcl.build_instanced_clusters(v0, v1, v2, len(v0), xfs, cluster_size=64))
    hs, groups = tt._host_with_protos()
    insts = tt._instances(12, seed=3)
    _, tables = jbuilder.compile_tlas(hs, groups, insts, cluster_size=64, return_tables=True)
    inst_proto = np.asarray([p for p, _ in insts])
    xfs = np.stack([m for _, m in insts])
    _same_set(tcl.build_tlas_clusters(interop.proto_tables(tables), inst_proto, xfs, CPU, cluster_size=64),
              jcl.build_tlas_clusters(tables, inst_proto, xfs, cluster_size=64))


def _tlas_pair(n=40, seed=0, cluster_size=64):
    hs, groups = tt._host_with_protos()
    insts = tt._instances(n, seed=seed)
    return (builder.compile_tlas(hs, groups, insts, CPU, cluster_size=cluster_size, return_tables=True),
            jbuilder.compile_tlas(hs, groups, insts, cluster_size=cluster_size, return_tables=True),
            (hs, groups, insts))


def _instanced_pair(xfs, cluster_size=64):
    hs = ti._proto()
    return (builder.compile_instanced(hs, xfs, CPU, cluster_size=cluster_size),
            jbuilder.compile_instanced(hs, xfs, cluster_size=cluster_size))


def _same_compiled(got, want):
    assert got.num_triangles == want.num_triangles and got.bvh is None and got.wide is None
    _same_set(got.clusters, want.clusters)
    _eq(got.scene.shade_rows, want.scene.shade_rows, "shade_rows")
    _eq(got.scene.materials.rows, want.scene.materials.rows, "materials")
    # and carried across: the JAX compile's arrays rebuild the port's scene
    back = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(want), CPU)
    _same_set(back.clusters, got.clusters)
    _eq(back.scene.shade_rows, got.scene.shade_rows, "shade_rows (interop)")
    arrays = interop.compiled_scene_arrays(got)
    assert "clusters.tri_map" not in arrays and bool(arrays["clusters.instanced"])


def test_compile_instanced_equal_and_interop():
    _same_compiled(*_instanced_pair(_xf_mirror()))


@pytest.mark.parametrize("cluster_size", [16, 64])
def test_compile_tlas_equal_and_interop(cluster_size):
    (got, got_tb), (want, want_tb), _ = _tlas_pair(cluster_size=cluster_size)
    _same_compiled(got, want)
    assert len(got_tb) == len(want_tb)
    for a, b in zip(got_tb, want_tb):
        for k in ("rows", "spheres", "super_spheres", "scene_aabb", "local_aabb"):
            _eq(a[k], b[k], k)


def test_update_tlas_transforms_equal_and_keeps_rows():
    (got, got_tb), (want, want_tb), (_, _, insts) = _tlas_pair(n=10, seed=5)
    insts2 = tt._instances(10, seed=11)
    inst_proto = np.asarray([p for p, _ in insts2])
    xfs2 = np.stack([m for _, m in insts2])
    moved = tcl.update_tlas_transforms(got.clusters, got_tb, inst_proto, xfs2)
    assert moved.rows.data_ptr() == got.clusters.rows.data_ptr()
    assert moved.entry_row is got.clusters.entry_row and moved.entry_xf is got.clusters.entry_xf
    _same_set(moved, jcl.update_tlas_transforms(want.clusters, want_tb, inst_proto, xfs2))


def test_update_instance_transforms_equal_and_keeps_rows():
    got, want = _instanced_pair(ti._transforms(10))
    # the slot-order tables of compile_instanced: the scene's own treelet order
    flat = ti._proto().flatten()
    v0, v1, v2 = flat["v"]
    order = tcl.treelet_order((np.asarray(v0, np.float64) + v1 + v2) / 3.0, 64)
    pad_to = got.clusters.rows.shape[0] * tcl.SUPER * 64
    order = np.concatenate([order, np.repeat(order[-1:], pad_to - len(order))])
    tb = tcl._cluster_tables_np(v0[order], v1[order], v2[order], pad_to, 64)
    xfs2 = ti._transforms(10, seed=9)  # an update keeps the instance count
    xfs2[2, :3, :3] = xfs2[2, :3, :3] @ np.diag([-1.0, 1.3, 1.0])  # a mirror with a scale
    moved = tcl.update_instance_transforms(got.clusters, tb, xfs2)
    assert moved.rows.data_ptr() == got.clusters.rows.data_ptr()
    _same_set(moved, jcl.update_instance_transforms(want.clusters, tb, xfs2))
    fresh = builder.compile_instanced(ti._proto(), xfs2, CPU, cluster_size=64)
    to, td = trays(*aimed_rays(xfs2, 1024, 4))
    r1 = tc.closest_hit_cluster(moved, to, td, 1e-3, 1e16)
    r2 = tc.closest_hit_cluster(fresh.clusters, to, td, 1e-3, 1e16)
    _eq(r1.tri, r2.tri.numpy(), "tri")
    _eq(r1.t, r2.t.numpy(), "t")
    assert int(r1.hit.sum()) > 300


# -- rays aimed at the instances ---------------------------------------------

def aimed_rays(xfs, n, seed):
    """n rays from random points over the scene, each aimed at a random
    instance's origin (plus a jitter): most hit. Numpy (o, d)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.1, 6.0, n)
    tgt = np.asarray(xfs)[rng.integers(0, len(xfs), n), :3, 3] + rng.normal(0, 0.4, (n, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def trays(o, d):
    return (Vec3(*(torch.as_tensor(np.ascontiguousarray(o[:, i])) for i in range(3))),
            Vec3(*(torch.as_tensor(np.ascontiguousarray(d[:, i])) for i in range(3))))


def jrays(o, d):
    return (JVec3(*(jnp.asarray(o[:, i]) for i in range(3))), JVec3(*(jnp.asarray(d[:, i]) for i in range(3))))


def tlas_instances():
    """tests/test_tlas.py's two prototypes under 12 of its transforms, one
    given a non-uniform scale, one a mirror (negative determinant) and one
    a copy of another (an exact overlap: ties of t across instances)."""
    insts = tt._instances(12, seed=3)
    m = [np.array(x, np.float64) for _, x in insts]
    m[1][:3, :3] = m[1][:3, :3] @ np.diag([1.7, 0.6, 1.1])
    m[2][:3, :3] = m[2][:3, :3] @ np.diag([-1.0, 1.0, 1.0])
    m[5] = m[4].copy()
    return [(p, x) for (p, _), x in zip(insts, m)]


def tlas_pair(cluster_size=16):
    """(port, JAX) compiles of `tlas_instances`, both on the numpy path."""
    import os

    hs, groups = tt._host_with_protos()
    insts = tlas_instances()
    old = os.environ.get("OPTIX_TPU_NO_NATIVE")
    os.environ["OPTIX_TPU_NO_NATIVE"] = "1"
    try:
        want = jbuilder.compile_tlas(hs, groups, insts, cluster_size=cluster_size)
        got = builder.compile_tlas(hs, groups, insts, CPU, cluster_size=cluster_size)
    finally:
        if old is None:
            del os.environ["OPTIX_TPU_NO_NATIVE"]
    return got, want, insts


@pytest.fixture(scope="module")
def tlas():
    return tlas_pair()


def test_hit_geometry_world_normals_equal_to_jax(tlas):
    got_cs, want_cs, insts = tlas
    o, d = aimed_rays(np.stack([m for _, m in insts]), 512, 3)
    to, td = trays(o, d)
    _, jd = jrays(o, d)
    rec = tc.closest_hit_cluster(got_cs.clusters, to, td, 1e-3, 1e16)
    jrec = jtc.HitRecord(*(jnp.asarray(x.numpy()) for x in rec))
    hit = rec.hit.numpy()
    assert hit.mean() > 0.3
    for use_shading in (False, True):
        n, _, albedo, _ = twf._hit_geometry(got_cs, rec, td, use_shading)
        jn, _, jalbedo, _ = jwf._hit_geometry(want_cs, jrec, jd, use_shading)
        for a, b in zip(n, jn):
            np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], atol=1e-6)
        for a, b in zip(albedo, jalbedo):
            _eq(a.numpy()[hit], np.asarray(b)[hit], "albedo")


def test_instanced_normals_use_the_inverse_transpose():
    """Under a shear the shading normal moves by xf_invt, not xf_fwd: the
    boxes' per-face shading normals stay the sheared faces' geometric
    normals in world space."""
    xfs = np.eye(4)[None].copy()
    xfs[0, :3, :3] = np.array([[2.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    cs = builder.compile_instanced(ti._proto(), xfs, CPU, cluster_size=16)
    to, td = trays(*aimed_rays(xfs, 1024, 8))
    rec = tc.closest_hit_cluster(cs.clusters, to, td, 1e-3, 1e16)
    n_sh = twf._hit_geometry(cs, rec, td, True)[0]
    n_geo = twf._hit_geometry(cs, rec, td, False)[0]
    hit = rec.hit
    assert int(hit.sum()) > 200
    for a, b in zip(n_sh, n_geo):
        np.testing.assert_allclose(a[hit].numpy(), b[hit].numpy(), atol=1e-5)


# -- renders -----------------------------------------------------------------

def _compile_baked(baked):
    """The reference tests' baked HostScene, rebuilt with the port's classes
    and compiled by the port."""
    hb = HostScene()
    for m in baked.meshes:
        hb.add_mesh(Mesh(vertices=m.vertices, indices=m.indices, normals=m.normals,
                         texcoords=m.texcoords, material=dict(m.material)))
    return builder.compile_scene(hb, CPU, cluster_size=64)


@pytest.mark.parametrize("scene", ["tlas", "instanced"])
def test_render_matches_baked(scene):
    """tests/test_tlas.py / test_instancing.py's render gate in the port."""
    if scene == "tlas":
        hs, groups = tt._host_with_protos()
        insts = tt._instances(12, seed=3)
        got = builder.compile_tlas(hs, groups, insts, CPU, cluster_size=64)
        baked = tt._baked(hs, groups, insts)
    else:
        xfs = ti._transforms(25)
        got = builder.compile_instanced(ti._proto(), xfs, CPU, cluster_size=64)
        baked = ti._baked(ti._proto(), xfs)
    cb = _compile_baked(baked)
    assert got.num_triangles == cb.num_triangles
    probe = build_probe(np.full((16, 32, 3), 0.6, np.float32), CPU)
    cfg = twf.RenderConfig(width=64, height=48, samples_per_launch=2, max_depth=2, traversal="cluster")
    cam = Camera(eye=(18, 12, 18), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=50, aspect_ratio=64 / 48)
    imgs = []
    for cs in (got, cb):
        r = Renderer(cs, probe, cfg, cam)
        r.render()
        imgs.append(r.accum_image())
    rmse = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2)))
    assert rmse < 2e-3, rmse


def test_traversal_matches_baked():
    """tests/test_tlas.py:82-101 in the port, on both walks."""
    hs, groups = tt._host_with_protos()
    insts = tt._instances(100)
    got = builder.compile_tlas(hs, groups, insts, CPU, cluster_size=64)
    cb = _compile_baked(tt._baked(hs, groups, insts))
    assert got.clusters.rows.shape[0] < cb.clusters.rows.shape[0]  # stored once per prototype
    rng = np.random.default_rng(1)  # tests/test_tlas.py's rays
    o = rng.uniform(-25, 25, (2048, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.1, 6.0, 2048)
    d = rng.normal(0, 1, (2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    to, td = trays(o, d)
    rb = tc.closest_hit_cluster(cb.clusters, to, td, 1e-3, 1e16)
    for hier in (True, False):
        rt = tc.closest_hit_cluster(got.clusters, to, td, 1e-3, 1e16, hier=hier)
        _eq(rt.hit, rb.hit.numpy(), "hit")
        hb_ = rb.hit.numpy()
        np.testing.assert_allclose(rt.t.numpy()[hb_], rb.t.numpy()[hb_], rtol=2e-4, atol=2e-4)
