"""Port parity, scene build: `compile_scene` (cluster path) of the port vs
the JAX package on the same host scenes, bit for bit.

Both builds are the same numpy arithmetic: the Morton order, the treelet
repacking, the cluster tables and the shade rows. The reference may take its
native C++ treelet builder, whose intra-partition order is unspecified, so
its numpy path is forced here (OPTIX_TPU_NO_NATIVE=1).
"""
import numpy as np
import pytest
import torch

from bench import build_city_scene as jax_city
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu_torch import scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.bvh.lbvh import build_bvh
from optixpathtracer_tpu_torch.bvh.morton import np_morton_codes
from tests.golden_scenes import _open_scene as jax_open_scene

torch.set_num_threads(1)
CPU = torch.device("cpu")
CLUSTER_FIELDS = ("rows", "spheres", "super_spheres", "scene_aabb", "entry_row",
                  "entry_xf", "xf_inv", "xf_fwd", "xf_invt", "tri_map")
SCENES = {
    "open": (scenes.open_scene, jax_open_scene),
    "city2k": (lambda: scenes.build_city_scene(n_boxes=2000),
               lambda: jax_city(n_boxes=2000)),
}


@pytest.fixture
def numpy_reference(monkeypatch):
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_host_scenes_identical(scene):
    mine, ref = SCENES[scene]
    a, b = mine().flatten(), ref().flatten()
    for key in ("v", "n", "uv"):
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["material_id"], b["material_id"])
    np.testing.assert_array_equal(a["has_shading_normal"], b["has_shading_normal"])
    assert a["materials"] == b["materials"]


@pytest.mark.parametrize("cluster_size", [128, 256])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_compile_scene_bit_exact(scene, cluster_size, numpy_reference):
    mine, ref = SCENES[scene]
    got = compile_scene(mine(), CPU, cluster_size=cluster_size)
    want = jax_compile(ref(), cluster_size=cluster_size, build_wide_bvh=False)
    assert got.num_triangles == want.num_triangles
    assert got.bvh is None and got.wide is None
    gc, wc = got.clusters, want.clusters
    assert gc.cluster_size == wc.cluster_size and gc.instanced is False
    for f in CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(gc, f).numpy(), np.asarray(getattr(wc, f)), err_msg=f)
    np.testing.assert_array_equal(got.scene.shade_rows.numpy(), np.asarray(want.scene.shade_rows))
    np.testing.assert_array_equal(got.scene.materials.rows.numpy(),
                                  np.asarray(want.scene.materials.rows))
    # the per-field views agree with the reference's per-field arrays
    for f in ("v0", "v1", "v2", "n0", "n1", "n2"):
        for a, b in zip(getattr(got.scene, f), getattr(want.scene, f)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.scene.material_id.numpy(), np.asarray(want.scene.material_id))
    np.testing.assert_array_equal(got.scene.has_shading_normal.numpy(),
                                  np.asarray(want.scene.has_shading_normal))


def test_lbvh_order_matches_reference_numpy_path(numpy_reference):
    from optixpathtracer_tpu.bvh.lbvh import build_bvh as jax_build_bvh
    from optixpathtracer_tpu.bvh.morton import np_morton_codes as jax_morton

    v0, v1, v2 = scenes.build_city_scene(n_boxes=500).flatten()["v"]
    c = (v0.astype(np.float64) + v1 + v2) / 3.0
    np.testing.assert_array_equal(np_morton_codes(c), jax_morton(c))
    got = build_bvh(v0, v1, v2, leaf_size=8)
    want = jax_build_bvh(v0, v1, v2, leaf_size=8)
    np.testing.assert_array_equal(got.order, want.order)
    assert got.padded_count == want.padded_count


def test_textured_build_raises():
    """The name dates from when a textured build raised. It now holds the
    texture pool a textured build carries against the JAX package's."""
    from optixpathtracer_tpu.core.scene import pack_textures as jax_pack_textures

    hs = scenes.open_scene()
    rng = np.random.default_rng(0)
    images = [rng.random((2, 3, 3)).astype(np.float32), rng.random((5, 4, 3)).astype(np.float32)]
    for img in images:
        hs.add_texture(img)
    hs.meshes[1].material = dict(hs.meshes[1].material, texture_id=1)
    cs = compile_scene(hs, CPU)
    assert cs.scene.textured
    for got, want in zip(cs.scene.textures, jax_pack_textures(images)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
