"""Port parity, glTF node instancing: `io.gltf.load_gltf_tlas` against the
JAX package's loader — the prototype groups, the instances (prototype and
float64 world matrix, in node-walk order) and the flattened host scene,
array for array — on the node-reuse document of tests/test_gltf.py, the
`gltf` golden's .glb and `scenes.instanced_city_glb(2)`; the baked and the
instanced loads of one file holding the same world triangles; and a CPU
render of the instanced city (a small crop of the view) against the JAX
renderer at rtol / atol 1e-5 with equal `rays_traced`.
"""

import numpy as np
import pytest
import torch

from optixpathtracer_tpu import builder as jbuilder
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.io import gltf as jgltf
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu_torch import builder, scenes
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.io import gltf as tgltf
from optixpathtracer_tpu_torch.lights.probe import build_probe
from tests.test_gltf import _reuse_gltf

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _files(tmp_path):
    return {
        "reuse": _reuse_gltf(tmp_path, n_nodes=6),
        "golden": _write(tmp_path, "golden.glb", scenes.golden_glb()),
        "city2": _write(tmp_path, "city2.glb", scenes.instanced_city_glb(2)),
    }


def _same_host(got, want):
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(got.meshes, want.meshes):
        for f in ("vertices", "indices", "normals", "texcoords"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.material == b.material
    fg, fw = got.flatten(), want.flatten()
    for k in ("v", "n", "uv"):
        for x, y in zip(fg[k], fw[k]):
            np.testing.assert_array_equal(x, y, err_msg=k)
    np.testing.assert_array_equal(fg["material_id"], fw["material_id"])
    assert fg["materials"] == fw["materials"]


@pytest.mark.parametrize("name", ["reuse", "golden", "city2"])
def test_load_gltf_tlas_equal_to_jax(tmp_path, name):
    path = _files(tmp_path)[name]
    hs, groups, instances, lights = tgltf.load_gltf_tlas(path)
    jhs, jgroups, jinstances, jlights = jgltf.load_gltf_tlas(path)
    _same_host(hs, jhs)
    assert groups == jgroups and lights == jlights
    assert len(instances) == len(jinstances)
    for (p, m), (jp, jm) in zip(instances, jinstances):
        assert p == jp and m.dtype == np.float64 == jm.dtype
        np.testing.assert_array_equal(m, jm)


def test_instanced_city_glb_layout(tmp_path):
    """instanced_city_glb(2): 9 prototypes stored once, one instance per
    (tile, mesh), tiles turned by multiples of 90 degrees and the odd ones
    scaled by 0.8; the instanced and the baked loads hold the same world
    triangles."""
    path = _files(tmp_path)["city2"]
    hs, groups, instances, _ = tgltf.load_gltf_tlas(path)
    assert groups == [[k] for k in range(9)]
    assert [p for p, _ in instances] == list(range(9)) * 4
    scales = sorted({round(float(abs(np.linalg.det(m[:3, :3])) ** (1 / 3)), 6) for _, m in instances})
    assert scales == [0.8, 1.0]
    baked, _ = tgltf.load_gltf(path)
    assert len(baked.meshes) == 36
    world = sum(len(m.indices) for m in baked.meshes)
    cs = builder.compile_tlas(hs, groups, instances, CPU, cluster_size=128)
    assert cs.num_triangles == world == 4 * sum(len(m.indices) for m in hs.meshes)
    # the baked vertices are the instanced ones moved by their node matrices
    for k, (p, m) in enumerate(instances[:9]):
        local = hs.meshes[groups[p][0]].vertices
        np.testing.assert_allclose(baked.meshes[k].vertices, local @ m[:3, :3].T + m[:3, 3],
                                   rtol=1e-6, atol=1e-4)


def test_instanced_city_render_equal_to_jax(tmp_path, monkeypatch):
    """A 20x12 crop of the instanced city (a narrow view across two tiles),
    both packages rendering the same TLAS compile."""
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")
    path = _files(tmp_path)["city2"]
    jhs, jgroups, jinst, _ = jgltf.load_gltf_tlas(path)
    jcs = jbuilder.compile_tlas(jhs, jgroups, jinst, cluster_size=128)
    hs, groups, inst, _ = tgltf.load_gltf_tlas(path)
    pcs = builder.compile_tlas(hs, groups, inst, CPU, cluster_size=128)
    np.testing.assert_array_equal(pcs.clusters.xf_inv.numpy(), np.asarray(jcs.clusters.xf_inv))
    w, h = 20, 12
    cam = dict(eye=(80.0, 25.0, 70.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0), fov_y=12,
               aspect_ratio=w / h)
    base = dict(width=w, height=h, samples_per_launch=1, max_depth=2, traversal="cluster",
                use_shading_normals=True)
    sky = np.full((16, 32, 3), 0.5, np.float32)
    sky[2:4, 10:12] = 30.0
    jr = JaxRenderer(jcs, jax_build_probe(sky), jwf.RenderConfig(**base), JaxCamera(**cam))
    jr.render()
    pr = Renderer(pcs, build_probe(sky, CPU), twf.RenderConfig(**base), Camera(**cam))
    pr.render()
    img = pr.accum_image()
    assert img.std() > 0.01  # geometry in view, not only sky
    np.testing.assert_allclose(img, jr.accum_image(), rtol=1e-5, atol=1e-5)
    assert int(pr.last_output.rays_traced) == int(jr._last.rays_traced)
