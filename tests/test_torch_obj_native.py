"""Port parity, the native OBJ tokenizer (the cases of
tests/test_obj_native.py): `io/native.py` (the port's copy of
objparser.cpp) and `io/obj.load_obj`'s native path against the port's
Python parser and against the JAX package's native load, mesh for mesh.
"""
import time

import numpy as np
import pytest

from optixpathtracer_tpu.io.obj import load_obj as jax_load_obj
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.scene import HostScene
from optixpathtracer_tpu_torch.io.native import parse_obj_native
from optixpathtracer_tpu_torch.io.obj import _load_obj_python, load_obj, save_obj


@pytest.fixture(autouse=True)
def _reference_native():
    from tests.torch_backend_cases import reference_native_libs

    reference_native_libs()


def _fixture_scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.2, 0.1)), pos=(0, 0, 0), extent=(1, 2, 3))
    hs.add_box(make_material(color=(0.1, 0.9, 0.2), emission=(1, 2, 3)), pos=(5, 0, 0),
               extent=(1, 1, 1))
    return hs


def _assert_same_meshes(got, want):
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(got.meshes, want.meshes):
        for f in ("vertices", "indices", "normals", "texcoords"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
        np.testing.assert_array_equal(a.material["color"], b.material["color"])
        np.testing.assert_array_equal(a.material["emission"], b.material["emission"])


def test_native_matches_python_and_reference(tmp_path):
    path = str(tmp_path / "scene.obj")
    save_obj(path, _fixture_scene())
    assert parse_obj_native(path) is not None
    nat = load_obj(path)
    _assert_same_meshes(nat, jax_load_obj(path, prefer_native=True))
    py = _load_obj_python(path)
    _assert_same_meshes(py, jax_load_obj(path, prefer_native=False))
    # the native and Python paths hold the same triangles (vertex order may differ)
    assert sum(len(m.indices) for m in nat.meshes) == sum(len(m.indices) for m in py.meshes)
    for a, b in zip(nat.meshes, py.meshes):
        tri_a = {tuple(np.round(a.vertices[f].ravel(), 5)) for f in a.indices}
        tri_b = {tuple(np.round(b.vertices[f].ravel(), 5)) for f in b.indices}
        assert tri_a == tri_b


def test_native_negative_indices_and_quads(tmp_path):
    (tmp_path / "q.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f -4/-4 -3/-3 -2/-2 -1/-1\n")
    hs = load_obj(str(tmp_path / "q.obj"))
    assert len(hs.meshes) == 1 and len(hs.meshes[0].indices) == 2
    sa = set(map(tuple, hs.meshes[0].vertices))
    assert (0.0, 0.0, 0.0) in sa and (1.0, 1.0, 0.0) in sa
    _assert_same_meshes(hs, jax_load_obj(str(tmp_path / "q.obj")))


def test_native_speed_on_larger_file(tmp_path):
    rng = np.random.default_rng(0)
    n = 20000
    v = rng.random((3 * n, 3)).astype(np.float32)
    lines = ["o big\n"] + [f"v {a} {b} {c}\n" for a, b, c in v]
    lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n" for i in range(n)]
    p = tmp_path / "big.obj"
    p.write_text("".join(lines))
    load_obj(str(p))  # the library is built by now; time the parse alone
    t0 = time.perf_counter()
    nat = load_obj(str(p))
    t_nat = time.perf_counter() - t0
    assert sum(len(m.indices) for m in nat.meshes) == n
    _assert_same_meshes(nat, jax_load_obj(str(p)))
    t0 = time.perf_counter()
    _load_obj_python(str(p))
    assert t_nat < time.perf_counter() - t0


def test_switch_takes_the_python_parser(tmp_path, monkeypatch):
    path = str(tmp_path / "scene.obj")
    save_obj(path, _fixture_scene())
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")
    assert parse_obj_native(path) is None
    _assert_same_meshes(load_obj(path), _load_obj_python(path))
