"""Port parity, io/obj and io/gltf: the port's loaders give the JAX
loaders' host scenes exactly.

The OBJ side compares each of the port's two parsers with the reference's
same one: the Python parsers (`load_obj(path, prefer_native=False)`) and
the native tokenizers (the default; both packages build the same C++
source), whose meshes may order their vertices otherwise. Every
mesh array, material dict and texture is compared for equality, and
`HostScene.flatten()` array for array. The glTF cases are those of
tests/test_gltf.py and the `gltf` golden's .glb, each against the JAX
loader's output.
"""
import base64
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from optixpathtracer_tpu.core.materials import make_material as jax_material
from optixpathtracer_tpu.core.scene import HostScene as JaxHostScene
from optixpathtracer_tpu.io import gltf as jgltf
from optixpathtracer_tpu.io import obj as jobj
from optixpathtracer_tpu_torch import scenes
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.scene import HostScene, Mesh
from optixpathtracer_tpu_torch.io import gltf as tgltf
from optixpathtracer_tpu_torch.io import obj as tobj
from tests.test_gltf import _reuse_gltf, _tri_gltf
from torch_fixtures.make_textures import AVIF_RAISES, OUT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reference_native():
    from tests.torch_backend_cases import reference_native_libs

    reference_native_libs()


def _assert_same_scene(got, want):
    """Two HostScenes (port, reference) mesh for mesh and flattened."""
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(got.meshes, want.meshes):
        for field in ("vertices", "indices", "normals", "texcoords"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), field
            if x is not None:
                assert x.dtype == y.dtype, field
                np.testing.assert_array_equal(x, y, err_msg=field)
        assert a.material == b.material
    assert len(got.textures) == len(want.textures)
    for x, y in zip(got.textures, want.textures):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    if got.meshes:
        fg, fw = got.flatten(), want.flatten()
        assert fg.keys() == fw.keys()
        for k in ("v", "n", "uv"):
            for x, y in zip(fg[k], fw[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        for k in ("material_id", "has_shading_normal"):
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
        assert fg["materials"] == fw["materials"]


@pytest.mark.parametrize("name", ["loft.obj", "cornell_box.obj", "city_small.obj"])
def test_bundled_obj_scenes_equal_to_jax(name):
    path = os.path.join(REPO, "scenes", name)
    _assert_same_scene(tobj.load_obj(path, prefer_native=False), jobj.load_obj(path, prefer_native=False))
    _assert_same_scene(tobj.load_obj(path), jobj.load_obj(path))


def test_loft_textures_and_materials():
    hs = tobj.load_obj(scenes.LOFT_OBJ)
    assert len(hs.textures) == 3 and all(t.shape == (256, 256, 3) for t in hs.textures)
    ids = sorted({m.material["texture_id"] for m in hs.meshes})
    assert ids[0] == -1 and ids[1:] == [0, 1, 2]
    assert any(sum(m.material["emission"]) > 0 for m in hs.meshes)  # the emissive panels


def _write(tmp_path, name, text):
    (tmp_path / name).write_text(text)
    return str(tmp_path / name)


OBJ_CASES = {
    "material_split": ("o thing\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nusemtl red\nf 1 2 3\n"
                       "usemtl blue\nf 2 4 3\n"),
    "negative_indices_and_quads": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n",
    "dedupe": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2 4 3\n",
    # corners with and without vn: the geometric-normal fallback; vt on some
    "mixed_normals_uv": ("g a\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 2 1 0\nvn 0 0 1\nvt 0.5 0.25\n"
                         "vt 1 1\nf 1/1/1 2/2/1 3//1\nf 2 4 3\nf 4/-1 5/-2 3\n"),
    "groups_and_pentagon": ("v 0 0 0\nv 1 0 0\nv 1.5 1 0\nv 0.5 2 0\nv -0.5 1 0\ng one\n"
                            "usemtl tex\nf 1 2 3 4 5\ng two\nusemtl red\nf 1 3 5\n# comment\n"
                            "o three\nusemtl tex\nf 2/ 3 4\n"),
}
MTL = ("newmtl red\nKd 1 0 0\nKe 0.5 0.25 0\nnewmtl blue\nKd 0 0 1\n"
       "newmtl tex\nKd 0.3 0.3 0.3\nmap_Kd sub\\tex.png\n")


@pytest.mark.parametrize("case", sorted(OBJ_CASES))
def test_obj_cases_equal_to_jax(case, tmp_path):
    (tmp_path / "sub").mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)).save(tmp_path / "sub" / "tex.png")
    _write(tmp_path, "m.mtl", MTL)
    path = _write(tmp_path, "s.obj", "mtllib m.mtl\n" + OBJ_CASES[case])
    got, want = tobj.load_obj(path, prefer_native=False), jobj.load_obj(path, prefer_native=False)
    _assert_same_scene(got, want)
    _assert_same_scene(tobj.load_obj(path), jobj.load_obj(path))
    assert tobj._find_mtllibs(path) == jobj._find_mtllibs(path) == ["m.mtl"]
    if case == "negative_indices_and_quads":
        assert len(got.meshes[0].indices) == 2  # the quad fan-triangulated
    if case == "dedupe":
        assert len(got.meshes[0].vertices) == 4


def test_parse_helpers_equal_to_jax(tmp_path):
    for token in ("3", "-1", "2/5", "2//7", "-2/-1/-3", "4/1/2"):
        assert tobj._parse_index(token, 9, 8, 7) == jobj._parse_index(token, 9, 8, 7)
    path = _write(tmp_path, "m.mtl", MTL + "# junk\nKd 1 2\nnewmtl two words\nKe 1 2 3\n")
    assert tobj._parse_mtl(path) == jobj._parse_mtl(path)
    assert tobj._parse_mtl(str(tmp_path / "missing.mtl")) == {}


def test_save_obj_round_trip_equal_to_jax(tmp_path):
    rng = np.random.default_rng(1)
    tex = rng.random((4, 6, 3)).astype(np.float32)
    scenes_ = []
    for host, mat in ((HostScene(), make_material), (JaxHostScene(), jax_material)):
        host.add_box(mat(color=(0.8, 0.2, 0.1)), pos=(0, 0, 0), extent=(1, 2, 3))
        host.add_box(mat(color=(0.1, 0.9, 0.2), emission=(1, 2, 3)), pos=(5, 0, 0), extent=(1, 1, 1))
        tid = host.add_texture(tex)
        host.add_mesh(Mesh(vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                           indices=np.array([[0, 1, 2]], np.int32),
                           texcoords=np.array([[0, 0], [1, 0], [0, 1]], np.float32),
                           material=mat(texture_id=tid)))
        scenes_.append(host)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    tobj.save_obj(str(tmp_path / "p" / "s.obj"), scenes_[0])
    jobj.save_obj(str(tmp_path / "j" / "s.obj"), scenes_[1])
    for name in ("s.obj", "s.mtl"):
        assert (tmp_path / "p" / name).read_text() == (tmp_path / "j" / name).read_text()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p" / "s_tex0.png")),
                                  np.asarray(Image.open(tmp_path / "j" / "s_tex0.png")))
    _assert_same_scene(tobj.load_obj(str(tmp_path / "p" / "s.obj"), prefer_native=False),
                       jobj.load_obj(str(tmp_path / "j" / "s.obj"), prefer_native=False))
    _assert_same_scene(tobj.load_obj(str(tmp_path / "p" / "s.obj")),
                       jobj.load_obj(str(tmp_path / "j" / "s.obj")))


# ---- glTF ------------------------------------------------------------------

def _png_bytes(px, **save_kw):
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, **save_kw)
    return buf.getvalue()


def _textured_glb(path, image_bytes, light=False):
    """tests/test_gltf.py's embedded-texture GLB (the image in the binary
    chunk through a bufferView), with a KHR point light on a child node."""
    image_bytes += b"\x00" * (-len(image_bytes) % 4)
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.array([[0, 0, 1], [0, 0.6, 0.8], [0, 0, 1], [0.6, 0, 0.8]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes() + b"\x00\x00" + image_bytes
    off_nrm = pos.nbytes
    off_uv = off_nrm + nrm.nbytes
    off_idx = off_uv + uv.nbytes
    off_img = off_idx + idx.nbytes + 2
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "rotation": [0.0, 0.38268343, 0.0, 0.92387953], "scale": [2, 1, 1],
                   "children": [1]},
                  {"translation": [0.5, 3.0, -1.0],
                   **({"extensions": {"KHR_lights_punctual": {"light": 0}}} if light else {})}],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "color": [1.0, 0.9, 0.8], "intensity": 40.0}]}},
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 1, "NORMAL": 3, "TEXCOORD_0": 2},
            "indices": 0, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1], "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0, "roughnessFactor": 0.7}, "emissiveFactor": [0.1, 0.2, 0.3]}],
        "textures": [{"source": 0}],
        "images": [{"bufferView": 3, "mimeType": "image/png"}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": off_idx, "byteLength": idx.nbytes},
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": off_uv, "byteLength": uv.nbytes},
            {"buffer": 0, "byteOffset": off_img, "byteLength": len(image_bytes)},
            {"buffer": 0, "byteOffset": off_nrm, "byteLength": nrm.nbytes},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5123, "count": 6, "type": "SCALAR"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 4, "componentType": 5126, "count": 4, "type": "VEC3"},
        ],
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    path.write_bytes(struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + 8 + len(blob))
                     + struct.pack("<I4s", len(js), b"JSON") + js
                     + struct.pack("<I4s", len(blob), b"BIN\x00") + blob)
    return str(path)


def _assert_same_gltf(path):
    (got, got_lights), (want, want_lights) = tgltf.load_gltf(path), jgltf.load_gltf(path)
    _assert_same_scene(got, want)
    assert got_lights == want_lights
    return got, got_lights


@pytest.mark.parametrize("translation", [None, [5.0, 0.0, 0.0]])
def test_gltf_triangle_and_node_transform(tmp_path, translation):
    got, lights = _assert_same_gltf(_tri_gltf(tmp_path, translation=translation))
    assert len(got.meshes) == 1 and lights[0]["kind"] == 1  # the default ambient light
    if translation:
        assert got.meshes[0].vertices[:, 0].min() == 5.0


def test_gltf_node_reuse_baked(tmp_path):
    got, _ = _assert_same_gltf(_reuse_gltf(tmp_path, n_nodes=6))
    assert len(got.meshes) == 6  # rotations, scales and translations baked per node


@pytest.mark.parametrize("light", [False, True])
def test_gltf_embedded_texture_normals_and_light(tmp_path, light):
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (3, 5, 3), dtype=np.uint8)
    got, lights = _assert_same_gltf(_textured_glb(tmp_path / "tex.glb", _png_bytes(px, format="PNG"), light))
    assert len(got.textures) == 1 and got.meshes[0].material["texture_id"] == 0
    np.testing.assert_array_equal(got.textures[0], px.astype(np.float32) / 255.0)  # not flipped
    assert got.meshes[0].normals is not None
    assert (lights[0]["kind"] == 0) == light


def test_gltf_golden_glb(tmp_path):
    path = tmp_path / "golden.glb"
    path.write_bytes(scenes.golden_glb())
    got, _ = _assert_same_gltf(str(path))
    assert len(got.meshes) == 2


def test_gltf_undecodable_texture_degrades_to_factors(tmp_path):
    """tests/test_gltf.py's case: a data URI that is not base64, which PIL
    could not decode either, leaves the factors, with a warning."""
    path = _tri_gltf(tmp_path)
    doc = json.loads(open(path).read())
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    doc["textures"] = [{"source": 0}]
    doc["images"] = [{"uri": "data:image/png,%89PNG%0D%0A"}]
    open(path, "w").write(json.dumps(doc))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, _ = _assert_same_gltf(path)
    assert sum("undecodable" in str(x.message) for x in w) == 2  # one from each loader
    assert got.meshes[0].material["texture_id"] == -1


def test_gltf_undecodable_payloads(tmp_path):
    """Bytes no decoder knows (PIL raises too), and a base64 data URI
    holding them: factor-only materials, with a warning, in both."""
    for image_bytes in (b"KTX2 is not ported\x00\x01", b"\x89PNG\r\n\x1a\n" + b"\x00" * 20):
        path = _textured_glb(tmp_path / "bad.glb", image_bytes)
        with pytest.warns(UserWarning, match="undecodable"):
            got, _ = tgltf.load_gltf(path)
        assert got.meshes[0].material["texture_id"] == -1
        with pytest.warns(UserWarning, match="undecodable"):
            _assert_same_gltf(path)


def test_gltf_jpeg_is_a_port_gap(tmp_path):
    """A JPEG the reference's PIL decodes, which the port once lacked
    (ROADMAP A.1), now loads to the reference's host scene."""
    px = np.random.default_rng(3).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    path = _textured_glb(tmp_path / "jpeg.glb", _png_bytes(px, format="JPEG"))
    got, _ = _assert_same_gltf(path)
    assert len(got.textures) == 1


def test_gltf_tlas_raises(tmp_path):
    """The instanced loader shares the baked loader's image decoding: a JPEG
    texture loads there too, an arithmetic-coded one as well (once a port
    gap, now decoded as PIL decodes it), an MSP, a JPEG 2000 and an AVIF at
    PIL's defaults, in 4:4:4, with quantizer matrices and as a grid too
    (ported since), and a variant PIL reads and the port does not (a
    premultiplied AVIF alpha of another size than the colour, AVIF step 6)
    is still a gap (ROADMAP A.1). (load_gltf_tlas itself is
    held against the JAX loader in tests/test_torch_gltf_tlas.py.)"""
    px = np.random.default_rng(3).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    jpeg = _png_bytes(px, format="JPEG")
    hs = tgltf.load_gltf_tlas(_textured_glb(tmp_path / "jpeg.glb", jpeg))[0]
    np.testing.assert_array_equal(hs.textures[0], jgltf.load_gltf(str(tmp_path / "jpeg.glb"))[0].textures[0])
    sof = jpeg.index(b"\xff\xc0")
    path = _textured_glb(tmp_path / "arith.glb", jpeg[:sof] + b"\xff\xc9" + jpeg[sof + 2:])
    np.testing.assert_array_equal(tgltf.load_gltf_tlas(path)[0].textures[0], jgltf.load_gltf(path)[0].textures[0])
    path = _textured_glb(tmp_path / "msp.glb", _png_bytes(px[..., 0] > 128, format="MSP"))
    np.testing.assert_array_equal(tgltf.load_gltf_tlas(path)[0].textures[0], jgltf.load_gltf(path)[0].textures[0])
    path = _textured_glb(tmp_path / "j2k.glb", _png_bytes(px, format="JPEG2000"))
    np.testing.assert_array_equal(tgltf.load_gltf_tlas(path)[0].textures[0], jgltf.load_gltf(path)[0].textures[0])
    path = _textured_glb(tmp_path / "avif.glb", _png_bytes(px, format="AVIF"))
    np.testing.assert_array_equal(tgltf.load_gltf_tlas(path)[0].textures[0], jgltf.load_gltf(path)[0].textures[0])
    path = _textured_glb(tmp_path / "avif444.glb", _png_bytes(px, format="AVIF", subsampling="4:4:4"))
    np.testing.assert_array_equal(tgltf.load_gltf_tlas(path)[0].textures[0], jgltf.load_gltf(path)[0].textures[0])
    path = _textured_glb(tmp_path / "avif_qm.glb", _png_bytes(px, format="AVIF", advanced={"enable-qm": "1"}))
    np.testing.assert_array_equal(tgltf.load_gltf_tlas(path)[0].textures[0], jgltf.load_gltf(path)[0].textures[0])
    with open(os.path.join(OUT, "avif_grid.avif"), "rb") as f:
        path = _textured_glb(tmp_path / "avif_grid.glb", f.read())
    np.testing.assert_array_equal(tgltf.load_gltf_tlas(path)[0].textures[0], jgltf.load_gltf(path)[0].textures[0])
    with open(os.path.join(OUT, "avif_prem_alpha_other_size.avif"), "rb") as f:
        path = _textured_glb(tmp_path / "avif_prem_alpha_other_size.glb", f.read())
    np.testing.assert_array_equal(tgltf.load_gltf_tlas(path)[0].textures[0], jgltf.load_gltf(path)[0].textures[0])
    with open(os.path.join(AVIF_RAISES, "avif_inter_shown_first.avif"), "rb") as f:
        path = _textured_glb(tmp_path / "avif_inter_shown_first.glb", f.read())
    with pytest.raises(NotImplementedError, match="AVIF of AV1 motion-field projection.*A.1"):
        tgltf.load_gltf_tlas(path)


def test_gltf_external_image_file(tmp_path):
    rng = np.random.default_rng(4)
    px = rng.integers(0, 256, (4, 2, 3), dtype=np.uint8)
    Image.fromarray(px).save(tmp_path / "albedo.png")
    path = _tri_gltf(tmp_path)
    doc = json.loads(open(path).read())
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    doc["textures"] = [{"source": 0}]
    doc["images"] = [{"uri": "albedo.png"}, {"uri": "data:image/png;base64,"
                                            + base64.b64encode(b"unused").decode()}]
    open(path, "w").write(json.dumps(doc))
    got, _ = _assert_same_gltf(path)
    np.testing.assert_array_equal(got.textures[0], px.astype(np.float32) / 255.0)
