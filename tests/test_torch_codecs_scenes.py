"""Port parity, the codecs inside scenes and the committed fixtures.

- tests/torch_fixtures/textures: PIL's decode of every committed fixture
  equals the manifest that chip_smoke.py's `codecs_scene` holds the port to
  on a machine without PIL; a child process with PIL, jax and the JAX
  package blocked decodes every fixture to the manifest.
- The loft (scenes/loft.obj) with its textures as TGA RLE, TIFF LZW and
  WebP lossless, as DCX, an orientation-tagged LZMA TIFF and ICNS, as a
  5/3 JP2, a tiled RPCL codestream and an ICNS of a JPEG 2000 entry, as
  WebP lossy, DDS BC1 and arithmetic JPEG, and in AVIF at PIL's defaults
  (palette and IntraBC inside): `load_obj` equal to the JAX
  loader's array for array, the lossless sets' textures equal to the PNG
  decodes.
- A glTF with an embedded WebP (lossy and lossless) equal to the JAX
  loader's scene.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from optixpathtracer_tpu.io import obj as jobj
from optixpathtracer_tpu_torch.io import obj as tobj
from test_torch_obj_gltf import _assert_same_gltf, _assert_same_scene, _textured_glb
from torch_codec_encoders import photo, pil_bytes, pil_rgb
from torch_fixtures.make_textures import LOSSLESS, LOSSLESS2, LOSSLESS3, LOSSY, LOSSY2, MANIFEST, OUT, digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(MANIFEST) as f:
    FIXTURES = json.load(f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_manifest_is_pils_decode(name):
    with open(os.path.join(OUT, name), "rb") as f:
        data = f.read()
    entry = FIXTURES[name]
    assert entry["bytes"] == len(data)
    assert {k: entry[k] for k in ("shape", "sums", "sha256")} == digest(pil_rgb(data))


def test_fixtures_fit_their_budget():
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    assert total <= 1_500_000 and set(os.listdir(OUT)) == set(FIXTURES) | {"manifest.json"}
    assert [FIXTURES[n]["group"] for n in LOSSLESS.values()] == ["loft_lossless"] * 3
    assert [FIXTURES[n]["group"] for n in LOSSY.values()] == ["loft_lossy"] * 3
    assert [FIXTURES[n]["group"] for n in LOSSLESS2.values()] == ["loft_lossless2"] * 3
    assert [FIXTURES[n]["group"] for n in LOSSLESS3.values()] == ["loft_lossless3"] * 3
    assert [FIXTURES[n]["group"] for n in LOSSY2.values()] == ["loft_lossy2"] * 3


_CHILD = """import hashlib, importlib.abc, json, os, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "jax", "jaxlib", "optixpathtracer_tpu"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
from optixpathtracer_tpu_torch.io.image import rgb8_from_bytes
out, manifest = sys.argv[1], json.load(open(sys.argv[2]))
bad = []
for name, entry in sorted(manifest.items()):
    rgb = rgb8_from_bytes(open(os.path.join(out, name), "rb").read())
    got = [list(rgb.shape), rgb.reshape(-1, 3).sum(0).tolist(), hashlib.sha256(rgb.tobytes()).hexdigest()]
    if got != [entry["shape"], entry["sums"], entry["sha256"]]:
        bad.append(name)
print(json.dumps({"bad": bad, "n": len(manifest),
                  "imported": [m for m in ("PIL", "jax", "optixpathtracer_tpu") if m in sys.modules]}))
"""


def test_fixtures_decode_in_a_process_without_pil_or_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD, OUT, MANIFEST], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "n": len(FIXTURES), "imported": []}


def _loft_with(tmp_path, names: dict) -> str:
    shutil.copy(os.path.join(REPO, "scenes", "loft.obj"), tmp_path)
    mtl = open(os.path.join(REPO, "scenes", "loft.mtl")).read()
    for png, name in names.items():
        shutil.copy(os.path.join(OUT, name), tmp_path)
        mtl = mtl.replace(png, name)
    (tmp_path / "loft.mtl").write_text(mtl)
    return str(tmp_path / "loft.obj")


@pytest.mark.parametrize("kind", ["lossless", "lossy", "lossless2", "lossless3", "lossy2"])
def test_loft_textures_load_as_the_jax_loader_loads_them(tmp_path, kind):
    names = {"lossless": LOSSLESS, "lossy": LOSSY, "lossless2": LOSSLESS2, "lossless3": LOSSLESS3,
             "lossy2": LOSSY2}[kind]
    path = _loft_with(tmp_path, names)
    got = tobj.load_obj(path)
    _assert_same_scene(got, jobj.load_obj(path, prefer_native=False))
    assert len(got.textures) == 3
    if not kind.startswith("lossy"):  # the same texels as the PNG loft's
        for tex, png in zip(got.textures, tobj.load_obj(os.path.join(REPO, "scenes", "loft.obj")).textures):
            np.testing.assert_array_equal(tex, png)


@pytest.mark.parametrize("lossless", [False, True])
def test_gltf_embedded_webp_equal_to_jax(tmp_path, lossless):
    data = pil_bytes(photo(12, 20, 10), "WEBP", lossless=lossless, quality=75)
    got, _ = _assert_same_gltf(_textured_glb(tmp_path / "webp.glb", data))
    np.testing.assert_array_equal(got.textures[0], pil_rgb(data).astype(np.float32) / 255.0)
