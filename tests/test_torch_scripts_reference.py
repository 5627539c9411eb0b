"""Port parity of the scripts beside the package (ROADMAP A.15), the
reference generators: `optixpathtracer_tpu_torch.tools.make_reference` and
`.make_reference_4k` run small on the CPU against the same calls into the
JAX package at the same size (the bench city of 40 boxes, the JAX scene
carried across by `interop`): the accumulations within rtol / atol 1e-5,
the stored float16 images within one float16 rounding of the JAX ones, the
npz keys and metadata those of the committed scenes/ref_city_*.npz, the
milestone checkpoints where the original writes them, `disc_pixels` bit
for bit against the original's (16x8 tile order) and the 4x4 box
downsample against its reshape-mean. The originals write into scenes/, so
they are not run; their functions that write nothing are imported from a
copy of tools/make_reference_4k.py."""
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_city_scene
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.lights.probe import build_probe as jax_probe
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.tools import CITY_BUILD, make_reference, make_reference_4k

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def city():
    jcs = jax_compile(build_city_scene(n_boxes=40), **CITY_BUILD)
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    return jcs, jax_probe(sky), pcs, scenes.city_sky(CPU)


def _jax_camera(w, h):
    return JaxCamera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0), fov_y=45,
                     aspect_ratio=w / h)


def _jax_canonical(r):
    inv = np.argsort(r._perm, kind="stable")
    return np.stack([np.asarray(c) for c in r.accum], -1)[inv]


def test_make_reference_against_jax(city, tmp_path):
    """tools/make_reference.py's renderer and checkpoints at 32x16: 4 spp in
    launches of 2, a milestone at 2 spp."""
    jcs, jp, pcs, pp = city
    w, h = 32, 16
    out = str(tmp_path / "ref.npz")
    logs = []
    r = make_reference.make_reference(pcs, pp, w, h, spp=4, spp_per_launch=2, out=out, milestones=(2,),
                                      log=logs.append)
    assert [ln.split(" -> ")[0] for ln in logs] == ["checkpoint 2 spp", "checkpoint 4 spp"]
    cfg = jwf.RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=4, traversal="lockstep",
                           dispatch_tiles=1, sort_rays=False, nee_final_bounce=False, batch_spp=True,
                           sampling="stratified")  # tools/make_reference.py:78-83 on a CPU
    jr = JaxRenderer(jcs, jp, cfg, _jax_camera(w, h))
    jr.render(download=False)
    jr.render(download=False)
    want = _jax_canonical(jr)
    np.testing.assert_allclose(make_reference.canonical(r), want, **TOL)
    got = np.load(out)
    committed = np.load(os.path.join(REPO, "scenes", "ref_city_600x400.npz"))
    assert set(got.files) == set(committed.files)
    for k in ("max_depth", "scene", "eye", "lookat", "fov_y"):
        np.testing.assert_array_equal(got[k], committed[k])
    assert (int(got["width"]), int(got["height"]), int(got["spp"])) == (w, h, 4)
    assert got["image"].dtype == np.float16
    np.testing.assert_allclose(got["image"].astype(np.float32), want.astype(np.float16).astype(np.float32),
                               rtol=1e-3, atol=1e-5)


def test_make_reference_milestones_fire_on_reaching(city, tmp_path):
    """A milestone fires on `spp_done >= m` (tools/make_reference.py:88-97):
    launches of 3 spp checkpoint at 3 for the milestone 2, at 6 for 4 and
    the end."""
    _, _, pcs, pp = city
    logs = []
    make_reference.make_reference(pcs, pp, 16, 8, spp=6, spp_per_launch=3, out=str(tmp_path / "m.npz"),
                                  milestones=(2, 4, 512), log=logs.append)
    assert [ln.split(" -> ")[0] for ln in logs] == ["checkpoint 3 spp", "checkpoint 6 spp"]


def _original_4k(tmp_path):
    """tools/make_reference_4k.py, copied under tmp_path (whose scenes/ is the
    copy's) and imported: its module level imports numpy only."""
    os.makedirs(tmp_path / "tools")
    path = shutil.copy(os.path.join(REPO, "tools", "make_reference_4k.py"), tmp_path / "tools")
    spec = importlib.util.spec_from_file_location("original_make_reference_4k", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size", [(64, 32, 9), (200, 120, 40), (3840, 2160, 157)])
def test_disc_pixels_bit_equal_to_original(size, tmp_path):
    w, h, r = size
    orig = _original_4k(tmp_path)
    for a, b in zip(make_reference_4k.disc_pixels(w, h, w // 2, h // 2, r),
                    orig.disc_pixels(w, h, w // 2, h // 2, r)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_box_downsample_is_the_originals():
    full = np.random.default_rng(4).random((32, 64, 3)).astype(np.float32)
    want = full.reshape(8, 4, 16, 4, 3).mean(axis=(1, 3))  # tools/make_reference_4k.py:154
    np.testing.assert_array_equal(make_reference_4k.box_downsample(full), want)


def test_make_reference_4k_against_jax(city):
    """The fovea disc (tools/make_reference_4k.py:100-125) and the
    quarter-resolution companion (:140-155) at 64x32, Sobol, 2 spp."""
    jcs, jp, pcs, pp = city
    w, h, r, spp = 64, 32, 6, 2
    cfg = make_reference_4k.reference_config(CPU, w, h, 2)
    px, py, img = make_reference_4k.fovea_disc(pcs, pp, scenes.city_camera(w, h), cfg, spp, r,
                                               log=lambda s: None)
    jcfg = jwf.RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=4, traversal="lockstep",
                            sort_rays=False, nee_final_bounce=False, batch_spp=True, sampling="sobol")
    camp = jwf.CameraParams.from_camera(_jax_camera(w, h))
    out = jax.jit(lambda x, y: jwf.trace_wavefront(jcs, jp, jcfg, camp, x, y, jnp.uint32(0)).color)(
        jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_allclose(img, np.stack([np.asarray(c) for c in out], -1) / spp, **TOL)

    q = make_reference_4k.companion(pcs, pp, scenes.city_camera(w, h), cfg, spp, log=lambda s: None)
    jr = JaxRenderer(jcs, jp, jcfg, _jax_camera(w, h))
    jr.render(download=False)
    want = _jax_canonical(jr).reshape(h, w, 3).reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(q, want, **TOL)
