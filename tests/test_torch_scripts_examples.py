"""Port parity of the scripts beside the package (ROADMAP A.15), the
examples `optixpathtracer_tpu_torch.examples.render_loft` and
`.render_cornell` run small on the CPU against the same calls into the JAX
package at the same size (each package compiles its own scene: the native
builders order both alike): the cornell accumulation within rtol / atol
1e-5 (the engine-option parity tests' tolerance), the textured loft's
within sqrt-space RMSE 1e-5 (tests/test_torch_textures.py's: ulp-level hit
uv part a few texels), the written PNGs within 1 per channel of the JAX
render's frame (the CLI parity tests' tolerance, read back through the
port's decoder). `.render_foveated` and `.demand_textures_demo` are in
tests/test_torch_scripts_examples_demo.py. A child process runs each of the
four examples' `main` and holds jax, the JAX package and PIL out of its
sys.modules."""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.math import Vec3 as JaxVec3
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.io.obj import load_obj as jax_load_obj
from optixpathtracer_tpu.lights.lights import QuadLight as JaxQuadLight
from optixpathtracer_tpu.lights.probe import build_probe as jax_probe
from optixpathtracer_tpu.ops import tonemap as jtm
from optixpathtracer_tpu.utils.platform import auto_tune as jax_auto_tune
from optixpathtracer_tpu_torch.examples import render_cornell, render_loft
from optixpathtracer_tpu_torch import scenes
from optixpathtracer_tpu_torch.io.image import read_rgb8

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _png_close(path, frame_u8):
    got = read_rgb8(str(path)).astype(np.int16)
    assert got.shape == frame_u8[..., :3].shape
    assert np.abs(got - frame_u8[..., :3].astype(np.int16)).max() <= 1


def _jax_cfg(**kw):
    return jax_auto_tune(JaxConfig(**kw))


def test_render_loft_against_jax(tmp_path):
    w, h = 48, 32
    out = tmp_path / "loft.png"
    r = render_loft.render_loft(CPU, str(out), w, h, frames=1, log=lambda s: None)
    cs = jax_compile(jax_load_obj(os.path.join(REPO, "scenes", "loft.obj")))
    cfg = _jax_cfg(width=w, height=h, samples_per_launch=4, max_depth=4, emission_all_bounces=True,
                   use_shading_normals=True)
    jr = JaxRenderer(cs, jax_probe(np.full((8, 16, 3), 1e-6, np.float32)), cfg,
                     JaxCamera(eye=(-5.2, 2.4, 3.2), lookat=(2.0, 1.2, -1.0), up=(0, 1, 0), fov_y=55,
                               aspect_ratio=w / h))
    frame = jr.render()
    assert scenes.golden_rmse(r.accum_image(), jr.accum_image()) <= 1e-5
    _png_close(out, frame)
    den = np.clip(np.sqrt(np.clip(jr.denoised_image(), 0, None)), 0, 1)
    got = read_rgb8(str(tmp_path / "loft_denoised.png")).astype(np.int16)
    assert np.abs(got - (den * 255.0 + 0.5).astype(np.int16)).max() <= 1


def test_render_cornell_against_jax(tmp_path):
    w = h = 32
    out = tmp_path / "cornell.png"
    r = render_cornell.render_cornell(CPU, str(out), w, h, spp=2, frames=1, log=lambda s: None)
    cs = jax_compile(jax_load_obj(os.path.join(REPO, "scenes", "cornell_box.obj")))
    light = JaxQuadLight.make(corner=(-0.3, 1.985, -0.3), v1=(0.6, 0, 0), v2=(0, 0, 0.6),
                              emission=(15.0, 15.0, 15.0))
    cfg = _jax_cfg(width=w, height=h, samples_per_launch=2, max_depth=5, emission_all_bounces=True)
    jr = JaxRenderer(cs, jax_probe(np.full((8, 16, 3), 1e-5, np.float32)), cfg,
                     JaxCamera(eye=(0, 1.0, 3.6), lookat=(0, 1.0, 0), up=(0, 1, 0), fov_y=40, aspect_ratio=1.0),
                     area_light=light)
    jr.render()
    acc = jr.accum_image()
    np.testing.assert_allclose(r.accum_image(), acc, **TOL)
    v = JaxVec3(*(jnp.asarray(acc[..., k]) for k in range(3)))
    disp = jtm.finalize(v, mode="reinhard", exposure_stops=1.0)
    want = (np.clip(np.stack([np.asarray(c) for c in disp], -1), 0, 1) * 255.0 + 0.5).astype(np.uint8)
    _png_close(out, want)


CHILD = textwrap.dedent("""
    import json, runpy, sys
    import torch
    torch.set_num_threads(1)
    from optixpathtracer_tpu_torch.examples import (demand_textures_demo, render_cornell, render_foveated,
                                                    render_loft)
    out = sys.argv[1]
    small = {render_loft: ("render_loft", dict(width=32, height=16, frames=1)),
             render_cornell: ("render_cornell", dict(width=16, height=16, spp=1, frames=1)),
             render_foveated: ("render_foveated", dict(width=32, height=24, frames=1, inner=4, outer=8)),
             demand_textures_demo: ("demand_demo", dict(width=32, height=20))}
    for m, (fn, kw) in small.items():
        body = getattr(m, fn)
        setattr(m, fn, lambda dev, path, body=body, kw=kw, **k: body(dev, path, **{**k, **kw}))
        sys.argv = [m.__name__, "--help"]  # the `python -m` runner, up to the argument parser
        try:
            runpy.run_module(m.__name__, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert not e.code, (m.__name__, e.code)
        assert m.main([f"{out}/{fn}.png", "--cpu"]) == 0, m.__name__  # main itself, small
        print("IMPORTED " + json.dumps([k for k in ("jax", "optixpathtracer_tpu", "PIL") if k in sys.modules]))
""")


def test_examples_entry_points_import_no_jax_pil(tmp_path):
    """Each example run as `python -m` runs it (up to its argument parser),
    then its `main` with the sizes shrunk inside the child, in a process
    without jax, the JAX package or PIL; each writes its PNG where it is told."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    imported = [ln for ln in proc.stdout.splitlines() if ln.startswith("IMPORTED ")]
    assert imported == ["IMPORTED []"] * 4, proc.stdout[-2000:]
    for name, shape in (("render_loft", (16, 32)), ("render_loft_denoised", (16, 32)),
                        ("render_cornell", (16, 16)), ("render_foveated", (24, 32)), ("demand_demo", (20, 32))):
        img = read_rgb8(str(tmp_path / f"{name}.png"))
        assert img.shape == (*shape, 3) and img.max() > 0, name
