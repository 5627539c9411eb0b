"""Port parity of the scripts beside the package (ROADMAP A.15), the tools:
`optixpathtracer_tpu_torch.tools.fps_harness` and `.interactive_session`
run small on the CPU against the same calls into the JAX package at the
same size and seed (the bench city of 40 boxes, the JAX scene carried
across by `interop` so both walk one BVH): rays per frame and the gaze path
equal, the accumulations within rtol / atol 1e-5 (the engine-option parity
tests' tolerance; ~7e-7 read). The interactive loop runs the port's
cluster walk and the JAX replica of `bench.interactive_line`'s loop the
lockstep walk (its interpret-mode cluster compile takes ~50 s here): both
are exact closest-hit walks, and the rays agree frame for frame. The
reference generators are in tests/test_torch_scripts_reference.py, the
examples in tests/test_torch_scripts_examples.py. A child process runs
every tool's `main` through `python -m`'s runner and holds jax, the JAX
package and PIL out of its sys.modules."""
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bench import build_city_scene
from optixpathtracer_tpu import models as jmodels
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine.foveated import FoveatedRenderer as JaxFoveated
from optixpathtracer_tpu.engine.foveated import FoveationConfig as JaxFoveation
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu.lights.probe import build_probe as jax_probe
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.engine import foveated
from optixpathtracer_tpu_torch.tools import CITY_BUILD, fps_harness, interactive_session

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOXES = 40
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def city():
    """(JAX compiled city, JAX probe, the port's copies) of the bench city."""
    jcs = jax_compile(build_city_scene(n_boxes=BOXES), **CITY_BUILD)
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    return jcs, jax_probe(sky), pcs, scenes.city_sky(CPU)


def _jax_camera(w, h):
    return JaxCamera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0), up=(0, 1, 0), fov_y=45,
                     aspect_ratio=w / h)


def test_fps_harness_against_jax(city, tmp_path):
    """tools/fps_harness.py's loop (warm-up frame, accumulation reset, the
    orbiting gaze, then the uniform frames) through the JAX package and
    `fps_harness.harness` at 48x32 with the smoke size's scaled radii."""
    jcs, jp, pcs, pp = city
    w, h, frames = 48, 32, 2
    fov = fps_harness.scaled_foveation(h)
    assert (fov.inner_radius, fov.outer_radius) == (8, 24)  # tools/fps_harness.py:78-84 at 32 rows
    res = fps_harness.harness(pcs, pp, w, h, frames=frames, uni_frames=1, uni_spp=2, foveation=fov,
                              dispatch_tiles=1, log=lambda s: None)

    jfr = jmodels.make_foveated_renderer(jcs, jp, _jax_camera(w, h), w, h, max_depth=4,
                                         foveation=JaxFoveation(inner_radius=8, outer_radius=24))
    jfr.render()
    jfr.accum = type(jfr.accum).zeros((w * h,))
    jfr.subframe_index = 0
    want = []
    for i in range(frames):  # tools/fps_harness.py:96-99
        ang = 2 * math.pi * i / max(frames, 1)
        gx, gy = int(w / 2 + 0.25 * w * math.cos(ang)), int(h / 2 + 0.25 * h * math.sin(ang))
        jfr.set_gaze(gx, gy)
        jfr.render()
        want.append((i, "fov", gx, gy, jfr.last_rays))
    jur = jmodels.make_disney_pt_renderer(jcs, jp, _jax_camera(w, h), w, h, spp=2, max_depth=4,
                                          dispatch_tiles=1)
    jur.render()
    jur.render()
    want.append((0, "uni", w // 2, h // 2, float(jur._last.rays_traced)))

    got = [(r[0], r[1], r[5], r[6], r[7]) for r in res["rows"]]
    assert got == want
    assert all(r[7] > 0 for r in res["rows"]) and res["rows"][0][7] < res["rows"][-1][7] * 1.0e9
    np.testing.assert_allclose(res["fov"].accum_image(), jfr.accum_image(), **TOL)
    np.testing.assert_allclose(res["uni"].accum_image(), jur.accum_image(), **TOL)

    fps_harness.write_tsvs(str(tmp_path), res["rows"], res["fov_fps"], res["uni_fps"])
    frames_tsv = (tmp_path / "fps_frames.tsv").read_text().splitlines()
    assert frames_tsv[0].split("\t") == ["i", "mode", "state_s", "render_s", "display_s", "cursorX",
                                         "cursorY", "rays"]
    assert len(frames_tsv) == 1 + frames + 1
    summary = (tmp_path / "fps_summary.tsv").read_text().splitlines()
    assert summary[0].split("\t") == ["city_fov", "city_uni"] and len(summary) == 1 + frames
    assert summary[-1].endswith("\t")  # one uniform frame, two foveated: the column runs short


def test_interactive_session_against_jax(city, tmp_path, monkeypatch):
    """`bench.interactive_line` through the tool at 64x48 against the JAX
    package's `FoveatedRenderer` driven as bench.py's interactive loop
    drives it (fused, Sobol, Russian roulette, fovea 4 spp, the clamped
    orbit): cursor path and rays per frame equal, accumulations within TOL;
    the TSV has the committed session's columns."""
    jcs, jp, pcs, pp = city
    w, h, frames = 64, 48, 3
    made = []

    class Recorded(foveated.FoveatedRenderer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(foveated, "FoveatedRenderer", Recorded)
    out = tmp_path / "session.tsv"
    rec = interactive_session.session(pcs, pp, frames, str(out), w, h)
    assert rec["frames"] == frames and rec["value"] > 0
    rows = [ln.split("\t") for ln in out.read_text().splitlines()]
    with open(os.path.join(REPO, "docs", "sessions", "interactive_640x480.tsv")) as f:
        assert rows[0] == f.readline().rstrip("\n").split("\t")
    got = [(int(r[4]), int(r[5]), float(r[6])) for r in rows[1:]]

    inner = max(8, 157 * h // 2160)
    cfg = JaxConfig(width=w, height=h, samples_per_launch=1, max_depth=4, traversal="lockstep",
                    dispatch_tiles=1, sort_rays=True, nee_final_bounce=False, sampling="sobol",
                    russian_roulette=True)
    jfr = JaxFoveated(jcs, jp, cfg, _jax_camera(w, h),
                      JaxFoveation(inner_radius=inner, outer_radius=max(24, 515 * h // 2160),
                                   fovea_spp=4), fused=True)
    jfr.render()
    margin = min(inner + 7, 64) + 2
    want = []
    for i in range(frames):
        ang = 2 * math.pi * i / frames
        gx = min(max(int(w / 2 + 0.22 * w * math.cos(ang)), margin), w - 1 - margin)
        gy = min(max(int(h / 2 + 0.22 * h * math.sin(ang)), margin), h - 1 - margin)
        jfr.set_gaze(gx, gy)
        jfr.render()
        want.append((gx, gy, jfr.last_rays))
    assert got == want
    np.testing.assert_allclose(made[0].accum_image(), jfr.accum_image(), **TOL)


CHILD = textwrap.dedent("""
    import json, runpy, sys
    import torch
    torch.set_num_threads(1)
    from optixpathtracer_tpu_torch import scenes, tools
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.tools import fps_harness, interactive_session, make_reference, make_reference_4k

    def small_city(dev, n_boxes=12500):
        return compile_scene(scenes.build_city_scene(n_boxes=4), dev, **tools.CITY_BUILD), scenes.city_sky(dev)

    for m in (fps_harness, interactive_session, make_reference, make_reference_4k):
        m.city = small_city
    harness, session = fps_harness.harness, interactive_session.session
    fps_harness.harness = lambda cs, probe, w, h, *a, **k: harness(cs, probe, 32, 16, *a, **k)
    interactive_session.session = lambda cs, probe, frames, out, *a: session(cs, probe, frames, out, 40, 40)
    make_reference_4k.W4K, make_reference_4k.H4K = 64, 32
    out = sys.argv[1]
    runs = {
        fps_harness: ["--cpu", "--small", "--frames", "1", "--uni-frames", "1", "--uni-spp", "1", "--out", out],
        interactive_session: ["--cpu", "--frames", "2", "--out", out + "/s.tsv"],
        make_reference: ["--cpu", "--width", "32", "--height", "16", "--spp", "2", "--spp-per-launch", "2",
                         "--out-dir", out],
        make_reference_4k: ["--cpu", "--disc-spp", "2", "--disc-r", "6", "--q-spp", "2", "--out-dir", out],
    }
    for m, argv in runs.items():
        sys.argv = [m.__name__, "--help"]  # the `python -m` runner, up to the argument parser
        try:
            runpy.run_module(m.__name__, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert not e.code, (m.__name__, e.code)
        assert m.main(argv) == 0, m.__name__  # main itself, on the small city
        print("IMPORTED " + json.dumps([k for k in ("jax", "optixpathtracer_tpu", "PIL") if k in sys.modules]))
""")


def test_tools_entry_points_import_no_jax_pil(tmp_path):
    """Each tool run as `python -m` runs it (up to its argument parser), then
    its `main` (on a 4-box city, the sizes shrunk inside the child), in a
    process without jax, the JAX package or PIL; each writes what the
    original writes, into the directory it is given."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    imported = [ln for ln in proc.stdout.splitlines() if ln.startswith("IMPORTED ")]
    assert imported == ["IMPORTED []"] * 4, proc.stdout[-2000:]
    names = sorted(os.listdir(tmp_path))
    for f in ("fps_frames.tsv", "fps_summary.tsv", "s.tsv", "ref_city_32x16.npz", "ref_city_4k_fovea.npz",
              "ref_city_4k_q.npz"):
        assert f in names, names
    assert not os.path.exists(os.path.join(REPO, "scenes", "ref_city_32x16.npz"))
