"""The `spectral` golden (96x64, 2 spp, depth 3, two frames) and why the
port misses it by a hair (ROADMAP C.8, a pinned departure, as C.5 is for
`foveated_s`).

The golden came from the JAX renderer's jitted programs, where XLA fuses
a*b+c into one FMA. The port rounds every op, as JAX does when it runs
eagerly. On a few pixels a one-ulp difference flips a path: at pixel
(row 42, column 40) a bounce ray crosses the edge shared by two triangles
of the glass box, the two hits tie in t up to that ulp, and the fused
program keeps the other triangle. So the port's full-frame RMSE against
the golden is 2.017e-3, against a tolerance of 2e-3; the eager JAX render
misses it the same way. Both tests here are exact about where:

- the jitted JAX render (its lockstep backend, as the golden was made)
  reproduces the golden; the port differs from it by more than 1e-3 on at
  most three pixels, and on every other pixel holds the golden within
  sqrt-space RMSE 2e-3;
- on pixel (42, 40), at one sample and depth 1, the fused JAX program and
  the eager one differ by more than 0.02, and the port equals the eager one
  within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.engine import spectral as jspectral
from optixpathtracer_tpu.engine.wavefront import CameraParams as JCam
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JConfig
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.engine import spectral as tspectral
from optixpathtracer_tpu_torch.engine.wavefront import CameraParams, RenderConfig
from tests import golden_scenes

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 96, 64


def test_spectral_golden_but_the_fused_pixels():
    want = np.load("tests/goldens/spectral.npz")["image"]
    fused = np.asarray(golden_scenes.render_spectral())  # jitted, lockstep: the golden's own path
    assert scenes.golden_rmse(fused, want) <= 2e-4
    got = scenes.render_preset_golden("spectral", CPU)
    apart = np.abs(got - fused).max(-1) > 1e-3
    assert 1 <= apart.sum() <= 3 and apart[42, 40]
    keep = ~apart
    assert scenes.golden_rmse(got[keep], want[keep]) <= 2e-3


def test_spectral_golden_pixel_depends_on_xla_fusion():
    jcs = jax_compile(golden_scenes._open_scene(), cluster_size=128)
    jprobe = golden_scenes._sky_probe()
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pprobe = interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU)
    cam = scenes.open_camera(W, H)
    x, y = 40, H - 1 - 42  # buffer coordinates of image pixel (row 42, column 40)
    cfg = JConfig(width=W, height=H, samples_per_launch=1, max_depth=1, traversal="lockstep")

    def jax_render(px, py):
        return jspectral.trace_spectral(jcs, jprobe, cfg, JCam.from_camera(golden_scenes._cam(
            (3.2, 2.2, 4.0), (0, 0.4, 0))), px, py, jnp.uint32(0)).x[0]

    px, py = jnp.asarray([x], jnp.int32), jnp.asarray([y], jnp.int32)
    fused = float(jax.jit(jax_render)(px, py))  # the pixel a traced argument, as in the renderer
    with jax.disable_jit():
        eager = float(jax_render(px, py))
    got = float(tspectral.trace_spectral(
        pcs, pprobe, RenderConfig(width=W, height=H, samples_per_launch=1, max_depth=1, traversal="cluster"),
        CameraParams.from_camera(cam, CPU), torch.tensor([x], dtype=torch.int32),
        torch.tensor([y], dtype=torch.int32), 0).x[0])
    assert abs(fused - eager) > 0.02
    np.testing.assert_allclose(got, eager, rtol=1e-5)
