"""Why `bench --small --cpu` traces 16 more rays than bench.py's (pinned).

The CPU headline renders the 400-box city at 320x240, 1 spp through the
lockstep walk. The JAX package runs `trace_wavefront` jitted, and XLA fuses
its arithmetic: on a few lanes a path then ends or scatters otherwise than
in the same function run eagerly (`jax.disable_jit()`). The port follows the
eager run. Pixel 26638 of the first timed frame (subframe 1) is one such
lane: jitted it traces 4 rays, eagerly 9, the port 9, and its radiance
parts from the jitted one by more than 1e-3 while it equals the eager one
within 1e-6 (the f32 tolerance the lockstep parity tests hold).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import bench as ref_bench
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JCamera
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
from optixpathtracer_tpu_torch import scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.engine import wavefront as pwf
from optixpathtracer_tpu_torch.lights.probe import build_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 320, 240
PIXEL, SUBFRAME = 26638, 1
BUILD = dict(leaf_size=8, wide_width=8, build_wide_bvh=False, cluster_size=256)


def test_small_cpu_rays_part_where_xla_fuses_the_reference():
    kw = dict(width=W, height=H, samples_per_launch=1, max_depth=4, traversal="lockstep",
              dispatch_tiles=1, sort_rays=False, nee_final_bounce=False, batch_spp=False)
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    py, px = divmod(PIXEL, W)

    jcs = jax_compile(ref_bench.build_city_scene(n_boxes=400), **BUILD)
    jcam = jwf.CameraParams.from_camera(JCamera(eye=(55.0, 18.0, 55.0), lookat=(0.0, 2.0, 0.0),
                                                up=(0, 1, 0), fov_y=45, aspect_ratio=W / H))
    jargs = (jcs, jax_build_probe(sky), jwf.RenderConfig(**kw), jcam,
             jnp.asarray([px], jnp.int32), jnp.asarray([py], jnp.int32), jnp.uint32(SUBFRAME))
    fused = jax.jit(jwf.trace_wavefront, static_argnames=("cfg",))(*jargs)
    with jax.disable_jit():
        eager = jwf.trace_wavefront(*jargs)

    cs = compile_scene(scenes.build_city_scene(n_boxes=400), CPU, **BUILD)
    port = pwf.trace_wavefront(cs, build_probe(sky, CPU), pwf.RenderConfig(**kw),
                               pwf.CameraParams.from_camera(scenes.city_camera(W, H), CPU),
                               torch.tensor([px], dtype=torch.int32),
                               torch.tensor([py], dtype=torch.int32), SUBFRAME)

    def rgb(out):
        return np.array([np.asarray(c)[0] for c in out.color], np.float64)

    assert (int(fused.rays_traced), int(eager.rays_traced), int(port.rays_traced)) == (4, 9, 9)
    assert np.abs(rgb(port) - rgb(eager)).max() <= 1e-6
    assert np.abs(rgb(port) - rgb(fused)).max() > 1e-3
