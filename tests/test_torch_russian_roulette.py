"""Port parity, Russian-roulette path termination (the cases of
tests/test_russian_roulette.py): after `rr_start_depth` a path survives with
p = clamp(luminance(throughput), rr_min_prob, 1) and its throughput is
scaled 1/p. The port's renders hold the reference tests' properties
(unbiased, cheaper, off bit-identical, the start depth gating), and its
roulette renders match the JAX renderer's (both on the lockstep walk, the
reference's CPU default): in the closed room rays traced equal and the
image within sqrt-space RMSE 2e-3 (the goldens' metric); on the open scene
as stated in its test.
"""
import dataclasses

import numpy as np
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.core.scene import HostScene as JHost
from optixpathtracer_tpu.engine.renderer import Renderer as JaxRenderer
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from tests.golden_scenes import _sky_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 48, 32
CLOSED_CAM = dict(eye=(2.5, 2.0, 3.2), lookat=(-0.5, 1.0, -0.5), up=(0, 1, 0), fov_y=45,
                  aspect_ratio=W / H)
OPEN_CAM = dict(eye=(3, 2, 4), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=W / H)


def _closed_room(host, make):
    """A closed box room with an emissive ceiling panel: every camera path
    bounces until max_depth, the population roulette is for."""
    hs = host()
    wall = make(color=(0.65, 0.6, 0.55), roughness=0.8)
    for pos, ext in (((0, -0.25, 0), (4, 0.25, 4)), ((0, 4.25, 0), (4, 0.25, 4)),
                     ((-4.25, 2, 0), (0.25, 4, 4)), ((4.25, 2, 0), (0.25, 4, 4)),
                     ((0, 2, -4.25), (4, 4, 0.25)), ((0, 2, 4.25), (4, 4, 0.25))):
        hs.add_box(wall, pos=pos, extent=ext)
    hs.add_box(make(color=(0.1, 0.1, 0.1), emission=(8.0, 7.5, 7.0)), pos=(0, 3.95, 0),
               extent=(1.2, 0.05, 1.2))
    hs.add_box(make(color=(0.7, 0.3, 0.2), roughness=0.5), pos=(-1, 0.6, -0.5), extent=(0.6, 0.6, 0.6))
    return hs


def _port(cfg, closed=False, launches=2):
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.materials import make_material
    from optixpathtracer_tpu_torch.core.scene import HostScene

    hs = _closed_room(HostScene, make_material) if closed else scenes.open_scene()
    if closed:
        cfg = dataclasses.replace(cfg, emission_all_bounces=True)
    r = Renderer(compile_scene(hs, CPU), scenes.sky_probe(CPU), cfg,
                 Camera(**(CLOSED_CAM if closed else OPEN_CAM)))
    for _ in range(launches):
        r.render(download=False)
    return r.accum_image(), int(r.last_output.rays_traced)


def test_rr_unbiased_and_cheaper_and_equal_to_reference():
    base = RenderConfig(width=W, height=H, samples_per_launch=8, max_depth=6, clamp_radiance=1e30)
    img_off, rays_off = _port(base, closed=True)
    on = dataclasses.replace(base, russian_roulette=True)
    img_on, rays_on = _port(on, closed=True)
    m_off, m_on = float(img_off.mean()), float(img_on.mean())
    assert abs(m_on - m_off) < 0.06 * m_off, (m_on, m_off)
    assert np.isfinite(img_on).all()
    assert rays_on < 0.8 * rays_off, (rays_on, rays_off)
    # the JAX renderer on the same closed room, the same config
    jcs = jax_compile(_closed_room(JHost, jmake))
    jr = JaxRenderer(jcs, _sky_probe(), JaxConfig(**dataclasses.asdict(
        dataclasses.replace(on, emission_all_bounces=True))), JaxCamera(**CLOSED_CAM))
    for _ in range(2):
        jr.render(download=False)
    assert int(jr._last.rays_traced) == rays_on
    assert scenes.golden_rmse(img_on, jr.accum_image()) <= 2e-3


def test_rr_off_bit_identical_to_default():
    base = RenderConfig(width=W, height=H, samples_per_launch=4, max_depth=4, clamp_radiance=1e30)
    img_a, rays_a = _port(base, launches=1)
    img_b, rays_b = _port(dataclasses.replace(base, russian_roulette=False), launches=1)
    np.testing.assert_array_equal(img_a, img_b)
    assert rays_a == rays_b


def test_rr_start_depth_gates_shallow_paths():
    """With max_depth < rr_start_depth the roulette never fires: the same
    rays as the roulette-off render (the RR draw shifts the RNG streams,
    so the images differ by noise, but no path is killed)."""
    base = RenderConfig(width=W, height=H, samples_per_launch=2, max_depth=1, clamp_radiance=1e30)
    _, rays_off = _port(base, launches=1)
    img_on, rays_on = _port(dataclasses.replace(base, russian_roulette=True, rr_start_depth=2), launches=1)
    assert rays_on == rays_off
    assert np.isfinite(img_on).all()


def test_rr_render_equal_to_reference_on_the_open_scene():
    """One roulette launch on the open golden scene (glass, metal, diffuse),
    from depth 1 on, the JAX scene carried across, against the JAX renderer
    run eagerly (`jax.disable_jit()`). Jitted, XLA fuses the arithmetic and
    on this view a few paths through the glass box's edges part (the C.5
    mechanism: sqrt RMSE 6.7e-3 with roulette, 6.5e-3 without, at 4 spp in
    a sample loop). Eagerly the image agrees to sqrt-space RMSE 1e-5; a
    path's survival draw `u < p` may still part on a few lanes where the
    two packages' transcendentals round p a few ulps apart: rays traced
    within 0.2 %."""
    import jax

    from tests.golden_scenes import _open_scene

    jcs = jax_compile(_open_scene())
    cfg = dict(width=24, height=16, samples_per_launch=4, max_depth=4, russian_roulette=True,
               rr_start_depth=1, batch_spp=True)  # one wavefront: fewer eager JAX ops
    jr = JaxRenderer(jcs, _sky_probe(), JaxConfig(**cfg), JaxCamera(**OPEN_CAM))
    with jax.disable_jit():
        jr.render()
    pr = Renderer(interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU),
                  interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU),
                  RenderConfig(**cfg), Camera(**OPEN_CAM))
    pr.render()
    assert pr.config.traversal == jr.config.traversal == "lockstep"
    got, want = int(pr.last_output.rays_traced), int(jr._last.rays_traced)
    assert abs(got - want) <= 0.002 * want, (got, want)
    assert scenes.golden_rmse(pr.accum_image(), jr.accum_image()) <= 1e-5
