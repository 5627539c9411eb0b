"""Port parity, engine/adaptive: the tile layout, the per-tile errors and
the tile selection against the JAX package, then three rounds of
`AdaptiveRenderer` on the open golden scene against the JAX renderer.

The layout, the selection (ties included: `jax.lax.top_k` gives the lower
index first, the port a stable descending sort) and the per-pixel sample
counts are exact. The errors agree to rtol 1e-6 on the same inputs. The
renders trace the same streams, so the running sums, the AOVs, the variance,
the error map and the denoised image agree to rtol / atol 1e-5 (1e-4 for
the error map, a ratio of variances, and the denoised image, whose weights
are exps of those sums); the frame is 40x20, not a multiple of the 16x8
tile, so padded slots are part of every launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.engine import adaptive as jad
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.camera import Camera
from optixpathtracer_tpu_torch.engine import adaptive as tad
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from tests.golden_scenes import _open_scene, _sky_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 40, 20
VIEW = dict(eye=(3.0, 2.0, 4.0), lookat=(0, 0.4, 0), up=(0, 1, 0), fov_y=45)


@pytest.mark.parametrize("w, h", [(50, 30), (16, 8), (40, 20), (1200, 800)])
def test_tile_layout_equal(w, h):
    got, want = tad._tile_layout(w, h), jad._tile_layout(w, h)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)
    assert (tad.TILE_W, tad.TILE_H, tad.TILE_N) == (jad.TILE_W, jad.TILE_H, jad.TILE_N)


def _sums(seed, tiles=12):
    rng = np.random.default_rng(seed)
    p = tiles * tad.TILE_N
    count = rng.integers(0, 9, p).astype(np.uint32)
    count[: tad.TILE_N] = 0  # a tile never sampled (padded, or not yet)
    lum = (rng.random(p) * count).astype(np.float32)
    lum2 = (lum * lum / np.maximum(count, 1) * rng.uniform(1.0, 3.0, p)).astype(np.float32)
    return lum, lum2, count


def test_tile_errors_match_jax():
    lum, lum2, count = _sums(0)
    want = np.asarray(jad._tile_errors(jnp.asarray(lum), jnp.asarray(lum2), jnp.asarray(count), 12))
    got = tad._tile_errors(torch.as_tensor(lum), torch.as_tensor(lum2),
                           torch.as_tensor(count.astype(np.int64)), 12).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0


@pytest.mark.parametrize("k", [1, 5, 12, 40])
def test_top_tiles_equal_including_ties(k):
    rng = np.random.default_rng(k)
    err = rng.choice(np.array([0.0, 0.0, 0.0, 0.25, 0.5, 1.5], np.float32), 40)  # heavy ties
    err[[3, 17, 29]] = 0.5
    _, want = jax.lax.top_k(jnp.asarray(err), k)
    got = tad._top_tiles(torch.as_tensor(err), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module", params=["random", "sobol"])
def renderers(request):
    """(JAX, port) adaptive renderers after three rounds (warm-up 2 spp,
    two refinements of 4 spp over a quarter of the tiles)."""
    cfg = dict(width=W, height=H, samples_per_launch=2, max_depth=2, sampling=request.param,
               sort_rays=True)
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    jr = jad.AdaptiveRenderer(jcs, _sky_probe(), JaxConfig(traversal="lockstep", **cfg),
                              JaxCamera(aspect_ratio=W / H, **VIEW))
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    probe = interop.probe_from_arrays(interop.probe_arrays(_sky_probe()), CPU)
    pr = tad.AdaptiveRenderer(pcs, probe, RenderConfig(traversal="cluster", **cfg),
                              Camera(aspect_ratio=W / H, **VIEW))
    for r in (jr, pr):
        r.render_n(3)
    return jr, pr


def test_counts_and_stats_equal(renderers):
    jr, pr = renderers
    np.testing.assert_array_equal(pr.count.numpy(), np.asarray(jr.count).astype(np.int64))
    np.testing.assert_array_equal(pr.sample_map(), jr.sample_map())
    got, want = pr.stats(), jr.stats()
    assert list(got) == list(want)
    assert got["rays_traced"] == pytest.approx(want["rays_traced"], rel=0.01)
    for k in ("rounds", "total_samples", "spp_min", "spp_max", "refine_tiles", "n_tiles"):
        assert got[k] == want[k], k
    assert got["spp_max"] == 2 + 2 * 4 and got["spp_min"] == 2  # refinement concentrated


def test_sums_match_jax(renderers):
    jr, pr = renderers
    for name in ("col_sum", "nrm_sum", "alb_sum"):
        for a, b in zip(getattr(pr, name), getattr(jr, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for name in ("lum_sum", "lum2_sum", "dep_sum"):
        np.testing.assert_allclose(getattr(pr, name).numpy(), np.asarray(getattr(jr, name)),
                                   rtol=1e-5, atol=1e-5)


def test_images_match_jax(renderers):
    jr, pr = renderers
    np.testing.assert_allclose(pr.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
    got, want = pr.aovs(), jr.aovs()
    assert list(got) == list(want) == ["normal", "albedo", "depth"]
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pr.variance_image(), jr.variance_image(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pr.error_map(), jr.error_map(), rtol=1e-4, atol=1e-6)
    assert pr.error_map().shape == (jr.tiles_y, jr.tiles_x) == (3, 3)


def test_denoised_image_matches_jax(renderers):
    jr, pr = renderers
    got, want = pr.denoised_image(), jr.denoised_image()
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    got = pr.denoised_image(iterations=2, demodulate=False, sigma_color=1.0)
    want = jr.denoised_image(iterations=2, demodulate=False, sigma_color=1.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_area_light_is_not_ported():
    """The name dates from when the port raised for `area_light`. It now
    holds `AdaptiveRenderer(area_light=)` against the JAX one: the cornell
    golden scene under its quad light, three rounds, the sample map exact
    and the image to rtol / atol 1e-5."""
    from optixpathtracer_tpu.lights.lights import QuadLight as JaxQuadLight
    from optixpathtracer_tpu.lights.probe import build_probe as jax_build_probe
    from optixpathtracer_tpu_torch import scenes
    from tests.golden_scenes import _cornell_scene

    w, h = 32, 16
    view = dict(eye=(0, 1.5, 5.6), lookat=(0, 1.4, 0), up=(0, 1, 0), fov_y=45)
    cfg = dict(width=w, height=h, samples_per_launch=2, max_depth=2, emission_all_bounces=True,
               sort_rays=True)
    jcs = jax_compile(_cornell_scene(), cluster_size=128, build_wide_bvh=False)
    jr = jad.AdaptiveRenderer(jcs, jax_build_probe(np.full((8, 16, 3), 1e-6, np.float32)),
                              JaxConfig(traversal="lockstep", **cfg), JaxCamera(aspect_ratio=w / h, **view),
                              area_light=JaxQuadLight.make(corner=(-0.5, 2.96, -0.5), v1=(1.0, 0, 0),
                                                           v2=(0, 0, 1.0), emission=(15.0, 13.0, 10.0)))
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pr = tad.AdaptiveRenderer(pcs, scenes.dark_probe(CPU), RenderConfig(traversal="cluster", **cfg),
                              Camera(aspect_ratio=w / h, **view), area_light=scenes.cornell_light(CPU))
    for r in (jr, pr):
        r.render_n(3)
    np.testing.assert_array_equal(pr.sample_map(), jr.sample_map())
    np.testing.assert_allclose(pr.accum_image(), jr.accum_image(), rtol=1e-5, atol=1e-5)
