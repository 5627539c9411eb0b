"""Port parity, engine/wavefront: the coherence key, the stable sort order,
`permute_packed`, accumulation, tone mapping and one `trace_wavefront`
launch on the open golden scene, against the JAX package.

Keys, permutations and packed moves are bit-exact. A launch's radiance sums
agree to rtol 1e-4: the same RNG streams drive both engines, and only the
shading math's ulp-level differences (different sin/cos/pow/rsqrt) remain.
The JAX side traces with its exact lockstep backend; the port with its
cluster backend (both exact, tests/test_torch_traverse_cluster.py), and
each other backend against the JAX engine's own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.engine import wavefront as jwf
from optixpathtracer_tpu.ops import tonemap as jtm
from optixpathtracer_tpu_torch import interop, scenes
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.engine import wavefront as twf
from optixpathtracer_tpu_torch.ops import tonemap as ttm
from tests.golden_scenes import _cam_s, _open_scene, _sky_probe

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _vecs(a):
    return (JVec3(*(jnp.asarray(a[:, i]) for i in range(3))),
            Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(3))))


def test_spread3_and_coherence_key_bit_exact():
    rng = np.random.default_rng(0)
    n = 4096
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)  # some outside the box
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:64] = 0.0  # degenerate and signed-zero directions
    d[:32] *= -1.0
    done = rng.random(n) < 0.3
    aabb = np.array([-8, -0.2, -8, 8, 2, 8, 0, 0], np.float32)
    (jo, to), (jd, td) = _vecs(o), _vecs(d)
    want = np.asarray(jwf._coherence_key(jo, jd, jnp.asarray(done), jnp.asarray(aabb)))
    got = twf._coherence_key(to, td, torch.as_tensor(done), torch.as_tensor(aabb)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and ((got >> 31) == done).all()  # dead bit set, key non-negative
    x = rng.integers(0, 2**12, n)
    np.testing.assert_array_equal(
        twf._spread3(torch.as_tensor(x)).numpy(),
        np.asarray(jwf._spread3(jnp.asarray(x.astype(np.uint32)))))


def test_stable_sort_order_matches_lax_sort():
    rng = np.random.default_rng(1)
    n = 5000
    # heavy ties, and dead rays (bit 31) that must sort last, not first
    key = rng.integers(0, 16, n).astype(np.uint32) << np.uint32(20)
    key |= (rng.random(n) < 0.4).astype(np.uint32) << np.uint32(31)
    _, want = jax.lax.sort([jnp.asarray(key), jax.lax.iota(jnp.uint32, n)], num_keys=1)
    got = twf._stable_argsort(torch.as_tensor(key.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_permute_packed_exact_for_every_dtype():
    rng = np.random.default_rng(2)
    n = 257
    perm = rng.permutation(n)
    f = (rng.standard_normal(n) * 1e30).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, -0.0] * 65, np.float32)[:n]
    b = rng.integers(0, 2, n).astype(bool)
    i = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    u = rng.integers(0, 2**32, n, dtype=np.uint64)  # uint32 words held in int64
    leaves = [torch.as_tensor(x) for x in (f, special, b, i, u.astype(np.int64))]
    out = twf.permute_packed(leaves, torch.as_tensor(perm))
    np.testing.assert_array_equal(out[0].numpy(), f[perm])
    np.testing.assert_array_equal(out[1].numpy().view(np.uint32), special.view(np.uint32)[perm])
    np.testing.assert_array_equal(out[2].numpy(), b[perm])
    np.testing.assert_array_equal(out[3].numpy(), i[perm])
    np.testing.assert_array_equal(out[4].numpy(), u.astype(np.int64)[perm])
    for o, src in zip(out, leaves):
        assert o.dtype == src.dtype
    jout = jwf.permute_packed([jnp.asarray(u.astype(np.uint32))], jnp.asarray(perm))
    np.testing.assert_array_equal(out[4].numpy().astype(np.uint32), np.asarray(jout[0]))


def test_accumulate_matches_reference():
    rng = np.random.default_rng(3)
    prev, new = (rng.random((3, 512)).astype(np.float32) * 8 for _ in range(2))
    for sub in (0, 1, 5):
        want = jwf.accumulate(JVec3(*map(jnp.asarray, prev)), JVec3(*map(jnp.asarray, new)),
                              jnp.uint32(sub), 4, 10.0)
        got = twf.accumulate(Vec3(*map(torch.as_tensor, prev)), Vec3(*map(torch.as_tensor, new)),
                             sub, 4, 10.0)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["none", "sqrt", "reinhard"])
def test_tonemap_matches_reference(mode):
    rng = np.random.default_rng(4)
    c = (rng.random((3, 4096)) ** 3 * 3).astype(np.float32)
    want = jtm.finalize(JVec3(*map(jnp.asarray, c)), mode=mode, exposure_stops=0.5)
    got = ttm.finalize(Vec3(*map(torch.as_tensor, c)), mode=mode, exposure_stops=0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    x = np.linspace(-0.5, 1.5, 4099).astype(np.float32)
    np.testing.assert_array_equal(ttm.quantize_u8(torch.as_tensor(x)).numpy(),
                                  np.asarray(jtm.quantize_u8(jnp.asarray(x))))
    packed = ttm.pack_rgba8(Vec3(*map(torch.as_tensor, c)))
    assert packed.shape == (4096, 4) and (packed[:, 3] == 255).all()


def test_render_config_fields_and_defaults_match_reference():
    mine = {f.name: f.default for f in dataclasses.fields(twf.RenderConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jwf.RenderConfig)}
    assert mine == ref


@pytest.mark.parametrize("option, item", [
    (dict(traversal="lockstep"), "not to port"), (dict(traversal="bfs"), "not to port"),
    (dict(traversal="dense"), "not to port"), (dict(traversal="oracle"), "not to port"),
    (dict(traversal="bfs", fused_shadows=True, env_via_bsdf=True, nee_rr=0.1), "not to port"),
])
def test_off_slice_options_raise(option, item):
    """Each backend the port used not to carry (`item` names the old
    refusal) now runs one launch on the open golden scene, equal to the
    JAX engine's launch on the same backend (each package compiles the
    scene with its LBVH, wide BVH and clusters): the BFS overflow equal, the
    sums to rtol 1e-4 as above, rays traced equal. Under `nee_rr=0.1` one
    path of the 128 (lane 38) parts at its second bounce between the port
    and the JAX engine, eager or jitted, on every backend the lockstep
    walk included (its depth-2 NEE luminance reads 0.236 here, 1.99
    there): the shading math's ulp-level differences (ROADMAP C, "BSDF
    parity tolerance") move a draw across its threshold, so there the
    rays traced may differ by that path's one shadow ray."""
    del item
    w, h = 16, 8
    jcs = jax_compile(_open_scene(), cluster_size=128)
    pcs = compile_scene(scenes.open_scene(), CPU, cluster_size=128)
    base = dict(width=w, height=h, samples_per_launch=1, max_depth=2, **option)
    cam = _cam_s((3.2, 2.2, 4.0), (0, 0.4, 0))
    xs, ys = _pixels(w, h)
    want = jwf.trace_wavefront(jcs, _sky_probe(), jwf.RenderConfig(**base),
                               jwf.CameraParams.from_camera(cam),
                               jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy()), jnp.uint32(1))
    got = twf.trace_wavefront(pcs, scenes.sky_probe(CPU), twf.RenderConfig(**base),
                              twf.CameraParams.from_camera(cam, CPU), xs, ys, 1)
    assert abs(int(got.rays_traced) - int(want.rays_traced)) <= (1 if "nee_rr" in option else 0)
    assert float(got.bfs_overflow) == float(want.bfs_overflow)
    for field in ("color", "alpha", "normal", "albedo"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                       err_msg=field)
    assert float(got.color.x.sum()) > 0


def test_backends_launch_bit_identical_in_the_port():
    """The lockstep walk, the BFS walk (no overflow), the dense scan and the
    oracle keep the same triangles with the same Möller–Trumbore arithmetic
    on the open scene, so one launch through each is bit for bit the same."""
    w, h = 16, 8
    pcs = compile_scene(scenes.open_scene(), CPU, cluster_size=128)
    cam = twf.CameraParams.from_camera(_cam_s((3.2, 2.2, 4.0), (0, 0.4, 0)), CPU)
    xs, ys = _pixels(w, h)
    outs = {}
    for tr in ("lockstep", "bfs", "dense", "oracle"):
        cfg = twf.RenderConfig(width=w, height=h, samples_per_launch=2, max_depth=3, traversal=tr,
                               bfs_cap_factor=16, fused_shadows=True)
        outs[tr] = twf.trace_wavefront(pcs, scenes.sky_probe(CPU), cfg, cam, xs, ys, 2)
    assert float(outs["bfs"].bfs_overflow) == 0.0
    for tr in ("bfs", "dense", "oracle"):
        assert int(outs[tr].rays_traced) == int(outs["lockstep"].rays_traced), tr
        for a, b in zip(outs[tr].color, outs["lockstep"].color):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=tr)


def _open_port():
    return compile_scene(scenes.open_scene(), CPU)


def _pixels(w, h):
    ys, xs = np.divmod(np.arange(w * h, dtype=np.int32), w)
    return torch.as_tensor(xs), torch.as_tensor(ys)


FLAGS = {
    "bench": dict(sort_rays=True, batch_spp=True, nee_final_bounce=False),
    "defaults": dict(),
    "roulette_all_emission": dict(russian_roulette=True, emission_all_bounces=True,
                                  use_shading_normals=True),
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_trace_wavefront_one_launch(flags):
    w, h = 16, 8
    jcs = jax_compile(_open_scene(), cluster_size=128, build_wide_bvh=False)
    jprobe = _sky_probe()
    # identical scene state on both sides
    pcs = interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)
    pprobe = interop.probe_from_arrays(interop.probe_arrays(jprobe), CPU)
    base = dict(width=w, height=h, samples_per_launch=2, max_depth=3, **FLAGS[flags])
    jcfg = jwf.RenderConfig(traversal="lockstep", **base)
    tcfg = twf.RenderConfig(traversal="cluster", **base)
    cam = _cam_s((3.2, 2.2, 4.0), (0, 0.4, 0))
    xs, ys = _pixels(w, h)
    want = jwf.trace_wavefront(jcs, jprobe, jcfg, jwf.CameraParams.from_camera(cam),
                               jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy()), jnp.uint32(3))
    got = twf.trace_wavefront(pcs, pprobe, tcfg, twf.CameraParams.from_camera(cam, CPU),
                              xs, ys, 3)
    assert int(got.rays_traced) == int(want.rays_traced)
    for field in ("color", "alpha", "normal", "albedo"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                       err_msg=field)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-4, atol=1e-5)
    assert float(got.color.x.sum()) > 0
