"""ROADMAP C.9's repairs, on the CPU: each keeps the CPU's result (the one
held to JAX) and takes a form the card computes alike (the card side is
tests/test_torch_cuda_kernels.py::test_c9_repaired_ops_card_equal_cpu):
- the foveated splat keeps one writer a pixel, the last lane in order, so
  a zone at the frame's clamped edge, where several lanes write one pixel,
  splats as the JAX package's sequential scatter does;
- the spectral hero sums add left to right, the CPU `torch.sum`'s order at
  that width.
The probe tables, now built on the host for every device, are held by
tests/test_torch_probe_disney.py as before."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.core import math as jm
from optixpathtracer_tpu.engine import foveated as jfov
from optixpathtracer_tpu.engine.wavefront import RenderConfig as JaxConfig
from optixpathtracer_tpu_torch.core import math as tm
from optixpathtracer_tpu_torch.core import spectrum
from optixpathtracer_tpu_torch.engine import foveated
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig


@pytest.mark.parametrize("subframe", [0, 3])
def test_splat_at_the_clamped_edge_equals_jax(subframe):
    """A 4x4-block zone whose lanes reach past the frame's right and top
    edges: the clamp sends up to 16 writes to one pixel."""
    w, h, n = 10, 6, 12
    zone = foveated.FoveationZone("ring", 4, 2, 0.0, 1e9, subframe == 0, 3, 4, False)
    jzone = jfov.FoveationZone("ring", 4, 2, 0.0, 1e9, subframe == 0, 3, 4, False)
    r = np.random.default_rng(0)
    px = r.integers(4, w + 3, n).astype(np.int32)
    py = r.integers(2, h + 3, n).astype(np.int32)
    active = r.random(n) < 0.8
    accum = r.random((3, w * h)).astype(np.float32)
    col = (r.random((3, n)) * 4).astype(np.float32)
    got = foveated._splat_zone(RenderConfig(width=w, height=h), zone, torch.as_tensor(px), torch.as_tensor(py),
                               torch.as_tensor(active), tm.Vec3(*(torch.as_tensor(a) for a in accum)),
                               tm.Vec3(*(torch.as_tensor(c) for c in col)), subframe)
    want = jfov._splat_zone(JaxConfig(width=w, height=h), jzone, jnp.asarray(px), jnp.asarray(py),
                            jnp.asarray(active), jm.Vec3(*(jnp.asarray(a) for a in accum)),
                            jm.Vec3(*(jnp.asarray(c) for c in col)), jnp.uint32(subframe))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_hero_sums_left_to_right_equal_torch_sum():
    x = torch.rand(6144, spectrum.N_HERO, generator=torch.Generator().manual_seed(0)) * 50
    assert torch.equal(spectrum._sum_last(x), torch.sum(x, dim=-1))
