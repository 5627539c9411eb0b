"""Port parity, ops/dispatch: `trace_closest` and `trace_occluded` over the
cluster walk against the JAX package's (its Pallas kernels in interpret
mode) on tests/test_dispatch.py's scene, carried across with `interop`;
the lockstep, BFS and dense backends against the JAX package's on the same
scene built by each package; the presets trace through `ops.dispatch`,
never a backend of their own.

Tolerances: winning triangles and occlusion bit-exact; cluster walk: t
within 1e-6 relative to max(1, |t|), u / v within 1e-5
(tests/test_traverse_cluster.py); the other backends: the reference tests'
own (tests/torch_backend_cases.py), and bit for bit where the JAX backend
runs eagerly (BFS).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.materials import make_material
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.core.scene import HostScene
from optixpathtracer_tpu.ops import dispatch as jdispatch
from optixpathtracer_tpu_torch import interop
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.ops import dispatch

torch.set_num_threads(1)
CPU = torch.device("cpu")
PKG = pathlib.Path(__file__).resolve().parents[1] / "optixpathtracer_tpu_torch"
N = 128


@pytest.fixture(scope="module")
def scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(5, 0.1, 5))
    hs.add_box(make_material(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    jcs = jax_compile(hs, cluster_size=64, build_wide_bvh=False)
    return jcs, interop.compiled_scene_from_arrays(interop.compiled_scene_arrays(jcs), CPU)


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 3, N)
    d = rng.normal(0, 1, (N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ((JVec3(*(jnp.asarray(o[:, i]) for i in range(3))), JVec3(*(jnp.asarray(d[:, i]) for i in range(3)))),
            (Vec3(*(torch.as_tensor(o[:, i].copy()) for i in range(3))),
             Vec3(*(torch.as_tensor(d[:, i].copy()) for i in range(3)))))


def test_default_traversal_is_the_cluster_walk(scene):
    """The cluster walk on a CUDA device, the lockstep walk on a CPU (the
    reference's platform rule), and the scoped default in between."""
    from types import SimpleNamespace

    card = SimpleNamespace(device=torch.device("cuda"), clusters=scene[1].clusters)
    assert dispatch.default_traversal(card) == "cluster"
    assert dispatch.default_traversal(scene[1]) == "lockstep"
    with dispatch.default_backend("bfs"):
        assert dispatch.default_traversal(card) == "bfs"
    assert dispatch.default_traversal(card) == "cluster"


def test_trace_closest_equal_to_jax(scene):
    jcs, pcs = scene
    (jo, jd), (to, td) = _rays(3)
    want = jdispatch.trace_closest(jcs, jo, jd, 1e-3, 1e16, traversal="cluster")
    got = dispatch.trace_closest(pcs, to, td, 1e-3, 1e16, traversal="cluster")
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    hit = got.hit.numpy()
    assert 0.3 < hit.mean() < 1.0
    t, tw = got.t.numpy()[hit].astype(np.float64), np.asarray(want.t)[hit]
    assert (np.abs(t - tw) / np.maximum(1.0, np.abs(tw))).max() <= 1e-6
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-5)


def test_trace_occluded_equal_to_jax(scene):
    jcs, pcs = scene
    (jo, jd), (to, td) = _rays(7)
    t_max = np.where(np.arange(N) % 3 == 0, 8.0, 0.5).astype(np.float32)
    want = jdispatch.trace_occluded(jcs, jo, jd, 1e-2, jnp.asarray(t_max), traversal="cluster")
    got = dispatch.trace_occluded(pcs, to, td, 1e-2, torch.as_tensor(t_max), traversal="cluster")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 1


@pytest.fixture(scope="module")
def built():
    """tests/test_dispatch.py's scene compiled by each package, with the
    LBVH and the wide BVH (interop carries the clusters only)."""
    from optixpathtracer_tpu_torch.builder import compile_scene
    from optixpathtracer_tpu_torch.core.materials import make_material as tmake
    from optixpathtracer_tpu_torch.core.scene import HostScene as THost

    jhs, ths = HostScene(), THost()
    for h, mk in ((jhs, make_material), (ths, tmake)):
        h.add_box(mk(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(5, 0.1, 5))
        h.add_box(mk(color=(0.7, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    return jax_compile(jhs, cluster_size=64), compile_scene(ths, CPU, cluster_size=64)


@pytest.mark.parametrize("traversal", ["lockstep", "bfs", "dense"])
@pytest.mark.parametrize("entry", ["trace_closest", "trace_occluded"])
def test_backends_not_carried_raise(built, traversal, entry):
    """Each backend the port used not to carry now runs, through the same
    entry point, equal to the JAX package's on the same rays."""
    from tests.torch_backend_cases import assert_records_equal

    jcs, pcs = built
    (jo, jd), (to, td) = _rays(3)
    args = (1e-3, 1e16) if entry == "trace_closest" else (1e-2, 8.0)
    got = getattr(dispatch, entry)(pcs, to, td, *args, traversal=traversal)
    want = getattr(jdispatch, entry)(jcs, jo, jd, *args, traversal=traversal)
    if entry == "trace_occluded":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got.numpy().mean() < 1
    else:
        assert_records_equal(got, want, exact_floats=traversal == "bfs")
        assert 0.3 < got.hit.numpy().mean() < 1.0


def test_presets_do_not_hardwire_backends():
    """tests/test_dispatch.py's rule in the port: the presets reach the
    cluster walk through ops.dispatch."""
    for rel in ("models/hello_raytracing.py", "models/whitted.py", "engine/whitted.py"):
        assert "ops.traverse_cluster import" not in (PKG / rel).read_text(), rel
    for rel in ("models/hello_raytracing.py", "engine/whitted.py"):
        assert "ops.dispatch import" in (PKG / rel).read_text(), rel
