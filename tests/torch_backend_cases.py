"""Shared inputs of the traversal-backend parity tests: the reference
tests' random triangle soups and rays, built from one seed as a port and a
JAX scene of the same triangles."""
import numpy as np
import torch

import jax.numpy as jnp
from optixpathtracer_tpu.builder import compile_scene as jax_compile
from optixpathtracer_tpu.core.materials import make_material as jmake
from optixpathtracer_tpu.core.math import Vec3 as JVec3
from optixpathtracer_tpu.core.scene import HostScene as JHost, Mesh as JMesh
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.math import Vec3
from optixpathtracer_tpu_torch.core.scene import HostScene, Mesh

CPU = torch.device("cpu")


def soup(rng, n_tris=200, scale=2.0, edge=0.15):
    """(port HostScene, JAX HostScene) of one random triangle soup."""
    c = (rng.random((n_tris, 3)) * scale - scale / 2).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * edge
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * edge
    verts = np.concatenate([c, c + e1, c + e2]).astype(np.float32)
    idx = np.stack([np.arange(n_tris), np.arange(n_tris) + n_tris,
                    np.arange(n_tris) + 2 * n_tris], axis=1).astype(np.int32)
    hs, jhs = HostScene(), JHost()
    hs.add_mesh(Mesh(vertices=verts, indices=idx, material=make_material()))
    jhs.add_mesh(JMesh(vertices=verts, indices=idx, material=jmake()))
    return hs, jhs


def compiled(pair, **kw):
    """Both packages' CompiledScene of a `soup` pair, same parameters."""
    hs, jhs = pair
    return compile_scene(hs, CPU, **kw), jax_compile(jhs, **kw)


def rays(rng, n, spread=6.0, aim=1.0):
    """(port (o, d), JAX (o, d)) of n rays from the cube of side `spread`,
    unit directions: towards a random point of the cube of side `aim`
    (the soup's), or random where aim is 0."""
    o = (rng.random((n, 3)) * spread - spread / 2).astype(np.float32)
    if aim:
        d = (rng.random((n, 3)) * aim - aim / 2 - o).astype(np.float32)
    else:
        d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ((Vec3(*(torch.as_tensor(o[:, k]) for k in range(3))),
             Vec3(*(torch.as_tensor(d[:, k]) for k in range(3)))),
            (JVec3(*(jnp.asarray(o[:, k]) for k in range(3))),
             JVec3(*(jnp.asarray(d[:, k]) for k in range(3)))))


def assert_records_equal(got, want, exact_floats=True):
    """`tri` bit for bit; t/u/v bit for bit, or on hits within the
    reference tests' own tolerances (t: rtol 1e-4, atol 1e-5, as
    tests/test_traverse.py; u, v: atol 1e-3, as tests/test_traverse_bfs.py)
    and bit for bit on misses."""
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    hit = np.asarray(want.tri) >= 0
    for f in ("t", "u", "v"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if exact_floats:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            tol = dict(rtol=1e-4, atol=1e-5) if f == "t" else dict(rtol=0, atol=1e-3)
            np.testing.assert_allclose(a[hit], b[hit], err_msg=f, **tol)
            np.testing.assert_array_equal(a[~hit], b[~hit], err_msg=f)


def reference_native_libs():
    """Load the JAX package's native libraries (accel, objparser). Its own
    test modules call `get_lib()` while pytest collects them, in every
    xdist worker at once; a worker that met a library another worker was
    still writing keeps None for the rest of its process. Clear that and
    load the finished file, so the comparisons with the reference's native
    builds see them."""
    from optixpathtracer_tpu.bvh import native as jbn
    from optixpathtracer_tpu.io import native as jio

    for mod in (jbn, jio):
        if mod.get_lib() is None:
            mod._lib, mod._tried = None, False
            assert mod.get_lib() is not None, mod.__name__
