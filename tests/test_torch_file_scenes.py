"""Port parity, scenes from files end to end: the goldens of the textured
loft (scenes/loft.obj), of the cornell box under its quad light and of the
glTF ingest rendered by the port on the CPU against the committed goldens
(sqrt-space RMSE 2e-3, tests/test_goldens.py), and the loft loaded and
rendered in a process that never imports jax, the JAX package or PIL.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from optixpathtracer_tpu_torch import scenes

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMSE_TOL = 2e-3
GOLDENS = {
    **{n: lambda n=n: scenes.render_cornell_golden(n, CPU) for n in scenes.CORNELL_GOLDENS},
    **{n: lambda n=n: scenes.render_loft_golden(n, CPU) for n in scenes.LOFT_GOLDENS},
    "gltf": lambda: scenes.render_gltf_golden(CPU),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name):
    want = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz"))["image"]
    got = GOLDENS[name]()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert scenes.golden_rmse(got, want) <= RMSE_TOL


def test_loft_runs_without_jax_or_pil():
    code = textwrap.dedent("""
        import sys, numpy as np, torch
        torch.set_num_threads(1)
        from optixpathtracer_tpu_torch import scenes
        from optixpathtracer_tpu_torch.builder import compile_scene
        from optixpathtracer_tpu_torch.io.obj import load_obj
        from optixpathtracer_tpu_torch.models import make_disney_pt_renderer
        dev = torch.device("cpu")
        hs = load_obj(scenes.LOFT_OBJ)
        assert len(hs.textures) == 3
        cs = compile_scene(hs, dev, cluster_size=256)
        setup = scenes.loft_config(16, 8, dev)
        r = make_disney_pt_renderer(cs, setup.probe, setup.camera, width=16, height=8, spp=1,
                                    max_depth=2, **setup.flags)
        img = r.render()
        acc = r.accum_image()
        assert img.shape == (8, 16, 4) and np.isfinite(acc).all() and acc.max() > 0
        print(*(m in sys.modules for m in ("jax", "optixpathtracer_tpu", "PIL")))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]
