"""Port parity, the command line's images: `python -m
optixpathtracer_tpu_torch render --device cpu ...` and the JAX package's
`render --traversal cluster ...` (its CPU default is the lockstep backend)
on the same 48x32 `disney_pt` command over the procedural boxes write PNGs
within 1 per 8-bit channel everywhere, with a mean absolute difference
under 0.05. The `--instanced` glTF command is compared in
tests/test_torch_cli_parity_instanced.py (each JAX CLI render compiles its
Pallas kernels in interpret mode, ~20 s on one CPU thread).
"""
import numpy as np
import torch
from PIL import Image

from optixpathtracer_tpu import cli as jcli
from optixpathtracer_tpu_torch import cli

torch.set_num_threads(1)
SMALL = ["--width", "48", "--height", "32", "--spp", "2", "--max-depth", "2"]


def cli_images_equal_to_jax(tmp_path, monkeypatch, extra_argv):
    """Both command lines on `SMALL + extra_argv`; their PNGs agree."""
    monkeypatch.setenv("OPTIX_TPU_NO_NATIVE", "1")  # the reference's numpy treelet order
    argv = [*SMALL, "--traversal", "cluster", *extra_argv]
    imgs = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = tmp_path / f"{name}.png"
        assert main(["render", *argv, *extra, "--out", str(out)]) == 0
        imgs.append(np.asarray(Image.open(out), np.int16))
    got, want = imgs
    assert got.shape == want.shape == (32, 48, 4) and want[..., :3].std() > 1
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - want).mean() < 0.05


def test_cli_images_equal_to_jax(tmp_path, monkeypatch):
    cli_images_equal_to_jax(tmp_path, monkeypatch, [])
