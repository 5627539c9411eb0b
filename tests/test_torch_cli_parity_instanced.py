"""Port parity, the command line's `--instanced` glTF image: the `gltf`
golden's .glb (one mesh, two nodes) through `python -m
optixpathtracer_tpu_torch render --device cpu --instanced` (the TLAS) and
through the JAX package's `render --traversal cluster --instanced`: PNGs
within 1 per 8-bit channel, mean absolute difference under 0.05 (the
check of tests/test_torch_cli_parity.py).
"""
import torch

from optixpathtracer_tpu_torch import scenes
from tests.test_torch_cli_parity import cli_images_equal_to_jax

torch.set_num_threads(1)


def test_cli_instanced_gltf_image_equal_to_jax(tmp_path, monkeypatch):
    glb = tmp_path / "golden.glb"
    glb.write_bytes(scenes.golden_glb())
    cli_images_equal_to_jax(tmp_path, monkeypatch, ["--scene", str(glb), "--instanced", "--eye", "3",
                                                    "2.5", "3", "--fov-y", "45"])
