"""optixpathtracer_tpu_torch — the PyTorch + CUDA port of optixpathtracer_tpu.

The JAX package `optixpathtracer_tpu` is the reference: every module here
mirrors the module of the same path there and is held against it by the
`tests/test_torch_*.py` parity tests. Plain tensor code is PyTorch; the
three Pallas cluster-traversal kernels on the main path are hand-written
CUDA C++ for Hopper (`csrc/traverse_cluster.cu`), each with a plain PyTorch
version beside it that runs on CPU tensors.

Devices are explicit: functions that create tensors take a `device`
argument, everything else follows the device of its inputs. There is no
"cuda if available" fallback anywhere on the main path.

This package imports torch and never jax.
"""
import torch

# f32 exactness: the M-T and shading math must not drop to TF32 anywhere
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
