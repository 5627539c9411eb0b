"""BSDF visualization harness — lobe images + sample splats (port of
optixpathtracer_tpu/shade/bsdf_vis.py).

The reference's (commented-out) BSDFTest (HelloPathtracing_original/
Disney.cuh:430-503): for a fixed outgoing direction wo, a lat-long
(probe-UV) image whose pixels hold (f.x, pdf, 0.5) for the incoming
direction wi at that UV, with N BSDF-sampled directions splatted as pure red
pixels: red dots should gather where the green (pdf) channel is bright. The
image is one batched bsdf_eval / bsdf_pdf over every direction and the
splat one index_add. Each function runs on `device` ("cuda" unless the
caller asks for the CPU) and returns numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.materials import build_table, make_material
from ..core.math import Vec3, basis_from_vector
from ..core.rng import RngState, tea
from ..lights.probe import dir_to_uv, uv_to_dir
from . import disney


def _setup(material: dict, wo_theta: float, normal, n: int, device):
    """n copies of the material, the unit normal, its basis and wo (at
    wo_theta from the normal, in the (u, v, n) frame: (0, -sin, cos))."""
    mat = build_table([material], device).take(torch.zeros(n, dtype=torch.int64, device=device))
    n_np = np.asarray(normal, np.float32)
    n_np = n_np / np.linalg.norm(n_np)
    nv = Vec3(*(torch.full((n,), float(c), dtype=torch.float32, device=device) for c in n_np))
    tb, bb = basis_from_vector(nv)
    st, ct = float(np.sin(wo_theta)), float(np.cos(wo_theta))
    wo = Vec3(-st * bb.x + ct * nv.x, -st * bb.y + ct * nv.y, -st * bb.z + ct * nv.z)
    return mat, nv, tb, bb, wo


def bsdf_maps(material: dict, wo_theta: float = np.pi / 2.05, width: int = 512,
              height: int = 256, normal=(1.0, 0.0, 0.0), device="cuda"):
    """Dense lobe maps over the lat-long sphere of incoming directions:
    (f_img, pdf_img), two (height, width) float32 arrays holding the BSDF's
    first channel and its solid-angle pdf for every wi (Disney.cuh:446-484)."""
    device = torch.device(device)
    npix = width * height
    mat, nv, _, _, wo = _setup(material, wo_theta, normal, npix, device)
    ii, jj = np.meshgrid(np.arange(width), np.arange(height))
    u = torch.as_tensor(((ii.ravel() + 0.5) / width).astype(np.float32), device=device)
    v = torch.as_tensor(((jj.ravel() + 0.5) / height).astype(np.float32), device=device)
    wi = uv_to_dir(u, v)
    eta = torch.ones((npix,), dtype=torch.float32, device=device)
    f = disney.bsdf_eval(mat, mat.color, eta, eta, nv, wo, wi)
    pdf = disney.bsdf_pdf(mat, eta, eta, nv, wo, wi)
    return (f.x.cpu().numpy().reshape(height, width), pdf.cpu().numpy().reshape(height, width))


def bsdf_sample_splat(material: dict, wo_theta: float = np.pi / 2.05, width: int = 512,
                      height: int = 256, n_samples: int = 1000, normal=(1.0, 0.0, 0.0),
                      seed: int = 0, device="cuda"):
    """(height, width) int32 histogram of where n_samples BSDF samples land
    on the same lat-long grid (the reference splats them as red dots,
    Disney.cuh:485-501). Sample i draws from tea(i, seed)."""
    device = torch.device(device)
    mat, nv, tb, bb, wo = _setup(material, wo_theta, normal, n_samples, device)
    eta = torch.ones((n_samples,), dtype=torch.float32, device=device)
    ids = torch.arange(n_samples, dtype=torch.int64, device=device)
    state = RngState.seed(tea(ids, torch.full_like(ids, int(seed) & 0xFFFFFFFF)))
    _, res = disney.bsdf_sample(mat, eta, eta, tb, bb, nv, wo, state)
    valid = res.pdf > 0.0
    u, v = dir_to_uv(res.light)
    px = torch.clamp((u * width).to(torch.int32), 0, width - 1)
    py = torch.clamp((v * height).to(torch.int32), 0, height - 1)
    flat = (py * width + px).to(torch.int64)
    hist = torch.zeros((height * width,), dtype=torch.int32, device=device)
    hist.index_add_(0, flat, valid.to(torch.int32))
    return hist.cpu().numpy().reshape(height, width)


def bsdf_test_image(material: dict | None = None, wo_theta: float = np.pi / 2.05,
                    width: int = 512, height: int = 256, n_samples: int = 1000,
                    normal=(1.0, 0.0, 0.0), seed: int = 0, device="cuda") -> np.ndarray:
    """The reference's BSDFTest composite: (f.x, pdf, 0.5) per pixel, with
    sampled directions overwritten as (1, 0, 0); (H, W, 3) float32. The
    default material is the reference's example block (Disney.cuh:433-443):
    near-white, specular 1.0, roughness 0.025."""
    if material is None:
        material = make_material(color=(0.95, 0.9, 0.9), specular=1.0, roughness=0.025,
                                 metallic=0.0)
    f_img, pdf_img = bsdf_maps(material, wo_theta, width, height, normal, device)
    hist = bsdf_sample_splat(material, wo_theta, width, height, n_samples, normal, seed, device)
    img = np.stack([f_img, pdf_img, np.full_like(f_img, 0.5)], axis=-1).astype(np.float32)
    img[hist > 0] = (1.0, 0.0, 0.0)
    return img
