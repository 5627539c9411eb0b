"""Sample warping library (port of optixpathtracer_tpu/core/sampling.py):
the warps of uniforms to directions, the stratified and jittered-grid draws
and the MIS heuristics, batched over the leading shape, and the host-side
blue-noise point sets of the `sampling="blue"` strategy (numpy, the same
table as the reference for the same seed)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .math import TWO_PI, Vec3
from .rng import RngState, randf, randf2

Tensor = torch.Tensor


def uniform_sample_sphere(u1: Tensor, u2: Tensor) -> Vec3:
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_sample_hemisphere(u1: Tensor, u2: Tensor) -> Vec3:
    """z in [0,1), pdf = 1/(2*pi). (maths.h:241-252 draws z directly.)"""
    z = u1
    w = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return Vec3(torch.cos(phi) * w, torch.sin(phi) * w, z)


def uniform_sample_disc(u1: Tensor, u2: Tensor) -> Tuple[Tensor, Tensor]:
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def uniform_sample_triangle(u1: Tensor, u2: Tensor) -> Tuple[Tensor, Tensor]:
    r = torch.sqrt(u1)
    return 1.0 - r, u2 * r


def cosine_sample_hemisphere(u1: Tensor, u2: Tensor) -> Vec3:
    """pdf = cos(theta)/pi."""
    x, y = uniform_sample_disc(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return Vec3(x, y, z)


def _cell(c: Tensor, dx: int, dy: int) -> Tuple[Tensor, Tensor]:
    """Cell (x, y) of sample index c in a dx x dy grid, as float32."""
    return (c % dx).to(torch.float32), ((c // dx) % dy).to(torch.float32)


def stratified_sample_1d(c: Tensor, dx: int, state: RngState) -> Tuple[RngState, Tensor]:
    state, j = randf(state)
    return state, ((c % dx).to(torch.float32) + j) / dx


def stratified_sample_2d(c: Tensor, dx: int, dy: int,
                         state: RngState) -> Tuple[RngState, Tensor, Tensor]:
    x, y = _cell(c, dx, dy)
    state, j1, j2 = randf2(state)
    return state, (x + j1) / dx, (y + j2) / dy


def uniform_grid_sample_2d(c: Tensor, dx: int, dy: int) -> Tuple[Tensor, Tensor]:
    x, y = _cell(c, dx, dy)
    return x / dx, y / dy


def best_candidate_blue_noise(n_points: int, dim: int = 2, candidates: int = 16,
                              seed: int = 0) -> np.ndarray:
    """Host-side best-candidate blue-noise point set (sample.h BestCandidate
    :80-131 semantics): each point is the candidate farthest (toroidal) from
    the existing set. Returns (n_points, dim) float32 in [0, 1)."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n_points, dim), np.float32)
    pts[0] = rng.random(dim)
    for i in range(1, n_points):
        cand = rng.random((candidates, dim)).astype(np.float32)
        delta = np.abs(cand[:, None, :] - pts[None, :i, :])
        delta = np.minimum(delta, 1.0 - delta)  # toroidal wrap
        d = (delta**2).sum(-1).min(axis=1)
        pts[i] = cand[int(d.argmax())]
    return pts


def projective_blue_noise(n_points: int, dim: int = 2, candidates: int = 16,
                          seed: int = 0) -> np.ndarray:
    """Projective variant (sample.h ProjectiveBlueNoise :133-214): candidates
    maximise the minimum over the full-D distance and each 1-D projection."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n_points, dim), np.float32)
    pts[0] = rng.random(dim)
    for i in range(1, n_points):
        cand = rng.random((candidates, dim)).astype(np.float32)
        delta = np.abs(cand[:, None, :] - pts[None, :i, :])
        delta = np.minimum(delta, 1.0 - delta)
        full = (delta**2).sum(-1).min(axis=1) / dim
        proj = (delta**2).min(axis=1).min(axis=-1)  # worst 1-D projection
        pts[i] = cand[int(np.minimum(full, proj).argmax())]
    return pts


def power_heuristic(nf: Tensor, f_pdf: Tensor, ng: Tensor, g_pdf: Tensor) -> Tensor:
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)


def balance_heuristic(nf: Tensor, f_pdf: Tensor, ng: Tensor, g_pdf: Tensor) -> Tensor:
    """The reference's MIS weight shape (deviceProgram.cu:279-287)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return f / torch.clamp(f + g, min=1e-20)
