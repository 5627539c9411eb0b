"""HDR environment probe with 2D luminance-CDF importance sampling (port of
optixpathtracer_tpu/lights/probe.py).

The row and column searches are lower bounds — the count of CDF entries
`< r` — which is `torch.searchsorted(..., side="left")` on the
nondecreasing CDF tables. The tables come from `torch.cumsum`, which may
round in another order than XLA's cumsum, so they agree with the JAX
package's to a few ulp, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import INV_PI, PI, TWO_PI, Vec3, luminance
from ..core.rng import RngState, randf2

Tensor = torch.Tensor


class Probe(NamedTuple):
    """Device-resident probe (SoA image + sampling tables)."""

    r: Tensor  # (H, W) float32 radiance
    g: Tensor
    b: Tensor
    pdf_x: Tensor  # (H, W) conditional pdf of column given row
    cdf_x: Tensor  # (H, W) inclusive cdf per row
    pdf_y: Tensor  # (H,) marginal pdf of row
    cdf_y: Tensor  # (H,) inclusive cdf
    offset: Vec3  # world-space warp offset (Probe.h:15, unused by the apps)
    rgbp: Tensor  # (H*W, 4) rows [r, g, b, joint pdf]

    @property
    def width(self) -> int:
        return self.r.shape[1]

    @property
    def height(self) -> int:
        return self.r.shape[0]


def build_probe(image, device, offset=(0.0, 0.0, 0.0), gaussian_prefilter: bool = False) -> Probe:
    """BuildCDF equivalent: (H, W, 3) float32 HDR image -> Probe on `device`."""
    img = torch.as_tensor(np.asarray(image, np.float32), device=device)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    weight = luminance(Vec3(r, g, b))  # (H, W)
    if gaussian_prefilter:
        # 3x3 binomial, wrapping in longitude, clamping at the poles
        wx = torch.roll(weight, 1, dims=1) + 2.0 * weight + torch.roll(weight, -1, dims=1)
        up = torch.cat([wx[:1], wx[:-1]], dim=0)
        dn = torch.cat([wx[1:], wx[-1:]], dim=0)
        weight = (up + 2.0 * wx + dn) * (1.0 / 16.0)

    row_total = weight.sum(dim=1, keepdim=True)  # (H, 1)
    safe_row = torch.clamp(row_total, min=1e-20)
    pdf_x = weight / safe_row
    cdf_x = torch.cumsum(weight, dim=1) / safe_row

    col_weight = row_total[:, 0]
    total = torch.clamp(col_weight.sum(), min=1e-20)
    pdf_y = col_weight / total
    cdf_y = torch.cumsum(col_weight, dim=0) / total

    joint = pdf_x * pdf_y[:, None]
    rgbp = torch.stack([r.reshape(-1), g.reshape(-1), b.reshape(-1), joint.reshape(-1)], dim=1)
    return probe_from_tables(r, g, b, pdf_x, cdf_x, pdf_y, cdf_y, offset, rgbp)


def probe_from_tables(r, g, b, pdf_x, cdf_x, pdf_y, cdf_y, offset, rgbp) -> Probe:
    dev = r.device
    off = Vec3(*(torch.tensor(float(np.float32(c)), dtype=torch.float32, device=dev)
                 for c in offset))
    return Probe(r=r, g=g, b=b, pdf_x=pdf_x, cdf_x=cdf_x.contiguous(), pdf_y=pdf_y,
                 cdf_y=cdf_y.contiguous(), offset=off, rgbp=rgbp)


def dir_to_uv(d: Vec3) -> tuple[Tensor, Tensor]:
    """Lat-long mapping (Probe.cuh:38-46): theta from +Y, phi = atan2(z, x)."""
    theta = torch.acos(torch.clamp(d.y, -1.0, 1.0))
    phi = torch.where((d.x == 0.0) & (d.z == 0.0), 0.0, torch.atan2(d.z, d.x))
    u = (PI + phi) * INV_PI * 0.5
    v = theta * INV_PI
    return u, v


def uv_to_dir(u: Tensor, v: Tensor) -> Vec3:
    """Inverse mapping (Probe.cuh:48-58): note the negated x/z sin terms."""
    theta = v * PI
    phi = u * TWO_PI
    st = torch.sin(theta)
    return Vec3(-st * torch.cos(phi), torch.cos(theta), -st * torch.sin(phi))


def _texel(p: Probe, u: Tensor, v: Tensor) -> Tensor:
    x = torch.clamp((u * p.width).to(torch.int64), 0, p.width - 1)
    y = torch.clamp((v * p.height).to(torch.int64), 0, p.height - 1)
    return p.rgbp[y * p.width + x]


def probe_eval(p: Probe, u: Tensor, v: Tensor) -> Vec3:
    """Nearest-texel radiance lookup (ProbeEval, Probe.cuh:61-67)."""
    row = _texel(p, u, v)
    return Vec3(row[:, 0], row[:, 1], row[:, 2])


def probe_eval_dir(p: Probe, d: Vec3) -> Vec3:
    return probe_eval(p, *dir_to_uv(d))


def probe_pdf(p: Probe, d: Vec3) -> Tensor:
    """Solid-angle pdf of sampling direction d (ProbePdf, Probe.cuh:69-93)."""
    u, v = dir_to_uv(d)
    pdf = _texel(p, u, v)[:, 3]
    sin_theta = torch.sin(v * PI)
    scale = p.width * p.height / (2.0 * PI * PI * torch.clamp(sin_theta.abs(), min=1e-8))
    return torch.where(sin_theta.abs() < 1e-4, 0.0, pdf * scale)


def probe_sample_texel(p: Probe, state: RngState, u12=None):
    """probe_sample that also returns the chosen (row, col) texel.

    u12 (optional (u1, u2)): caller-supplied uniforms replacing the internal
    randf2 draw (the engine's low-discrepancy `sampling=` strategies). The
    state is not advanced then: the caller drew from the same stream."""
    if u12 is None:
        state, r1, r2 = randf2(state)
    else:
        r1, r2 = u12
    row = torch.searchsorted(p.cdf_y, r1, side="left")
    row = torch.clamp(row, 0, p.height - 1)
    col = torch.searchsorted(p.cdf_x[row], r2[:, None], side="left")[:, 0]
    col = torch.clamp(col, 0, p.width - 1)

    texel = p.rgbp[row * p.width + col]
    color = Vec3(texel[:, 0], texel[:, 1], texel[:, 2])
    pdf = texel[:, 3]

    u = col.to(torch.float32) / p.width
    v = row.to(torch.float32) / p.height
    sin_theta = torch.sin(v * PI)
    scale = p.width * p.height / (2.0 * PI * PI * torch.clamp(sin_theta, min=1e-8))
    pdf = torch.where(sin_theta == 0.0, 0.0, pdf * scale)
    return state, uv_to_dir(u, v), color, pdf, row, col


def probe_sample(p: Probe, state: RngState, u12=None):
    """Draw (direction, radiance, pdf) by inverse-CDF (ProbeSample,
    Probe.cuh:138-169), batched over the RNG state's shape. u12: optional
    caller-supplied uniform pair (see probe_sample_texel)."""
    state, d, color, pdf, _, _ = probe_sample_texel(p, state, u12=u12)
    return state, d, color, pdf


def make_test_probe(width: int = 128, height: int = 64, axis=(0.0, 1.0, 0.0),
                    power: float = 10.0, *, device) -> Probe:
    """Disc-light test probe (semantics of the commented ProbeCreateTest,
    Probe.cuh:207-242): bright disc around `axis`, black elsewhere."""
    us, vs = np.meshgrid((np.arange(width) + 0.5) / width, (np.arange(height) + 0.5) / height)
    theta = vs * np.pi
    phi = us * 2 * np.pi
    st = np.sin(theta)
    d = np.stack([-st * np.cos(phi), np.cos(theta), -st * np.sin(phi)], -1)
    a = np.asarray(axis, np.float32)
    a = a / np.linalg.norm(a)
    mask = (d @ a) >= 0.95
    img = np.where(mask[..., None], power, 0.0).astype(np.float32)
    img = np.repeat(img[..., :1], 3, axis=-1) + 1e-4  # tiny floor avoids 0-row cdfs
    return build_probe(img, device)
