"""Vector math core: the SoA `Vec3` and its helpers.

Port of optixpathtracer_tpu/core/math.py. A `Vec3` holds three 1-D float32
tensors (x, y, z) of one shape; every helper is elementwise and batched over
that shape. Scalars broadcast (a `Vec3` of 0-dim tensors is a uniform).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
INV_TWO_PI = 1.0 / TWO_PI


class Vec3(NamedTuple):
    """SoA 3-vector batch. Each component is a tensor of the same shape."""

    x: Tensor
    y: Tensor
    z: Tensor

    # -- constructors ------------------------------------------------------
    @staticmethod
    def zeros(shape, device) -> "Vec3":
        v = torch.zeros(shape, dtype=torch.float32, device=device)
        return Vec3(v, v, v)

    @staticmethod
    def of(x: float, y: float, z: float, device) -> "Vec3":
        """A uniform: three 0-dim float32 tensors."""
        return Vec3(*(torch.tensor(c, dtype=torch.float32, device=device) for c in (x, y, z)))

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return Vec3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


# -- free functions --------------------------------------------------------

def dot(a: Vec3, b: Vec3) -> Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_sq(a: Vec3) -> Tensor:
    return dot(a, a)


def normalize(a: Vec3) -> Vec3:
    return a * torch.rsqrt(torch.clamp(length_sq(a), min=1e-30))


def safe_normalize(a: Vec3) -> Vec3:
    """maths.h SafeNormalize: the zero vector for zero-length input."""
    m = length_sq(a)
    ok = m > 0.0
    out = a * torch.rsqrt(torch.where(ok, m, 1.0))
    return where(ok, out, Vec3(*(torch.zeros_like(m),) * 3))


def where(mask: Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def lerp(a, b, t):
    """a + (b - a) * t, for tensors, scalars and Vec3 alike."""
    return a + (b - a) * t


def faceforward(n: Vec3, i: Vec3, nref: Vec3) -> Vec3:
    """sutil faceforward: n flipped so it faces the direction of i."""
    return n * torch.where(dot(i, nref) > 0.0, 1.0, -1.0)


def luminance(c: Vec3) -> Tensor:
    """Reference Luminance(): 0.3/0.6/0.1 weights (maths.h:165-168)."""
    return c.x * 0.3 + c.y * 0.6 + c.z * 0.1


def basis_from_vector(n: Vec3) -> tuple[Vec3, Vec3]:
    """Branchless Frisvad/Duff orthonormal basis (u, v) around unit n."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    u = Vec3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    v = Vec3(b, s + n.y * n.y * a, -n.y)
    return u, v


def local_to_world(local: Vec3, u: Vec3, v: Vec3, n: Vec3) -> Vec3:
    """Map tangent-space direction (x,y,z) into the (u,v,n) world frame."""
    return u * local.x + v * local.y + n * local.z


def refract(wi: Vec3, n: Vec3, eta) -> tuple[Vec3, Tensor]:
    """Snell refraction of `wi` (pointing away from the surface).

    Returns (wt, ok); ok=False flags total internal reflection."""
    cos_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = (-wi) * eta + n * (eta * cos_i - cos_t)
    return wt, ok
