"""Analytic light types: point / ambient / parallelogram-area (port of
optixpathtracer_tpu/lights/lights.py).

Reference: cuda/Light.h (:31-71) point+ambient used by the whitted
pipeline's direct-lighting loop, and the ParallelogramLight of the path
tracers' LaunchParams (LaunchParams.h:32-38), which the wavefront engine
samples as a real NEE strategy (`engine/wavefront._quad_nee`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import Vec3, cross, normalize
from ..core.rng import RngState, randf2

Tensor = torch.Tensor

LIGHT_POINT = 0
LIGHT_AMBIENT = 1
LIGHT_PARALLELOGRAM = 2


class LightTable(NamedTuple):
    """SoA table of lights; rows select fields by `kind`."""

    kind: Tensor  # (L,) int32
    position: Vec3  # point: position; parallelogram: corner
    v1: Vec3  # parallelogram edge 1
    v2: Vec3  # parallelogram edge 2
    color: Vec3  # color * intensity (point/ambient) or emission (area)
    intensity: Tensor

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def make_point_light(position, color, intensity=1.0) -> dict:
    return dict(kind=LIGHT_POINT, position=position, v1=(0, 0, 0), v2=(0, 0, 0),
                color=color, intensity=intensity)


def make_ambient_light(color, intensity=1.0) -> dict:
    return dict(kind=LIGHT_AMBIENT, position=(0, 0, 0), v1=(0, 0, 0), v2=(0, 0, 0),
                color=color, intensity=intensity)


def make_parallelogram_light(corner, v1, v2, emission) -> dict:
    """ParallelogramLight (LaunchParams.h:32-38): corner + two edges."""
    return dict(kind=LIGHT_PARALLELOGRAM, position=corner, v1=v1, v2=v2,
                color=emission, intensity=1.0)


def build_lights(lights: list[dict], device) -> LightTable:
    """Light dicts -> a LightTable on `device` (one black ambient light if
    the list is empty)."""
    if not lights:
        lights = [make_ambient_light((0, 0, 0), 0.0)]

    def vec(name):
        a = np.array([light[name] for light in lights], np.float32)
        return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]), device=device)
                      for i in range(3)))

    return LightTable(
        kind=torch.as_tensor(np.array([light["kind"] for light in lights], np.int32), device=device),
        position=vec("position"),
        v1=vec("v1"),
        v2=vec("v2"),
        color=vec("color"),
        intensity=torch.as_tensor(np.array([light["intensity"] for light in lights], np.float32),
                                  device=device),
    )


class QuadLight(NamedTuple):
    """Single parallelogram area light. Every field is a uniform: a Vec3 of
    0-dim float32 tensors, and `area` a 0-dim float32 tensor."""

    corner: Vec3
    v1: Vec3
    v2: Vec3
    emission: Vec3
    normal: Vec3
    area: Tensor

    @staticmethod
    def make(corner, v1, v2, emission, device) -> "QuadLight":
        """The light on `device`. Its normal and area come from float32
        numpy on the host, as in the reference: the NEE's pdf uses this
        `area`, not the one `sample_parallelogram` recomputes."""
        c = np.asarray(corner, np.float32)
        a = np.asarray(v1, np.float32)
        b = np.asarray(v2, np.float32)
        e = np.asarray(emission, np.float32)
        n = np.cross(a, b)
        area = float(np.linalg.norm(n))
        n = n / max(area, 1e-20)
        return QuadLight(*(Vec3.of(*(float(k) for k in x), device=device) for x in (c, a, b, e, n)),
                         area=torch.tensor(area, dtype=torch.float32, device=device))


def sample_parallelogram(
    light_corner: Vec3, light_v1: Vec3, light_v2: Vec3, state: RngState
) -> tuple[RngState, Vec3, Vec3, Tensor]:
    """Uniform point on the quad, one `randf2` from each lane's stream;
    returns (state, point, normal, area)."""
    state, u1, u2 = randf2(state)
    p = light_corner + light_v1 * u1 + light_v2 * u2
    n = normalize(cross(light_v1, light_v2))
    a = torch.sqrt(
        (light_v1.y * light_v2.z - light_v1.z * light_v2.y) ** 2
        + (light_v1.z * light_v2.x - light_v1.x * light_v2.z) ** 2
        + (light_v1.x * light_v2.y - light_v1.y * light_v2.x) ** 2
    )
    return state, p, n, a
