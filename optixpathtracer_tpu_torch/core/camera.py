"""Host-side look-at pinhole camera (port of the `Camera` of
optixpathtracer_tpu/core/camera.py, pure numpy; the trackball waits for the
viewer, ROADMAP A.14)."""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else v


@dataclasses.dataclass
class Camera:
    """Look-at pinhole camera producing the (eye, U, V, W) raygen frame."""

    eye: np.ndarray = dataclasses.field(default_factory=lambda: np.array([1.0, 0.0, 0.0], np.float32))
    lookat: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    fov_y: float = 35.0  # degrees
    aspect_ratio: float = 1.0

    def __post_init__(self):
        self.eye = np.asarray(self.eye, np.float32)
        self.lookat = np.asarray(self.lookat, np.float32)
        self.up = np.asarray(self.up, np.float32)

    def direction(self) -> np.ndarray:
        return _normalize(self.lookat - self.eye)

    def uvw_frame(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """sutil/Camera.cpp:35-47 — W unnormalized (focal length),
        V = tan(fov/2)*|W|, U = V*aspect."""
        w = self.lookat - self.eye
        wlen = float(np.linalg.norm(w))
        u = _normalize(np.cross(w, self.up))
        v = _normalize(np.cross(u, w))
        vlen = wlen * math.tan(0.5 * math.radians(self.fov_y))
        v = v * vlen
        u = u * (vlen * self.aspect_ratio)
        return u.astype(np.float32), v.astype(np.float32), w.astype(np.float32)
