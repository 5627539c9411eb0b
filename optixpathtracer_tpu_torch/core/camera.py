"""Host-side camera and trackball (port of optixpathtracer_tpu/core/camera.py,
pure numpy): the look-at pinhole `Camera` (sutil/Camera) producing the
eye / U / V / W raygen frame, and the orbit / zoom `Trackball`
(sutil/Trackball) the viewer drives from pointer events."""
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

    def set_direction(self, d: np.ndarray) -> None:
        self.lookat = self.eye + float(np.linalg.norm(self.lookat - self.eye)) * d

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


class Trackball:
    """Orbit / zoom camera controller (sutil/Trackball semantics).

    Maps pointer deltas to latitude / longitude on an orbit sphere around
    the look-at point (LOOKAT_FIXED moves the eye; EYE_FIXED moves the
    look-at), with an optional fixed reference frame (gimbal lock)."""

    EYE_FIXED = "eye_fixed"
    LOOKAT_FIXED = "lookat_fixed"

    def __init__(self, camera: Camera | None = None):
        self.camera = camera
        self.view_mode = self.LOOKAT_FIXED
        self.move_speed = 1.0
        self.roll_speed = 0.5  # degrees per pixel
        self.zoom_multiplier = 1.1
        self.gimbal_lock = False
        self._u = np.array([1.0, 0.0, 0.0], np.float32)
        self._v = np.array([0.0, 1.0, 0.0], np.float32)
        self._w = np.array([0.0, 0.0, 1.0], np.float32)
        self._latitude = 0.0
        self._longitude = 0.0
        self._camera_eye_lookat_distance = 1.0
        self._prev_pos = (0, 0)
        self._tracking = False
        if camera is not None:
            self.set_camera(camera)

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera
        self.reinit_orientation_from_camera()

    def set_reference_frame(self, u, v, w) -> None:
        self._u = np.asarray(u, np.float32)
        self._v = np.asarray(v, np.float32)
        self._w = np.asarray(w, np.float32)
        dir_neg = -self.camera.direction() if self.camera else np.array([0, 0, 1.0])
        self._latitude = math.asin(np.clip(np.dot(dir_neg, self._w), -1, 1))
        self._longitude = math.atan2(np.dot(dir_neg, self._v), np.dot(dir_neg, self._u))

    def reinit_orientation_from_camera(self) -> None:
        cam = self.camera
        u, v, w = cam.uvw_frame()
        self._u = _normalize(u)
        self._v = -_normalize(v)
        self._w = -_normalize(w)
        self._latitude = 0.0
        self._longitude = 0.0
        self._camera_eye_lookat_distance = float(np.linalg.norm(cam.lookat - cam.eye))

    def start_tracking(self, x: int, y: int) -> None:
        self._prev_pos = (x, y)
        self._tracking = True

    def update_tracking(self, x: int, y: int, canvas_w: int, canvas_h: int) -> None:
        if not self._tracking:
            self.start_tracking(x, y)
            return
        px, py = self._prev_pos
        dx, dy = x - px, y - py
        self._prev_pos = (x, y)
        self._latitude = math.radians(min(89.0, max(-89.0, math.degrees(self._latitude) + 0.5 * dy)))
        self._longitude = math.radians((math.degrees(self._longitude) - 0.5 * dx) % 360.0)
        self._update_camera()
        if not self.gimbal_lock:
            self.reinit_orientation_from_camera()

    def wheel_event(self, direction: int) -> bool:
        self.zoom(direction)
        return True

    def zoom(self, direction: int) -> None:
        zoom = self.zoom_multiplier if direction > 0 else 1.0 / self.zoom_multiplier
        self._camera_eye_lookat_distance = float(
            np.linalg.norm(self.camera.lookat - self.camera.eye) * zoom)
        self.camera.eye = (self.camera.lookat
                           + (self.camera.eye - self.camera.lookat) * zoom).astype(np.float32)

    def _update_camera(self) -> None:
        local = np.array([
            math.cos(self._latitude) * math.cos(self._longitude),
            math.cos(self._latitude) * math.sin(self._longitude),
            math.sin(self._latitude),
        ], np.float32)
        dir_world = local[0] * self._u + local[1] * self._v + local[2] * self._w
        if self.view_mode == self.LOOKAT_FIXED:
            self.camera.eye = (self.camera.lookat
                               + self._camera_eye_lookat_distance * dir_world).astype(np.float32)
        else:
            self.camera.lookat = (self.camera.eye
                                  - self._camera_eye_lookat_distance * dir_world).astype(np.float32)
