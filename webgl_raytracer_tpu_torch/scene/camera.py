"""Quaternion orbit camera, its ray-generation basis and pixel->ray maths
(host numpy f64).

Counterpart of webgl_raytracer_tpu/scene/camera.py, with the same
operation order so that every result is equal bit for bit: the orbit drag
(yaw about world up, pitch about camera right with a |forward.y| < 0.995
pole clamp), the first-drag axis lock, the WASDQE fly, `basis()` (right/up
prescaled by tan(fov/2) and aspect), pixel -> world ray and fit-to-bounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def normalize_quat(q):
    q = np.asarray(q, np.float64)
    n = np.linalg.norm(q) or 1.0
    return q / n


def quat_from_axis_angle(axis, angle: float):
    axis = np.asarray(axis, np.float64)
    half = angle * 0.5
    s = np.sin(half)
    return normalize_quat([axis[0] * s, axis[1] * s, axis[2] * s, np.cos(half)])


def quat_multiply(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def quat_rotate_vec(q, v):
    qx, qy, qz, qw = q
    vx, vy, vz = v
    tx = 2 * (qy * vz - qz * vy)
    ty = 2 * (qz * vx - qx * vz)
    tz = 2 * (qx * vy - qy * vx)
    return np.array([
        vx + qw * tx + (qy * tz - qz * ty),
        vy + qw * ty + (qz * tx - qx * tz),
        vz + qw * tz + (qx * ty - qy * tx),
    ])


def apply_orbit_drag(rotation, dx: float, dy: float, rotate_speed: float = 0.004,
                     pole_limit_y: float = 0.995, world_up=(0.0, 1.0, 0.0)):
    """Orbit drag: yaw about world up then pitch about camera right, the
    pitch rejected when it would push |forward.y| past the pole limit."""
    pole_limit_y = float(np.clip(pole_limit_y, 0.8, 0.9999))
    yaw = -dx * rotate_speed
    pitch = -dy * rotate_speed
    rot = normalize_quat(rotation)

    if abs(yaw) > 1e-8:
        rot = normalize_quat(quat_multiply(quat_from_axis_angle(world_up, yaw), rot))

    if abs(pitch) > 1e-8:
        right = quat_rotate_vec(rot, [1.0, 0.0, 0.0])
        right = right / (np.linalg.norm(right) or 1.0)
        candidate = normalize_quat(quat_multiply(quat_from_axis_angle(right, pitch), rot))
        fwd = quat_rotate_vec(candidate, [0.0, 0.0, 1.0])
        if abs(fwd[1]) < pole_limit_y:
            rot = candidate
    return rot


def resolve_rotation_lock(current_lock, dx: float, dy: float, threshold_px: float = 2.0):
    """First-drag axis lock: the dominant delta picks yaw or pitch; None
    while both deltas stay under the threshold."""
    if current_lock in ("yaw", "pitch"):
        return current_lock
    adx, ady = abs(dx), abs(dy)
    if adx < threshold_px and ady < threshold_px:
        return None
    return "yaw" if adx >= ady else "pitch"


@dataclass
class CameraBasis:
    """Ray-generation basis: right/up are prescaled by tan(fov/2)·aspect."""
    origin: np.ndarray
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray
    width: int
    height: int


@dataclass
class OrbitCamera:
    """Orbit camera state: target, distance, rotation quaternion, fov."""
    target: np.ndarray = field(default_factory=lambda: np.zeros(3))
    distance: float = 4.0
    rotation: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    fov: float = np.pi / 3
    width: int = 1
    height: int = 1

    def basis(self) -> CameraBasis:
        return camera_basis(self.target, self.distance, self.rotation,
                            self.fov, self.width, self.height)

    def drag(self, dx: float, dy: float) -> None:
        self.rotation = apply_orbit_drag(self.rotation, dx, dy)

    def fit_to_bounds(self, bounds_min, bounds_max) -> None:
        self.target, self.distance, self.rotation = fit_camera_to_bounds(
            bounds_min, bounds_max, self.fov)

    def fly(self, keys, dt: float) -> bool:
        """WASDQE target fly: w/s along camera forward, a/d along camera
        right, q/e along world up/down; speed = distance * 0.6 * dt.
        Returns True if the camera moved."""
        keys = set(keys)
        if not keys & {"w", "a", "s", "d", "q", "e"}:
            return False
        basis = self.basis()
        speed = self.distance * 0.6 * dt
        forward = np.asarray(basis.forward)
        right = np.asarray(basis.right)
        right = right / (np.linalg.norm(right) or 1.0)
        target = np.asarray(self.target, np.float64)
        if "w" in keys:
            target = target + forward * speed
        if "s" in keys:
            target = target - forward * speed
        if "a" in keys:
            target = target - right * speed
        if "d" in keys:
            target = target + right * speed
        if "q" in keys:
            target = target + np.array([0.0, speed, 0.0])
        if "e" in keys:
            target = target - np.array([0.0, speed, 0.0])
        self.target = target
        return True


def camera_basis(target, distance, rotation, fov, width, height) -> CameraBasis:
    """Orbit origin behind the target, orthonormalised right/up, then
    right *= tan(fov/2)*aspect and up *= tan(fov/2)."""
    target = np.asarray(target, np.float64)
    forward = quat_rotate_vec(rotation, [0.0, 0.0, 1.0])
    origin = target - forward * distance

    up = quat_rotate_vec(rotation, [0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right = right / (np.linalg.norm(right) or 1.0)
    up_ortho = np.cross(right, forward)

    aspect = width / height
    scale = np.tan(fov / 2)
    return CameraBasis(origin=origin, forward=forward,
                       right=right * scale * aspect, up=up_ortho * scale,
                       width=int(width), height=int(height))


def camera_ray_from_pixel(camera: CameraBasis, canvas_x: float, canvas_y: float):
    """Pixel (top-left origin, y down) -> normalised world ray direction."""
    ndc_x = (canvas_x / max(1, camera.width)) * 2.0 - 1.0
    ndc_y = 1.0 - (canvas_y / max(1, camera.height)) * 2.0
    d = camera.forward + camera.right * ndc_x + camera.up * ndc_y
    n = np.linalg.norm(d)
    if n < 1e-10:
        raise ValueError("Cannot normalize zero-length ray direction.")
    return d / n


def fit_camera_to_bounds(bounds_min, bounds_max, fov: float):
    """Centre the target; distance = radius / tan(fov/2) * 1.4; identity
    rotation."""
    lo = np.asarray(bounds_min, np.float64)
    hi = np.asarray(bounds_max, np.float64)
    center = 0.5 * (lo + hi)
    radius = max(1e-3, 0.5 * float(np.linalg.norm(hi - lo)))
    distance = radius / np.tan(fov / 2) * 1.4
    return center, distance, np.array([0.0, 0.0, 0.0, 1.0])
