"""The viewer's camera and its camera-relative lights, in float64 numpy,
shared by every scene kind's reference.

The orbit camera is a target, a distance and a rotation quaternion
(x, y, z, w); its ray basis has right and up prescaled by tan(fov/2) and
the aspect ratio. The three studio lights point from an azimuth and an
elevation in that basis. A View is what one frame's camera and settings
hand a reference's shader, in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def quat_rotate(q, v):
    qx, qy, qz, qw = q
    vx, vy, vz = v
    tx = 2 * (qy * vz - qz * vy)
    ty = 2 * (qz * vx - qx * vz)
    tz = 2 * (qx * vy - qy * vx)
    return np.array([vx + qw * tx + (qy * tz - qz * ty),
                     vy + qw * ty + (qz * tx - qx * tz),
                     vz + qw * tz + (qx * ty - qy * tx)])


def quat_multiply(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz])


def quat_axis_angle(axis, angle: float):
    axis = np.asarray(axis, np.float64)
    s = math.sin(angle * 0.5)
    q = np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle * 0.5)])
    return q / np.linalg.norm(q)


def view_rotation(azimuth_deg: float, elevation_deg: float):
    """The rotation that turns the identity view (looking along +z) by
    `azimuth_deg` about world up, then by `elevation_deg` about the turned
    camera's right."""
    yaw = quat_axis_angle((0.0, 1.0, 0.0), math.radians(azimuth_deg))
    right = quat_rotate(yaw, (1.0, 0.0, 0.0))
    q = quat_multiply(quat_axis_angle(right, math.radians(elevation_deg)), yaw)
    return q / np.linalg.norm(q)


def fit_camera(lo, hi, fov: float):
    """Target at the centre of the bounds, distance = half-diagonal /
    tan(fov/2) * 1.4: the viewer's fit."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    radius = max(1e-3, 0.5 * float(np.linalg.norm(hi - lo)))
    return 0.5 * (lo + hi), radius / math.tan(fov / 2) * 1.4


def ray_bias(lo, hi) -> float:
    """The scene-scale ray bias (also t_min): 1e-5 of the half-diagonal of
    the float32 bounds, at least 1e-5."""
    scale = float(max(1e-3, 0.5 * np.linalg.norm(np.asarray(hi) - np.asarray(lo))))
    return max(1e-5, scale * 1e-5)


def camera_basis(target, distance, rotation, fov, width, height):
    """(origin, forward, right, up) float64: right and up prescaled."""
    target = np.asarray(target, np.float64)
    forward = quat_rotate(rotation, (0.0, 0.0, 1.0))
    origin = target - forward * distance
    up = quat_rotate(rotation, (0.0, 1.0, 0.0))
    right = np.cross(forward, up)
    right = right / (np.linalg.norm(right) or 1.0)
    up = np.cross(right, forward)
    s = math.tan(fov / 2)
    return origin, forward, right * s * (width / height), up * s


def light_dirs(lights, forward, right, up) -> np.ndarray:
    """f32[3,3] pointing directions of the lights, from the normalised
    camera vectors."""
    f, r, u = (np.asarray(x, np.float64) / (np.linalg.norm(x) or 1.0)
               for x in (forward, right, up))
    out = np.zeros((3, 3), np.float32)
    for i, light in enumerate(lights[:3]):
        az = math.radians(light["azimuth"])
        el = math.radians(light["elevation"])
        d = (r * (math.cos(el) * math.sin(az)) + u * math.sin(el)
             + f * (math.cos(el) * math.cos(az)))
        out[i] = d / (np.linalg.norm(d) or 1.0)
    return out


@dataclass
class View:
    """What one frame's camera and settings hand the shader."""
    origin: np.ndarray
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray
    light_dir: np.ndarray
    bias: float


def make_view(settings: dict, cam: dict, width: int, height: int, lo, hi) -> View:
    """The View of camera dict `cam` over a scene of bounds (lo, hi)."""
    origin, fwd, right, up = camera_basis(cam["target"], cam["distance"], cam["rotation"],
                                          cam["fov"], width, height)
    return View(origin.astype(np.float32), fwd.astype(np.float32),
                right.astype(np.float32), up.astype(np.float32),
                light_dirs(settings["lights"], fwd, right, up),
                float(np.float32(ray_bias(lo, hi))))
