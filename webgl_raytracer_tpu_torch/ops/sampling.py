"""Monte-Carlo direction sampling in component form.

Counterpart of the component-form (`*_v3`) samplers of
webgl_raytracer_tpu/ops/sampling.py plus the scalar helpers they use. The
local->world frame uses up = (0,0,1) unless |axis.z| >= 0.999, else
(1,0,0). Functions take uniforms already drawn (the `*_from_uv` forms), so
draw order stays in the caller.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vec3 as V
from .rng import rand2

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))


def disk_from_uv(r1, r2):
    """Uniform unit disk: (x, y)."""
    r = V.sqrt(r1)
    phi = TWO_PI * r2
    return V.cos(phi) * r, V.sin(phi) * r


def sample_disk(state):
    """(state, (x, y)) uniform on the unit disk."""
    state, r1, r2 = rand2(state)
    return state, disk_from_uv(r1, r2)


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic, beta = 2."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return a2 / torch.clamp_min(a2 + b2, 1e-8)


def onb_v3(axis):
    use_z = torch.abs(axis[2]) < 0.999
    upx = torch.where(use_z, 0.0, 1.0)
    upz = torch.where(use_z, 1.0, 0.0)
    up = (upx, torch.zeros_like(upx), upz)
    tangent = V.normalize(V.cross(up, axis))
    bitangent = V.cross(axis, tangent)
    return tangent, bitangent


def to_world_v3(axis, lx, ly, lz):
    t, b = onb_v3(axis)
    return V.normalize((
        t[0] * lx + b[0] * ly + axis[0] * lz,
        t[1] * lx + b[1] * ly + axis[1] * lz,
        t[2] * lx + b[2] * ly + axis[2] * lz,
    ))


def cosine_hemisphere_from_uv_v3(normal, r1, r2):
    phi = TWO_PI * r1
    cos_t = V.sqrt(1.0 - r2)
    sin_t = V.sqrt(r2)
    return to_world_v3(normal, V.cos(phi) * sin_t, V.sin(phi) * sin_t, cos_t)


def cone_from_uv_v3(axis, angle, r1, r2):
    """Uniform cone of half-angle `angle` about axis: (dir, pdf)."""
    cos_max = V.cos(angle)
    cos_t = cos_max + (1.0 - cos_max) * r1
    sin_t = V.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * r2
    d = to_world_v3(axis, V.cos(phi) * sin_t, V.sin(phi) * sin_t, cos_t)
    solid = torch.clamp_min(TWO_PI * (1.0 - cos_max), 1e-6)
    return d, 1.0 / solid


def ggx_half_vector_from_uv_v3(normal, roughness, r1, r2):
    a = roughness * roughness
    a2 = a * a
    phi = TWO_PI * r1
    cos_t = V.sqrt((1.0 - r2) / (1.0 + (a2 - 1.0) * r2))
    sin_t = V.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return to_world_v3(normal, V.cos(phi) * sin_t, V.sin(phi) * sin_t, cos_t)


def reflect_from_uv_v3(direction, normal, roughness, r1, r2):
    """Mirror reflection blurred by a roughness-driven lobe."""
    r = V.reflect(direction, normal)
    phi = TWO_PI * r1
    cos_t = V.pow(1.0 - r2, 1.0 / (roughness * 4.0 + 1.0))
    sin_t = V.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    blurred = to_world_v3(V.normalize(r), V.cos(phi) * sin_t,
                          V.sin(phi) * sin_t, cos_t)
    smooth = torch.as_tensor(roughness <= 0.02)
    return V.where(smooth, V.normalize(r), blurred)


def around_direction_from_uv_v3(axis, roughness, r1, r2):
    """Cone blur around a direction."""
    a = V.normalize(axis)
    cone_angle = torch.clamp(roughness * roughness * 0.75, 0.0, 1.2)
    d, _ = cone_from_uv_v3(a, cone_angle, r1, r2)
    smooth = torch.as_tensor(roughness <= 0.02)
    return V.where(smooth, a, d)
