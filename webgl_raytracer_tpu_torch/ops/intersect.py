"""Ray/primitive intersectors on component triples.

Counterpart of webgl_raytracer_tpu/ops/intersect.py (the reference
viewer's webgl.js:270-541): the same expressions, operation for
operation, on vectors as component triples of equal-shape tensors
(ops/vec3.py) where the JAX module takes [..., 3] arrays. Its _dot,
jnp.sum(a * b, axis=-1), adds the three products left to right: dot
below does the same. sqrt goes through ops/vec3 (correctly rounded on CPU
tensors). Misses are t = -1.0, the shader's sentinel.

These are the stack walk's intersectors (ops/traversal.py, and
csrc/trace_stack.cu, which repeats them): the capped cylinder here is the
perpendicular-projection body plus two cap spheres. The cluster tracer's
SoA forms (ops/wavefront.intersect_soa_t, csrc/intersect.cuh) round
differently. The volume march clips its segment to the density grid's box
with intersect_aabb_range.
"""

from __future__ import annotations

import torch

from . import vec3 as V
from .wavefront import BIG


def dot(a, b):
    """jnp.sum(a * b, axis=-1) of the JAX module: products summed left to
    right."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _slabs(bmin, bmax, origin, direction):
    """Per axis (t_near, t_far, axis_ok): an axis with |d| < 1e-8 passes
    only when the origin lies inside its slab."""
    out = []
    for a in range(3):
        d, o = direction[a], origin[a]
        parallel = d.abs() < 1e-8
        inv = 1.0 / torch.where(parallel, 1.0, d)
        t1 = (bmin[a] - o) * inv
        t2 = (bmax[a] - o) * inv
        near = torch.where(parallel, -BIG, torch.minimum(t1, t2))
        far = torch.where(parallel, BIG, torch.maximum(t1, t2))
        out.append((near, far, ~parallel | ((o >= bmin[a]) & (o <= bmax[a]))))
    return out


def intersect_aabb(bmin, bmax, origin, direction, t_max):
    """Does each ray hit its box before t_max? bmin, bmax, origin,
    direction: component triples; t_max broadcasts."""
    (n0, f0, k0), (n1, f1, k1), (n2, f2, k2) = _slabs(bmin, bmax, origin, direction)
    tmin = torch.clamp_min(torch.maximum(torch.maximum(n0, n1), n2), 0.0)
    tmax = torch.minimum(torch.minimum(torch.minimum(f0, f1), f2), t_max)
    return k0 & k1 & k2 & (tmax >= tmin)


def intersect_aabb_range(bmin, bmax, origin, direction):
    """(hit, t_near, t_far) of rays against one box over an unbounded
    range. bmin, bmax: f32[3]; origin, direction: component triples of
    [N] tensors. hit needs t_far >= max(t_near, 0)."""
    (n0, f0, k0), (n1, f1, k1), (n2, f2, k2) = _slabs(bmin, bmax, origin, direction)
    t_near = torch.maximum(torch.maximum(n0, n1), n2)
    t_far = torch.minimum(torch.minimum(f0, f1), f2)
    hit = k0 & k1 & k2 & (t_far >= torch.clamp_min(t_near, 0.0))
    return hit, t_near, t_far


def intersect_sphere(origin, direction, center, radius, t_min):
    """Nearest sphere hit t beyond t_min, or -1 (webgl.js:425-442)."""
    oc = V.sub(origin, center)
    b = dot(oc, direction)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    sq = V.sqrt(torch.where(ok, disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > t_min, t0, t1)
    return torch.where(ok & (t > t_min), t, -1.0)


def intersect_cylinder(origin, direction, p1, p2, radius, t_min):
    """(t, hit_type) for a finite cylinder with hemispherical caps
    (webgl.js:446-523); hit_type 0 side, 1 cap at p1, 2 cap at p2."""
    axis_raw = V.sub(p2, p1)
    height = V.sqrt(dot(axis_raw, axis_raw))
    degen = height < 1e-6
    safe_h = torch.where(degen, 1.0, height)
    axis = (axis_raw[0] / safe_h, axis_raw[1] / safe_h, axis_raw[2] / safe_h)

    oc = V.sub(origin, p1)
    dir_dot = dot(direction, axis)
    oc_dot = dot(oc, axis)
    dir_perp = V.sub(direction, V.scale(axis, dir_dot))
    oc_perp = V.sub(oc, V.scale(axis, oc_dot))

    a = dot(dir_perp, dir_perp)
    b = 2.0 * dot(dir_perp, oc_perp)
    c = dot(oc_perp, oc_perp) - radius * radius

    disc = b * b - 4.0 * a * c
    body_ok = (a > 1e-8) & (disc >= 0.0)
    sq = V.sqrt(torch.where(body_ok, disc, 0.0))
    denom = torch.where(body_ok, 2.0 * a, 1.0)
    t1 = (-b - sq) / denom
    t2 = (-b + sq) / denom
    h1 = oc_dot + t1 * dir_dot
    h2 = oc_dot + t2 * dir_dot
    t1_ok = body_ok & (t1 > t_min) & (h1 >= 0.0) & (h1 <= height)
    t2_ok = body_ok & ~t1_ok & (t2 > t_min) & (h2 >= 0.0) & (h2 <= height)
    best = torch.where(t1_ok, t1, torch.where(t2_ok, t2, -1.0))
    hit_type = torch.zeros_like(best)

    for cap_code, cap_p, sign in ((1.0, p1, -1.0), (2.0, p2, 1.0)):
        tc = intersect_sphere(origin, direction, cap_p, radius, t_min)
        pos = V.add(origin, V.scale(direction, tc))
        h = dot(V.sub(pos, cap_p), axis)
        better = (tc > t_min) & ((best < 0.0) | (tc < best)) & ((h * sign) >= 0.0)
        best = torch.where(better, tc, best)
        hit_type = torch.where(better, cap_code, hit_type)

    t_sph = intersect_sphere(origin, direction, p1, radius, t_min)
    best = torch.where(degen, t_sph, best)
    hit_type = torch.where(degen, 0.0, hit_type)
    return best, hit_type


def intersect_triangle(origin, direction, v0, v1, v2, t_min):
    """Moller-Trumbore: (t, u, v) with t = -1 on a miss (webgl.js:364-392).
    The caller applies the clip plane (clip_reject)."""
    e1 = V.sub(v1, v0)
    e2 = V.sub(v2, v0)
    p = V.cross(direction, e2)
    det = dot(e1, p)
    ok = det.abs() >= 1e-6
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvec = V.sub(origin, v0)
    u = dot(tvec, p) * inv
    q = V.cross(tvec, e1)
    v = dot(direction, q) * inv
    t = dot(e2, q) * inv
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return torch.where(ok, t, -1.0), u, v


def cylinder_normal(pos, p1, p2, hit_type):
    """Unit normal at a cylinder hit (webgl.js:527-541)."""
    axis_raw = V.sub(p2, p1)
    n_axis = torch.clamp_min(V.sqrt(dot(axis_raw, axis_raw)), 1e-12)
    axis = (axis_raw[0] / n_axis, axis_raw[1] / n_axis, axis_raw[2] / n_axis)
    h = dot(V.sub(pos, p1), axis)
    side_n = V.sub(pos, V.add(p1, V.scale(axis, h)))
    n = V.where(hit_type == 1.0, V.sub(pos, p1),
                V.where(hit_type == 2.0, V.sub(pos, p2), side_n))
    norm = torch.clamp_min(V.sqrt(dot(n, n)), 1e-12)
    return (n[0] / norm, n[1] / norm, n[2] / norm)


def clip_reject(origin, direction, t, clip_normal, clip_offset, clip_side):
    """True where a hit at t lies on the clipped side of the plane
    (webgl.js:384-390): (n . pos - offset) * side > 0."""
    pos = V.add(origin, V.scale(direction, t))
    s = dot(pos, clip_normal) - clip_offset
    return s * clip_side > 0.0
