"""CPU tracer for picking (host numpy f64), and a brute-force oracle.

The port's own copy of webgl_raytracer_tpu/scene/pick.py (the reference
viewer's ray_pick.js): a closest-hit stack walk over the unified BVH's
flat tables with per-type intersectors, clip-plane rejection and tMin
semantics, plus the BVH-independent `brute_force_closest`. Both read the
scene's host tables of picking (SceneBuffers.pick_tables,
scene/compile.py) in world coordinates, with
the same operation order as the JAX package, so every answer is equal bit
for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bvh import PRIM_CYLINDER, PRIM_SPHERE, PRIM_TRIANGLE
from .compile import SceneBuffers


@dataclass
class PickHit:
    t: float
    prim_type: int
    prim_index: int
    # extra: triangles (u, v, 0); cylinders (hit_type, 0, 0); spheres zeros.
    extra: tuple[float, float, float] = (0.0, 0.0, 0.0)


def prim_type_label(prim_type: int) -> str:
    if prim_type == PRIM_TRIANGLE:
        return "triangle"
    if prim_type == PRIM_SPHERE:
        return "sphere"
    if prim_type == PRIM_CYLINDER:
        return "cylinder"
    return "primitive"


# --- vectorized intersectors (broadcast over primitive axis) ---------------

def _dot(a, b):
    return np.sum(a * b, axis=-1)


def sphere_hit_t(origin, direction, centers, radii, t_min):
    """t of nearest valid sphere hit per primitive, -1 when missed.

    Quadratic with b = oc . d (unit dir assumed), matching webgl.js:425-442:
    takes -b-sqrt(D), falls back to -b+sqrt(D) when the near root <= tMin.
    """
    oc = origin[None, :] - centers
    b = _dot(oc, direction[None, :])
    c = _dot(oc, oc) - radii * radii
    disc = b * b - c
    ok = disc >= 0.0
    sq = np.sqrt(np.where(ok, disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = np.where(t0 > t_min, t0, t1)
    return np.where(ok & (t > t_min), t, -1.0)


def cylinder_hit(origin, direction, p1, p2, radii, t_min):
    """(t, hit_type) per cylinder with hemispherical caps (webgl.js:446-523).

    hit_type: 0 = side, 1 = cap at p1, 2 = cap at p2. Degenerate (zero
    height) cylinders fall back to a sphere at p1.
    """
    axis_raw = p2 - p1
    height = np.linalg.norm(axis_raw, axis=-1)
    degen = height < 1e-6
    safe_h = np.where(degen, 1.0, height)
    axis = axis_raw / safe_h[:, None]

    oc = origin[None, :] - p1
    dir_dot = _dot(direction[None, :], axis)
    oc_dot = _dot(oc, axis)
    dir_perp = direction[None, :] - axis * dir_dot[:, None]
    oc_perp = oc - axis * oc_dot[:, None]

    a = _dot(dir_perp, dir_perp)
    b = 2.0 * _dot(dir_perp, oc_perp)
    c = _dot(oc_perp, oc_perp) - radii * radii

    best_t = np.full(p1.shape[0], -1.0)
    hit_type = np.zeros(p1.shape[0])

    disc = b * b - 4.0 * a * c
    body_ok = (a > 1e-8) & (disc >= 0.0)
    sq = np.sqrt(np.where(body_ok, disc, 0.0))
    denom = np.where(body_ok, 2.0 * a, 1.0)
    t1 = (-b - sq) / denom
    t2 = (-b + sq) / denom
    h1 = oc_dot + t1 * dir_dot
    h2 = oc_dot + t2 * dir_dot
    t1_ok = body_ok & (t1 > t_min) & (h1 >= 0.0) & (h1 <= height)
    t2_ok = body_ok & ~t1_ok & (t2 > t_min) & (h2 >= 0.0) & (h2 <= height)
    best_t = np.where(t1_ok, t1, np.where(t2_ok, t2, best_t))

    for cap_i, cap_p, sign in ((1.0, p1, -1.0), (2.0, p2, 1.0)):
        tc = sphere_hit_t(origin, direction, cap_p, radii, t_min)
        pos = origin[None, :] + direction[None, :] * tc[:, None]
        h = _dot(pos - cap_p, axis)
        in_cap = (h * sign) >= 0.0
        better = (tc > t_min) & ((best_t < 0.0) | (tc < best_t)) & in_cap
        best_t = np.where(better, tc, best_t)
        hit_type = np.where(better, cap_i, hit_type)

    # Degenerate: plain sphere at p1 (hit_type stays 0 like the side case).
    t_sph = sphere_hit_t(origin, direction, p1, radii, t_min)
    best_t = np.where(degen, t_sph, best_t)
    hit_type = np.where(degen, 0.0, hit_type)
    return best_t, hit_type


def triangle_hit(origin, direction, v0, v1, v2, t_min):
    """Moller-Trumbore (webgl.js:364-392): (t, u, v), t = -1 on miss."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = np.cross(np.broadcast_to(direction, e2.shape), e2)
    det = _dot(e1, p)
    ok = np.abs(det) >= 1e-6
    inv = 1.0 / np.where(ok, det, 1.0)
    tvec = origin[None, :] - v0
    u = _dot(tvec, p) * inv
    q = np.cross(tvec, e1)
    v = _dot(np.broadcast_to(direction, q.shape), q) * inv
    t = _dot(e2, q) * inv
    ok &= (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return np.where(ok, t, -1.0), u, v


def cylinder_normal(pos, p1, p2, hit_type):
    """Surface normal at a cylinder hit point (webgl.js:527-541)."""
    axis = p2 - p1
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    if hit_type == 1.0:
        n = pos - p1
    elif hit_type == 2.0:
        n = pos - p2
    else:
        h = np.dot(pos - p1, axis)
        n = pos - (p1 + axis * h)
    return n / max(np.linalg.norm(n), 1e-12)


def _clip_mask(origin, direction, t, clip):
    """True where the hit survives the clip plane (side*clipSide <= 0)."""
    if clip is None:
        return np.ones(np.shape(t), bool)
    normal, offset, side = clip
    pos = origin[None, :] + direction[None, :] * np.asarray(t)[..., None]
    s = pos @ np.asarray(normal) - offset
    return (s * side) <= 0.0


def brute_force_closest(
    scene: SceneBuffers,
    origins: np.ndarray,
    dirs: np.ndarray,
    t_min: float = 1e-5,
    clip: tuple[np.ndarray, float, float] | None = None,
):
    """Closest hit for each ray by testing every primitive. The oracle.

    Triangles are clip-tested like the GLSL intersector; spheres/cylinders
    are clip-tested after the closest candidate is found (ray_pick.js
    :159-172 applies passesClip to the returned t only — we match that).
    Returns dict of arrays: t (inf for miss), prim_type (-1 miss),
    prim_index, extra f32[...,3].
    """
    origins = np.atleast_2d(np.asarray(origins, np.float64))
    dirs = np.atleast_2d(np.asarray(dirs, np.float64))
    n_rays = origins.shape[0]

    out_t = np.full(n_rays, np.inf)
    out_type = np.full(n_rays, -1, np.int32)
    out_index = np.full(n_rays, -1, np.int32)
    out_extra = np.zeros((n_rays, 3))

    tables = scene.pick_tables
    tv = np.asarray(tables.tri_verts, np.float64)[: scene.tri_count]
    sc = np.asarray(tables.sphere_centers, np.float64)[: scene.sphere_count]
    sr = np.asarray(tables.sphere_radii, np.float64)[: scene.sphere_count]
    c1 = np.asarray(tables.cyl_p1, np.float64)[: scene.cylinder_count]
    c2 = np.asarray(tables.cyl_p2, np.float64)[: scene.cylinder_count]
    cr = np.asarray(tables.cyl_radii, np.float64)[: scene.cylinder_count]

    for r in range(n_rays):
        o, d = origins[r], dirs[r]

        if scene.tri_count:
            t, u, v = triangle_hit(o, d, tv[:, 0], tv[:, 1], tv[:, 2], t_min)
            t = np.where((t > 0) & _clip_mask(o, d, t, clip), t, np.inf)
            i = int(np.argmin(t))
            if t[i] < out_t[r]:
                out_t[r] = t[i]
                out_type[r] = PRIM_TRIANGLE
                out_index[r] = i
                out_extra[r] = (u[i], v[i], 0.0)

        if scene.sphere_count:
            t = sphere_hit_t(o, d, sc, sr, t_min)
            t = np.where((t > 0) & _clip_mask(o, d, t, clip), t, np.inf)
            i = int(np.argmin(t))
            if t[i] < out_t[r]:
                out_t[r] = t[i]
                out_type[r] = PRIM_SPHERE
                out_index[r] = i
                out_extra[r] = (0.0, 0.0, 0.0)

        if scene.cylinder_count:
            t, ht = cylinder_hit(o, d, c1, c2, cr, t_min)
            t = np.where((t > 0) & _clip_mask(o, d, t, clip), t, np.inf)
            i = int(np.argmin(t))
            if t[i] < out_t[r]:
                out_t[r] = t[i]
                out_type[r] = PRIM_CYLINDER
                out_index[r] = i
                out_extra[r] = (ht[i], 0.0, 0.0)

    return {"t": out_t, "prim_type": out_type, "prim_index": out_index, "extra": out_extra}


def trace_scene_ray(
    scene: SceneBuffers,
    origin,
    direction,
    t_min: float = 1e-6,
    clip: tuple[np.ndarray, float, float] | None = None,
) -> PickHit | None:
    """Single-ray closest hit via the BVH stack walk (ray_pick.js:183-226).

    clip = (normal f32[3], offset, side) or None.
    """
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    tables = scene.pick_tables
    bmin = np.asarray(tables.node_bmin, np.float64)
    bmax = np.asarray(tables.node_bmax, np.float64)
    meta = np.asarray(tables.node_meta)

    closest = np.inf
    best: PickHit | None = None
    stack = [0]

    while stack:
        node = stack.pop()
        left_first, prim_count, right_child = meta[node]
        # Slab test against current closest.
        t0 = 0.0
        t1 = closest
        ok = True
        for axis in range(3):
            if abs(d[axis]) < 1e-8:
                if o[axis] < bmin[node, axis] or o[axis] > bmax[node, axis]:
                    ok = False
                    break
                continue
            inv = 1.0 / d[axis]
            a = (bmin[node, axis] - o[axis]) * inv
            b = (bmax[node, axis] - o[axis]) * inv
            t0 = max(t0, min(a, b))
            t1 = min(t1, max(a, b))
            if t1 < t0:
                ok = False
                break
        if not ok:
            continue

        if prim_count > 0:
            sl = slice(left_first, left_first + prim_count)
            ptypes = np.asarray(tables.prim_type[sl])
            plocal = np.asarray(tables.prim_local[sl])
            pa = np.asarray(tables.prim_a[sl], np.float64)
            pb = np.asarray(tables.prim_b[sl], np.float64)
            pc = np.asarray(tables.prim_c[sl], np.float64)

            for k in range(prim_count):
                ptype = int(ptypes[k])
                if ptype == PRIM_TRIANGLE:
                    t, u, v = triangle_hit(o, d, pa[k:k+1, :3], pb[k:k+1, :3], pc[k:k+1, :3], t_min)
                    t, u, v = float(t[0]), float(u[0]), float(v[0])
                    extra = (u, v, 0.0)
                elif ptype == PRIM_SPHERE:
                    t = float(sphere_hit_t(o, d, pa[k:k+1, :3], pa[k:k+1, 3], t_min)[0])
                    extra = (0.0, 0.0, 0.0)
                else:
                    t_arr, ht = cylinder_hit(o, d, pa[k:k+1, :3], pb[k:k+1, :3], pa[k:k+1, 3], t_min)
                    t = float(t_arr[0])
                    extra = (float(ht[0]), 0.0, 0.0)
                if t <= t_min or t >= closest:
                    continue
                if clip is not None and not bool(_clip_mask(o, d, np.array([t]), clip)[0]):
                    continue
                closest = t
                best = PickHit(t=t, prim_type=ptype, prim_index=int(plocal[k]), extra=extra)
        else:
            if right_child >= 0:
                stack.append(int(right_child))
            stack.append(int(left_first))

    return best
