"""Hover-overlay maths: primitive world AABBs and their projection to
canvas rectangles. The port's own copy of
webgl_raytracer_tpu/scene/overlay.py (the reference viewer's
overlay_bbox.js), on the scene's host tables of picking."""

from __future__ import annotations

import numpy as np

from .bvh import PRIM_CYLINDER, PRIM_SPHERE, PRIM_TRIANGLE
from .compile import SceneBuffers


def compute_primitive_world_bounds(scene: SceneBuffers, prim_type: int, prim_index: int):
    """(bounds_min f64[3], bounds_max f64[3]) of one primitive
    (overlay_bbox.js:7-84; cylinder AABB without the BVH's 1e-3 pad)."""
    if prim_type == PRIM_TRIANGLE:
        if prim_index >= scene.tri_count:
            raise IndexError(f"Missing triangle {prim_index} for hover bounds.")
        v = np.asarray(scene.pick_tables.tri_verts[prim_index], np.float64)
        return v.min(axis=0), v.max(axis=0)
    if prim_type == PRIM_SPHERE:
        if prim_index >= scene.sphere_count:
            raise IndexError(f"Missing sphere {prim_index} for hover bounds.")
        c = np.asarray(scene.pick_tables.sphere_centers[prim_index], np.float64)
        r = float(scene.pick_tables.sphere_radii[prim_index])
        return c - r, c + r
    if prim_type == PRIM_CYLINDER:
        if prim_index >= scene.cylinder_count:
            raise IndexError(f"Missing cylinder {prim_index} for hover bounds.")
        p1 = np.asarray(scene.pick_tables.cyl_p1[prim_index], np.float64)
        p2 = np.asarray(scene.pick_tables.cyl_p2[prim_index], np.float64)
        r = float(scene.pick_tables.cyl_radii[prim_index])
        d = p2 - p1
        h = np.linalg.norm(d)
        axis = d / h if h > 1e-8 else np.array([0.0, 1.0, 0.0])
        extent = r * np.sqrt(np.clip(1.0 - axis * axis, 0.0, 1.0))
        return np.minimum(p1, p2) - extent, np.maximum(p1, p2) + extent
    raise ValueError(f"Unknown primitive type {prim_type} for hover bounds.")


def project_point_to_canvas(point, camera, width, height):
    """Perspective projection onto canvas pixels (top-left origin);
    None when behind the camera (overlay_bbox.js:86-108)."""
    d = np.asarray(point, np.float64) - np.asarray(camera.origin, np.float64)
    z = float(d @ np.asarray(camera.forward))
    if z <= 1e-6:
        return None
    right = np.asarray(camera.right, np.float64)
    up = np.asarray(camera.up, np.float64)
    right_sq = float(right @ right)
    up_sq = float(up @ up)
    if right_sq <= 1e-10 or up_sq <= 1e-10:
        raise ValueError("Camera projection basis is degenerate.")
    ndc_x = float(d @ right) / (z * right_sq)
    ndc_y = float(d @ up) / (z * up_sq)
    return ((ndc_x * 0.5 + 0.5) * width, (1.0 - (ndc_y * 0.5 + 0.5)) * height)


def project_aabb_to_canvas_rect(bounds_min, bounds_max, camera, width, height):
    """Screen-space rect of an AABB, clamped to the canvas; None if fully
    behind the camera or off screen (overlay_bbox.js:114-174)."""
    if width <= 0 or height <= 0:
        raise ValueError("Projection width and height must be > 0.")
    lo = np.asarray(bounds_min, np.float64)
    hi = np.asarray(bounds_max, np.float64)
    corners = [
        [lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
        [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
        [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
        [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]],
    ]
    min_x = min_y = np.inf
    max_x = max_y = -np.inf
    visible = 0
    for corner in corners:
        p = project_point_to_canvas(corner, camera, width, height)
        if p is None:
            continue
        visible += 1
        min_x = min(min_x, p[0])
        min_y = min(min_y, p[1])
        max_x = max(max_x, p[0])
        max_y = max(max_y, p[1])
    if visible == 0:
        return None
    if max_x < 0 or max_y < 0 or min_x > width or min_y > height:
        return None
    cmin_x = float(np.clip(min_x, 0, width))
    cmin_y = float(np.clip(min_y, 0, height))
    cmax_x = float(np.clip(max_x, 0, width))
    cmax_y = float(np.clip(max_y, 0, height))
    w = cmax_x - cmin_x
    h = cmax_y - cmin_y
    if w < 1 or h < 1:
        return None
    return {"min_x": cmin_x, "min_y": cmin_y, "max_x": cmax_x, "max_y": cmax_y,
            "width": w, "height": h}
