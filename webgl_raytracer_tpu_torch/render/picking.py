"""Interactive picking: hover queries and click-to-focus autofocus.

Counterpart of webgl_raytracer_tpu/render/picking.py (the reference
viewer's main.js:1372-1514 and ray_pick.js): a host-side trace through
the Renderer's camera and active clip plane against the scene's host
tables (scene/pick.py), in world coordinates. Nothing here touches the
card."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..scene.camera import camera_ray_from_pixel
from ..scene.overlay import (
    compute_primitive_world_bounds,
    project_aabb_to_canvas_rect,
)
from ..scene.pick import PickHit, prim_type_label, trace_scene_ray


@dataclass
class HoverResult:
    hit: PickHit
    label: str
    bounds_min: np.ndarray
    bounds_max: np.ndarray
    rect: Optional[dict]


def pick_at_pixel(renderer, x: float, y: float) -> Optional[PickHit]:
    """Closest-hit query through canvas pixel (x, y), honoring the active
    clip plane (main.js tracePointerHit :1372-1382)."""
    basis = renderer.camera.basis()
    direction = camera_ray_from_pixel(basis, x, y)
    clip = renderer.active_clip_plane(basis)
    return trace_scene_ray(
        renderer.scene, basis.origin, direction,
        t_min=max(1e-6, renderer.settings.t_min), clip=clip,
    )


def hover_at_pixel(renderer, x: float, y: float) -> Optional[HoverResult]:
    """Hover info: hit + world AABB + projected canvas rect
    (updateHoverBoxOverlay, main.js:1436-1459)."""
    hit = pick_at_pixel(renderer, x, y)
    if hit is None:
        return None
    lo, hi = compute_primitive_world_bounds(renderer.scene, hit.prim_type, hit.prim_index)
    basis = renderer.camera.basis()
    rect = project_aabb_to_canvas_rect(lo, hi, basis, renderer.width, renderer.height)
    return HoverResult(
        hit=hit,
        label=f"{prim_type_label(hit.prim_type)} #{hit.prim_index}",
        bounds_min=lo,
        bounds_max=hi,
        rect=rect,
    )


def autofocus_at_pixel(renderer, x: float, y: float,
                       focus_min: float = 0.05, focus_max: float = 1e4) -> Optional[float]:
    """Click-to-focus: sets dof_focus_distance to the hit distance (clamped)
    and resets accumulation (main.js autofocusFromMouseRay :1475-1514).
    Returns the new focus distance or None on miss."""
    hit = pick_at_pixel(renderer, x, y)
    if hit is None:
        return None
    focus = float(np.clip(hit.t, focus_min, focus_max))
    renderer.settings.dof_focus_distance = focus
    renderer.reset_accumulation()
    return focus
