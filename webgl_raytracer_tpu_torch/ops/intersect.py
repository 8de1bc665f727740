"""Ray/box range test on component triples.

Counterpart of intersect_aabb_range in webgl_raytracer_tpu/ops/intersect.py
(the reference viewer's webgl.js:316-362), the one piece of that module
the port needs outside its cluster traversal: the volume march clips its
segment to the density grid's box with it.
"""

from __future__ import annotations

import torch

from .wavefront import BIG


def intersect_aabb_range(bmin, bmax, origin, direction):
    """(hit, t_near, t_far) of rays against one box over an unbounded
    range. bmin, bmax: f32[3]; origin, direction: component triples of
    [N] tensors. An axis with |d| < 1e-8 passes only when the origin lies
    inside its slab; hit needs t_far >= max(t_near, 0)."""
    t_near = t_far = ok = None
    for a in range(3):
        d, o = direction[a], origin[a]
        parallel = d.abs() < 1e-8
        inv = 1.0 / torch.where(parallel, 1.0, d)
        t1 = (bmin[a] - o) * inv
        t2 = (bmax[a] - o) * inv
        near = torch.where(parallel, -BIG, torch.minimum(t1, t2))
        far = torch.where(parallel, BIG, torch.maximum(t1, t2))
        axis_ok = ~parallel | ((o >= bmin[a]) & (o <= bmax[a]))
        if a == 0:
            t_near, t_far, ok = near, far, axis_ok
        else:
            t_near = torch.maximum(t_near, near)
            t_far = torch.minimum(t_far, far)
            ok = ok & axis_ok
    hit = ok & (t_far >= torch.clamp_min(t_near, 0.0))
    return hit, t_near, t_far
