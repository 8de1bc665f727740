"""The stack tracer: closest-hit and any-hit queries by a per-ray walk of
the unified BVH, the reference viewer's traceClosest / traceAny
(webgl.js:556-880).

Counterpart of webgl_raytracer_tpu/ops/traversal.py, whose masked
`lax.while_loop` (_traverse) advances all rays together: each iteration
pops one node per ray whose stack is not empty, tests its box against
the ray's current closest t (t_max for any-hit), intersects up to
max_leaf primitives of a leaf from the leaf-ordered primitive table, and
pushes an inner node's children. The loop ends when every stack is empty
or after max_steps iterations.

trace_closest / trace_any
    Dispatch by tensor device, as ops/trace.py does: a CUDA tensor takes
    the kernel (csrc/trace_stack.cu, launched as trace_stack_closest and
    trace_stack_any; one thread a ray, a batch with an activity mask
    compacted to its live rays first), which raises when its operands
    are not what it takes (walk_args) or it cannot be built or launched;
    a CPU tensor takes the plain walk; impl="plain" forces the plain
    walk. No host value is read on the kernel's path, so a frame on the
    stack tracer can be captured as a CUDA graph.
walk_plain
    The plain walk: the JAX loop body, step by step, over the rays whose
    stack is not empty at that step (the other rays do nothing in a step
    of the JAX loop, so leaving them out changes no bit). It reads the
    host every step and is never captured.

Semantics (the JAX _traverse's, which the kernel repeats):
  * the pop takes stack[sp - 1]; the root is node 0;
  * the slab test is intersect_aabb against the current closest t;
  * a leaf's slots are tested in order, at most max_leaf of them;
    closest-hit accepts t > 0 and t < closest, any-hit t > accept_min and
    t < t_max, and a ray's any-hit walk stops after the step that finds
    one;
  * an inner node the ray's box test passes pushes its right child at
    sp - 1 and its left child at sp, unless sp - 1 > STACK_DEPTH - 2
    (the stack would overflow), when both are dropped;
  * the clip plane rejects triangle hits only;
  * cost counts each pop and each primitive test (traversal.py:243), the
    reference's traversal-cost channel (vis mode 2);
  * an inactive ray starts with an empty stack: a miss, cost 0.

Rays are component triples of [N] tensors (ops/vec3.py); t_min, t_max
and accept_min are numbers, 0-d tensors or [N] tensors; active is None
or bool [N]. The kernel takes each as it is (walk_args): on a CUDA
tensor the rows must be contiguous f32. The tables are the scene's
walk_tables (scene/compile.py), in world coordinates, with the kernel's
packed nodes (pack_nodes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.bvh import DEFAULT_MAX_DEPTH, PRIM_CYLINDER, PRIM_SPHERE, PRIM_TRIANGLE
from .intersect import (clip_reject, intersect_aabb, intersect_cylinder, intersect_sphere,
                        intersect_triangle)
from .kernels import launches
from .trace import _f32, _use_kernel
from .wavefront import BIG, HitRecord, scene_types

DEFAULT_MAX_STEPS = 2048
DEFAULT_MAX_LEAF = 4
# Stack slots a ray needs: the BVH's depth bound plus two, as the JAX
# SceneBuffers' max_depth + 2. Every BVH the port builds for the walk
# (scene/compile._pick_tables) is DEFAULT_MAX_DEPTH deep at most. The
# build passes it to csrc/trace_stack.cu (ops/kernels.compile_flags).
STACK_DEPTH = DEFAULT_MAX_DEPTH + 2


def trace_closest(scene, o3, d3, t_min, clip=None, max_steps: int = DEFAULT_MAX_STEPS,
                  max_leaf: int = DEFAULT_MAX_LEAF, active=None, impl=None) -> HitRecord:
    """Closest hit per ray (traceClosest, webgl.js:556-695): a HitRecord
    whose prim_slot indexes the unified leaf-ordered table (walk_tables),
    t BIG and slot -1 on a miss, extra (cap code, 0, 0) for cylinders and
    (u, v, 0) for triangles, cost the walk's count."""
    t, slot, extra, cost, _ = _trace(scene, o3, d3, t_min, BIG, None, clip, active,
                                     False, max_steps, max_leaf, impl)
    tables = scene.walk_tables
    hit = slot >= 0
    index = torch.clamp_min(slot, 0).long()
    return HitRecord(t=t, prim_type=torch.where(hit, tables.prim_type[index], -1),
                     prim_local=torch.where(hit, tables.prim_local[index], -1),
                     prim_slot=slot, extra=extra, cost=cost)


def trace_any(scene, o3, d3, t_min, t_max=BIG, accept_min=None, clip=None,
              max_steps: int = DEFAULT_MAX_STEPS, max_leaf: int = DEFAULT_MAX_LEAF,
              active=None, impl=None, with_cost: bool = False):
    """Occlusion per ray, bool [N]: a hit with t in (accept_min, t_max),
    accept_min None meaning 0 (traceAny, webgl.js:697-785; with
    accept_min, traceAnyMin, :787-880). with_cost also returns the walk's
    count i32[N]."""
    _, _, _, cost, found = _trace(scene, o3, d3, t_min, t_max, accept_min, clip, active,
                                  True, max_steps, max_leaf, impl)
    return (found, cost) if with_cost else found


def _trace(scene, o3, d3, t_min, t_max, accept_min, clip, active, any_hit, max_steps,
           max_leaf, impl):
    if max_steps < 0 or max_leaf < 0:
        raise ValueError(f"max_steps and max_leaf must be >= 0, not {max_steps}, "
                         f"{max_leaf}")
    tables = scene.walk_tables
    types = scene_types(scene)
    if _use_kernel(o3[0], impl):
        return _walk_cuda(tables, types, o3, d3, t_min, t_max, accept_min, clip, active,
                          any_hit, max_steps, max_leaf)
    return walk_plain(tables, types, o3, d3, t_min, t_max, accept_min, clip, active,
                      any_hit, max_steps, max_leaf)


def _row(x, n, device):
    return _f32(0.0 if x is None else x, device).expand(n)


def _clip_triple(clip, device):
    """clip as ((nx, ny, nz), offset, side) of f32 tensors, or None."""
    if clip is None:
        return None
    normal, offset, side = clip
    if isinstance(normal, torch.Tensor):
        normal = normal.to(device=device, dtype=torch.float32).reshape(3)
        normal = (normal[0], normal[1], normal[2])
    else:
        normal = tuple(_f32(c, device) for c in normal)
    return normal, _f32(offset, device), _f32(side, device)


def _leaf_intersect(tables, types, o3, d3, slot, t_min, clip):
    """(t, e0, e1) of each ray against its gathered table row: t = -1 on a
    miss; (e0, e1) the cap code and 0 for cylinders, (u, v) for
    triangles, 0 otherwise. Only the scene's types are intersected."""
    has_sph, has_cyl, has_tri = types
    pa = tables.prim_a[slot]
    ptype = tables.prim_type[slot]
    a3 = (pa[:, 0], pa[:, 1], pa[:, 2])
    t = torch.full(slot.shape, -1.0, dtype=torch.float32, device=slot.device)
    e0 = torch.zeros_like(t)
    e1 = torch.zeros_like(t)
    if has_sph:
        t_sph = intersect_sphere(o3, d3, a3, pa[:, 3], t_min)
        t = torch.where(ptype == PRIM_SPHERE, t_sph, t)
    if has_cyl or has_tri:
        pb = tables.prim_b[slot]
        b3 = (pb[:, 0], pb[:, 1], pb[:, 2])
    if has_cyl:
        t_cyl, ht = intersect_cylinder(o3, d3, a3, b3, pa[:, 3], t_min)
        sel = ptype == PRIM_CYLINDER
        t = torch.where(sel, t_cyl, t)
        e0 = torch.where(sel, ht, e0)
    if has_tri:
        pc = tables.prim_c[slot]
        t_tri, u, v = intersect_triangle(o3, d3, a3, b3, (pc[:, 0], pc[:, 1], pc[:, 2]),
                                         t_min)
        if clip is not None:
            normal, offset, side = clip
            t_tri = torch.where(clip_reject(o3, d3, t_tri, normal, offset, side), -1.0,
                                t_tri)
        sel = ptype == PRIM_TRIANGLE
        t = torch.where(sel, t_tri, t)
        e0 = torch.where(sel, u, e0)
        e1 = torch.where(sel, v, e1)
    return t, e0, e1


def walk_plain(tables, types, o3, d3, t_min, t_max, accept_min, clip, active, any_hit,
               max_steps, max_leaf):
    """Plain version of the kernel: (t f32[N], slot i32[N], extra
    f32[N,3], cost i32[N], found bool[N]). t starts at t_max (closest-hit:
    BIG); slot is -1 and extra 0 on a miss; found is all False for a
    closest-hit walk."""
    n = o3[0].shape[0]
    device = o3[0].device
    t_min, t_max, accept_lo = (_row(x, n, device) for x in (t_min, t_max, accept_min))
    clip = _clip_triple(clip, device)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=device)
    sp = (torch.ones(n, dtype=torch.int32, device=device) if active is None
          else active.to(torch.int32).clone())
    closest = t_max.clone(memory_format=torch.contiguous_format)
    best = torch.full((n,), -1, dtype=torch.int32, device=device)
    e0 = torch.zeros(n, dtype=torch.float32, device=device)
    e1 = torch.zeros_like(e0)
    cost = torch.zeros(n, dtype=torch.int32, device=device)
    found = torch.zeros(n, dtype=torch.bool, device=device)
    for _ in range(max_steps):
        rows = torch.nonzero(sp > 0).squeeze(1)
        if rows.numel() == 0:
            break
        o = tuple(x[rows] for x in o3)
        d = tuple(x[rows] for x in d3)
        tm, lo, cl = t_min[rows], accept_lo[rows], closest[rows]
        sp_pop = sp[rows] - 1
        node = stack[rows, sp_pop.long()].long()
        bmin, bmax, meta = tables.node_bmin[node], tables.node_bmax[node], tables.node_meta[node]
        left, count, right = meta[:, 0], meta[:, 1], meta[:, 2]
        box_hit = intersect_aabb((bmin[:, 0], bmin[:, 1], bmin[:, 2]),
                                 (bmax[:, 0], bmax[:, 1], bmax[:, 2]), o, d, cl)
        is_leaf = count > 0
        leaf_work = box_hit & is_leaf
        hit_now = torch.zeros_like(box_hit)
        bs, x0, x1 = best[rows], e0[rows], e1[rows]
        tests = torch.zeros_like(sp_pop)
        for k in range(max_leaf):
            valid = leaf_work & (k < count)
            if not bool(valid.any()):
                break
            slot = torch.where(valid, left + k, 0)
            t, a0, a1 = _leaf_intersect(tables, types, o, d, slot.long(), tm, clip)
            if any_hit:
                hit_now = hit_now | (valid & (t > lo) & (t < cl))
            else:
                accept = valid & (t > 0.0) & (t < cl)
                cl = torch.where(accept, t, cl)
                bs = torch.where(accept, slot, bs)
                x0 = torch.where(accept, a0, x0)
                x1 = torch.where(accept, a1, x1)
            tests = tests + valid.to(torch.int32)
        push = box_hit & ~is_leaf & (sp_pop <= STACK_DEPTH - 2)
        if any_hit:
            push = push & ~hit_now
        pr, at = rows[push], sp_pop[push].long()
        stack[pr, at] = right[push]
        stack[pr, at + 1] = left[push]
        new_sp = torch.where(push, sp_pop + 2, sp_pop)
        if any_hit:
            new_sp = torch.where(hit_now, 0, new_sp)
            found[rows] = hit_now
        else:
            closest[rows], best[rows], e0[rows], e1[rows] = cl, bs, x0, x1
        sp[rows] = new_sp
        cost[rows] += 1 + tests
    extra = torch.stack([e0, e1, torch.zeros_like(e0)], dim=1)
    return closest, best, extra, cost, found


def check_links(node_meta) -> None:
    """Raise unless the host node rows (numpy i32[Nn,3]) follow the BVH's
    convention (scene/bvh.py), which pack_nodes encodes: a leaf (count > 0)
    has right child -1, an inner node count 0 and right child >= -1."""
    meta = np.asarray(node_meta)
    count, right = meta[:, 1], meta[:, 2]
    ok = np.where(count > 0, right == -1, (count == 0) & (right >= -1))
    if not ok.all():
        bad = int(np.flatnonzero(~ok)[0])
        raise ValueError(f"BVH node {bad} has links {meta[bad].tolist()}: a leaf's right "
                         "child must be -1, an inner node's count 0")


def pack_nodes(bmin, bmax, meta) -> torch.Tensor:
    """The kernel's node table f32[Nn,8], built with tensor ops on the
    tables' device: a node is two float4s, (bmin xyz, leftFirst) and (bmax
    xyz, link), the ints stored by their bits; link is a leaf's count
    (> 0) or the complement of an inner node's right child (~right <= 0;
    an inner node's count is 0). Rows must pass check_links."""
    left, count, right = meta.unbind(1)
    link = torch.where(count > 0, count, ~right)
    return torch.cat([bmin.contiguous().view(torch.int32), left[:, None],
                      bmax.contiguous().view(torch.int32), link[:, None]],
                     dim=1).view(torch.float32)


def clip_operand(clip, device):
    """cp f32[8]: the plane's normal xyz, offset and side in world
    coordinates, then zeros; None without a plane."""
    clip = _clip_triple(clip, device)
    if clip is None:
        return None
    normal, offset, side = clip
    return torch.cat([torch.stack([*normal, offset, side]),
                      torch.zeros(3, dtype=torch.float32, device=device)])


def type_mask(types) -> int:
    """The kernel's type bits: 1 spheres, 2 cylinders, 4 triangles."""
    has_sph, has_cyl, has_tri = types
    return int(has_sph) | 2 * int(has_cyl) | 4 * int(has_tri)


def walk_args(tables, types, o3, d3, t_min, t_max, accept_min, clip, active, max_steps,
              max_leaf) -> tuple:
    """The stack kernel's arguments before its live list and outputs, each
    operand checked first (ValueError: an origin or direction component
    that is neither one f32 value nor a contiguous f32 [N] row on the
    rays' device, a t_min / t_max / accept_min that is neither that nor a
    number, an activity mask that is not bool [N], a table of the wrong
    type). Tensors stand for their pointers (ops/kernels.launch); the
    operands are the callers' tensors themselves, nothing is staged."""
    from .kernels import check_operand, mask_operand, ray_count, ray_operand, value_operand

    n = ray_count(o3[0].shape[0])
    device = o3[0].device
    rows = [v for x, name in zip((*o3, *d3), ("ox", "oy", "oz", "dx", "dy", "dz"))
            for v in ray_operand(x, n, device, name)]
    values = [v for x, name in ((t_min, "t_min"), (t_max, "t_max"),
                                (0.0 if accept_min is None else accept_min, "accept_min"))
              for v in value_operand(x, n, device, name)]
    tabs = [(tables.nodes, torch.float32), (tables.prim_a, torch.float32),
            (tables.prim_b, torch.float32), (tables.prim_c, torch.float32),
            (tables.prim_type, torch.int32)]
    for x, dt in tabs:
        check_operand(x, dt, device)
    cp = clip_operand(clip, device)
    return (*rows, *values, mask_operand(active, n, device), n, *(x for x, _ in tabs),
            type_mask(types), cp, int(cp is not None), int(max_steps), int(max_leaf))


def _walk_cuda(tables, types, o3, d3, t_min, t_max, accept_min, clip, active, any_hit,
               max_steps, max_leaf):
    from .kernels import launch, live_list

    args = walk_args(tables, types, o3, d3, t_min, t_max, accept_min, clip, active,
                     max_steps, max_leaf)
    device = o3[0].device
    n = o3[0].shape[0]
    cost = torch.empty(n, dtype=torch.int32, device=device)
    if any_hit:
        name = "trace_stack_any"
        found = torch.empty(n, dtype=torch.bool, device=device)
        outs = (found, cost)
        t = slot = extra = None
    else:
        name = "trace_stack_closest"
        t = torch.empty(n, dtype=torch.float32, device=device)
        slot = torch.empty(n, dtype=torch.int32, device=device)
        extra = torch.empty((n, 3), dtype=torch.float32, device=device)
        outs = (t, slot, extra, cost)
        found = None
    if n:
        # A batch with a mask is compacted to its live rays first.
        live = (None, None) if active is None else live_list(n, device)
        err = launch("wrt_" + name, device, *args, *live, *outs)
        if err != 0:
            raise RuntimeError(f"wrt_{name} failed: CUDA error {err}")
        launches[name] += 1
    return t, slot, extra, cost, found
