"""The hand-written Hopper trace kernels, their plain PyTorch versions,
the scene-centred operands they share and the per-ray routing.

trace_closest
    Replaces `_make_closest_kernel` (webgl_raytracer_tpu/ops/pallas_trace.py,
    reached through `trace_closest` and `_grid_call`): the closest hit per
    ray over the cluster SoA, for spheres, capped cylinders and
    Moller-Trumbore triangles with clip-plane rejection.
trace_any3
    Replaces `_make_any3_kernel` (same file, reached through `trace_any3`
    and `_grid_call3`): occlusion of three co-origin rays per lane, the
    3-cone-light shadow fan.
trace_any
    Replaces `_make_any_kernel` (same file, reached through `trace_any`
    and `_grid_call`): occlusion of one ray per lane with t in
    (accept_min, t_max), the env-NEE shadow query.
trace_closest_attrs
    Replaces `_make_closest_attrs_kernel` (same file, reached through
    `trace_closest_attrs` and `_grid_call_attrs`): the closest hit as
    trace_closest finds it, plus the winner's 32-column attribute row
    (attr_operand's layout), so that shading needs no gather.
trace_closest_perray / trace_any_perray (trace_closest / trace_any with perray=True)
    Replace `_make_closest_kernel_perray` / `_make_any_kernel_perray`
    (same file, reached through `trace_closest` / `trace_any` with
    perray=True and `_grid_call_perray`): the same functions, each ray
    walking its own clusters front to back; above 128 clusters an outer
    front-to-back walk over 128-cluster groups by group AABB.

What bounds them on the H100: per-ray FP32 intersector arithmetic. At the
1000-sphere scene's K = 12 clusters the whole cluster table is 72 KB; at
10k spheres (K = 128) 786 KB and at 150k (K = 1976) 12 MB, all inside the
50 MB L2, so the traces are compute-bound, not bandwidth-bound. The block
kernels (csrc/trace_closest.cu, trace_any3.cu, trace_any.cu,
trace_closest_attrs.cu) take a root-AABB gate, then walk the clusters in
index order, skipping each cluster whose AABB the ray misses or enters at
or beyond its current best t (or t_max), warp by warp: the warp's need
mask is a ballot, and the lanes sweep a needed cluster for one ray at a
time, each lane testing 4 of its 128 primitives held in registers.
trace_closest and trace_closest_attrs share that walk (intersect.cuh
closest_walk); the attrs kernel then copies the winners' rows, 512
contiguous bytes a warp store. From 64 clusters the occlusion kernels
trace_any3 and trace_any take the ray-major schedule instead: the warp
takes its pending rays one at a time and tests 32 cluster boxes a step.
The per-ray kernels (trace_closest_perray.cu, trace_any_perray.cu) walk
each ray's own clusters front to back, warp by warp: the warp takes its
rays one at a time, each lane tests 4 cluster boxes of the ray's group,
warp reductions pop the nearest entry, and the warp sweeps the popped
cluster from global memory (L2), as above.
The TPU's block worklists are schedule choices and are not carried over;
the outputs do not depend on the visiting order (see the tie-break below).

Routing follows the JAX package (pallas_trace.perray_auto_secondary /
perray_auto_any): secondary closest traces and divergent occlusion batches
go per-ray on scenes of PERRAY_MIN_CLUSTERS = 64 or more clusters whose
primitives are one type or spheres + cylinders. The threshold was measured
on a TPU; it stands until an H100 measurement replaces it.

Semantics shared by the kernels and their plain versions:
  * operands are centred on the scene midpoint exactly as
    pallas_trace._scene_operands / _ray_operands centre them, so `t` is
    rounded in centred coordinates (wavefront._finalize_hit refines sphere
    winners afterwards); padding primitives carry NaN radii;
  * tie-break: the lexicographic minimum of (t, row), row = cluster*128 +
    lane. The TPU kernel's rule (strict < per lane slot in visiting order,
    then the lowest packed row) equals it except for exactly equal t from
    two clusters in the same lane slot. The per-ray walks reach the same
    minimum in another cluster order; they can differ from the index-order
    walk only where a skipped cluster's entry equals the best t exactly
    and holds a primitive at that same t with a lower row, or where a
    grazing primitive's t rounds below its own cluster's entry;
  * a cluster is swept only where the ray enters its AABB before the
    current best t (closest) or before t_max (occlusion); occlusion is an
    order-free OR over those clusters, so all occlusion kernels agree bit
    for bit;
  * inactive lanes return a miss (t = BIG, row = -1; occlusion bits 0).

Counts (with_cost=True; the JAX package's with_cost outputs). Each trace
can also return i32[N]: C = 128 times the clusters whose primitives were
swept for the ray, in the order its kernel visits them. An inactive ray,
and one that misses the root box, gets 0; a cluster counts once, also
where its sweep stops after the 32-primitive step that holds an
occluding hit. trace_closest charges each cluster, in index order, whose
entry lies before the ray's best t so far (the need mask of intersect.cuh
closest_walk); trace_any each cluster, in index order, entered before
t_max up to and including the first that occludes it (both schedules
visit in index order, so both give it); trace_any3 the sum of that over
its three directions; the per-ray kernels each cluster they pop, group by
group. The JAX block kernels charge every ray its 1024-ray block's
union, which belongs to the TPU's schedule: the port counts per ray. The
counting forms are kernels of their own (trace_closest_cost,
trace_any3_cost, trace_any_cost, trace_closest_perray_cost,
trace_any_perray_cost: the same source compiled with the counter), so
the default forms are the code they were.

Dispatch is by tensor device: a CPU tensor takes the plain version, a CUDA
tensor the kernel, which raises when it cannot be built or launched.
`impl="plain"` forces the plain version on a CUDA tensor (used to compare
the two). `launches` counts each kernel's launches by name, incremented
only where the kernel is launched.

The kernels build with -fmad=false so that every a*b+c rounds twice, as
the plain version's separate tensor ops do; then integer outputs and t
agree bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .kernels import launches
from .wavefront import BIG, INF, cluster_entry_t, intersect_soa_t, scene_types

# Rays per plain-version chunk: keeps the [chunk, 128] temporaries of the
# intersector at a few hundred MB each trace.
PLAIN_CHUNK = 65536


@dataclass
class TraceOperands:
    """Scene-side operands, centred on the scene midpoint."""
    soa: torch.Tensor      # f32[K,12,C]; positional rows shifted by -mid,
    #                        NaN radius on padding primitives
    box: torch.Tensor      # f32[K,6]: centred bmin xyz, bmax xyz
    gbox: torch.Tensor     # f32[G,6]: AABBs of the groups of GROUP clusters
    mid: torch.Tensor      # f32[3]
    ctype: torch.Tensor    # i32[K]: the cluster's primitive type, -1 mixed
    ctype_host: tuple      # the same, as python ints (plain version)
    root: torch.Tensor     # f32[6]: centred scene AABB
    types: tuple           # (has_spheres, has_cylinders, has_triangles)
    attr: torch.Tensor     # f32[K*C,32]: attr_operand, the attrs kernel's table


# Clusters per group of the per-ray kernels' two-level walk (the JAX
# package's 128-lane group); csrc/intersect.cuh kGroup.
GROUP = 128


def scene_operands(scene) -> TraceOperands:
    """The centring of pallas_trace._scene_operands, in the kernels' own
    layout: the SoA stays [K,12,C] (no TPU row padding) and the AABBs stay
    per cluster (no lane packing); group boxes cover clusters
    [g*GROUP, (g+1)*GROUP). A group box contains its clusters' boxes, and
    slab entries round monotonically, so a group's entry is never later
    than any of its clusters' entries and a ray that misses it misses
    them all."""
    soa = scene.cluster_soa
    bmin = scene.cluster_bmin
    bmax = scene.cluster_bmax
    mid = 0.5 * (bmin.min(dim=0).values + bmax.max(dim=0).values)
    zero = torch.zeros((), dtype=torch.float32, device=soa.device)
    shift = torch.stack([mid[0], mid[1], mid[2], zero,
                         mid[0], mid[1], mid[2], zero,
                         mid[0], mid[1], mid[2], zero])
    soa_c = soa - shift[None, :, None]
    soa_c[:, 3, :] = torch.where(soa[:, 11, :] < 0.0, float("nan"),
                                 soa_c[:, 3, :])
    prow = soa[:, 11, :]
    valid = prow >= 0
    tmax = torch.where(valid, prow, -1.0).max(dim=1).values
    tmn = torch.where(valid, prow, 99.0).min(dim=1).values
    ctype = torch.where((tmax == tmn) & (tmax >= 0), tmax, -1.0).to(torch.int32)
    box = torch.cat([bmin - mid[None, :], bmax - mid[None, :]], dim=1)
    root = torch.cat([bmin.min(dim=0).values - mid, bmax.max(dim=0).values - mid])
    gbox = torch.stack([torch.cat([g[:, :3].min(dim=0).values, g[:, 3:].max(dim=0).values])
                        for g in box.split(GROUP)])
    return TraceOperands(
        soa=soa_c.contiguous(), box=box.contiguous(), gbox=gbox.contiguous(), mid=mid,
        ctype=ctype.contiguous(),
        ctype_host=tuple(int(c) for c in ctype.cpu().tolist()),
        root=root, types=scene_types(scene), attr=attr_operand(scene))


ATTR_MISS_COL = 11      # attr row column holding the primitive type (-1: miss)
ATTR_SLOT_COL = 28      # attr row column holding the flat slot as f32


def attr_operand(scene) -> torch.Tensor:
    """The attrs kernel's table f32[K*C, 32] (pallas_trace._attr_operand):
    columns 0-11 the slot's cluster row in GLOBAL coordinates, 12-27
    cluster_attr (colour, triangle vertex normals, flag), 28 the flat slot
    as f32 (exact below 2^24), 29-31 zero."""
    k, c = scene.cluster_prims.shape[:2]
    dev = scene.cluster_prims.device
    slot = torch.arange(k * c, dtype=torch.float32, device=dev).reshape(k, c, 1)
    return torch.cat([scene.cluster_prims, scene.cluster_attr, slot,
                      torch.zeros((k, c, 3), dtype=torch.float32, device=dev)],
                     dim=2).reshape(k * c, 32).contiguous()


def attr_slot(attrs: torch.Tensor) -> torch.Tensor:
    """i32[N] flat slot of each attribute row's primitive, -1 on a miss."""
    return torch.where(attrs[:, ATTR_MISS_COL] >= 0.0,
                       attrs[:, ATTR_SLOT_COL].to(torch.int32), -1)


def kernel_supported(scene) -> bool:
    """The scenes the CUDA trace kernels take: clusters of 128 primitives.
    The integrator's transports route by it where the JAX package asks
    whether its Pallas kernels run."""
    return scene.cluster_size == 128


def clip_operand(clip, ops: TraceOperands):
    """(cp f32[16], clip_on): clip plane in slots 0-4, centred (the plane
    n.x = off becomes n.(x - mid) = off - n.mid), and the root AABB in
    slots 8-13 — pallas_trace._scalar_operand's layout."""
    device = ops.mid.device
    z = torch.zeros(3, dtype=torch.float32, device=device)
    if clip is None:
        head = torch.zeros(5, dtype=torch.float32, device=device)
        clip_on = False
    else:
        normal, offset, side = clip
        normal = torch.as_tensor(normal, dtype=torch.float32, device=device).reshape(3)
        offset = _f32(offset, device)
        side = _f32(side, device)
        mid = ops.mid
        off_c = offset - (normal[0] * mid[0] + normal[1] * mid[1]
                          + normal[2] * mid[2])
        head = torch.cat([normal, off_c.reshape(1), side.reshape(1)])
        clip_on = True
    cp = torch.cat([head, z, ops.root, z[:2]]).contiguous()
    return cp, clip_on


def _clip_of(cp, clip_on):
    if not clip_on:
        return None
    return ((cp[0], cp[1], cp[2]), cp[3], cp[4])


def _use_kernel(x: torch.Tensor, impl) -> bool:
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', not {impl!r}")
    if impl == "plain":
        return False
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"no trace implementation for device {x.device}")
    return False


def _f32(x, device) -> torch.Tensor:
    """x as an f32 tensor on `device`: a tensor is converted, a number
    becomes a fill, so that no host value is copied to the card (which a
    captured frame cannot do)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def _f32_row(x, n, device):
    return _f32(x, device).expand(n)


# ---------------------------------------------------------------------------
# Per-ray routing (pallas_trace.perray_supported / perray_auto_*).

MIN_CLUSTERS = 4              # pallas_trace.MIN_CLUSTERS
PERRAY_MAX_CLUSTERS = 4096    # pallas_trace.PERRAY_MAX_CLUSTERS
PERRAY_MIN_CLUSTERS = 64      # pallas_trace.PERRAY_MIN_CLUSTERS (a TPU measurement)


def perray_types(scene) -> tuple:
    """The JAX package's per-ray mode (pallas_trace._perray_mode) as its
    intersector set: the scene's one type, spheres + cylinders, or all
    three. Routing reads it: three-type mixes stay on the block kernels."""
    types = scene_types(scene)
    if sum(types) == 1:
        return types
    if types[0] and types[1] and not types[2]:
        return (True, True, False)
    return (True, True, True)


def perray_supported(scene) -> bool:
    """pallas_trace.perray_supported. Its 4..4096 cluster range is a TPU
    limit, kept only so that the routing matches the JAX package's; the
    CUDA kernels take any K."""
    return (MIN_CLUSTERS <= scene.num_clusters <= PERRAY_MAX_CLUSTERS
            and scene.cluster_size == 128)


def perray_auto_secondary(scene) -> bool:
    """Secondary (divergent) closest traces go per-ray on cluster-rich
    scenes of one type or spheres + cylinders."""
    return (perray_supported(scene) and scene.num_clusters >= PERRAY_MIN_CLUSTERS
            and sum(perray_types(scene)) <= 2)


def perray_auto_any(scene, divergent: bool = False) -> bool:
    """Occlusion batches go per-ray only when divergent (env NEE) and the
    scene qualifies as for secondary closest traces; co-directional
    shadow fans stay on the block kernels."""
    return divergent and perray_auto_secondary(scene)


# ---------------------------------------------------------------------------
# Closest hit.


def closest_operand(o3, d3, t_min, active, mid):
    """od f32[8,N]: rows 0-2 direction, 3-5 centred origin, 6 t_min,
    7 activity (1/0)."""
    n = o3[0].shape[0]
    device = o3[0].device
    act = (torch.ones(n, dtype=torch.float32, device=device) if active is None
           else active.to(torch.float32))
    return torch.stack([
        d3[0], d3[1], d3[2],
        o3[0] - mid[0], o3[1] - mid[1], o3[2] - mid[2],
        _f32_row(t_min, n, device), act]).contiguous()


def trace_closest(scene, o3, d3, t_min, clip=None, active=None, perray=False,
                  impl=None, with_cost=False):
    """Closest hit: (t f32[N] with BIG on a miss, row i32[N] with -1 on a
    miss), rows indexing the [K*C] cluster slots. perray=True takes the
    per-ray walk (kernel trace_closest_perray); the result is the same.
    with_cost appends the ray's count i32[N] (module docstring, "Counts"),
    through the kernel's cost form (trace_closest_cost,
    trace_closest_perray_cost) on the card."""
    ops = scene.trace_operands
    od = closest_operand(o3, d3, t_min, active, ops.mid)
    cp, clip_on = clip_operand(clip, ops)
    if _use_kernel(od, impl):
        out = _closest_cuda(ops, od, cp, clip_on, perray, with_cost)
    elif perray:
        t, row, _, cost = _perray_walk(ops, od, cp, clip_on, any_hit=False)
        out = (t, row, cost)
    else:
        out = closest_plain(ops, od, cp, clip_on, with_cost=True)
    return out if with_cost else out[:2]


def closest_plain(ops: TraceOperands, od, cp, clip_on, with_cost=False):
    """Plain version of the closest kernel on the same operands: the same
    cluster walk (index order, skip at entry >= best), as dense masked
    [chunk, C] tensor sweeps. with_cost appends the count: C x the
    clusters whose entry lies before the ray's best t when the walk
    reaches them (the kernel's need mask)."""
    n = od.shape[1]
    device = od.device
    c = ops.soa.shape[-1]
    clip = _clip_of(cp, clip_on)
    lane = torch.arange(c, dtype=torch.int32, device=device)
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=device)
    row_out = torch.full((n,), -1, dtype=torch.int32, device=device)
    cost_out = torch.zeros((n,), dtype=torch.int32, device=device)
    for s in range(0, n, PLAIN_CHUNK):
        sl = slice(s, min(n, s + PLAIN_CHUNK))
        d3 = (od[0, sl], od[1, sl], od[2, sl])
        o3 = (od[3, sl], od[4, sl], od[5, sl])
        tmin = od[6, sl]
        act = od[7, sl] > 0.0
        entry = cluster_entry_t(ops.box[:, :3], ops.box[:, 3:], o3, d3)
        entry = torch.where(act[:, None], entry, INF)
        best = t_out[sl].clone()
        row = row_out[sl].clone()
        swept = cost_out[sl].clone()
        for k, ct in enumerate(ops.ctype_host):
            need = entry[:, k] < best
            if not bool(need.any()):
                continue
            swept += need.to(torch.int32)
            ts = intersect_soa_t(_cluster_types(ct, ops.types), ops.soa[k],
                                 o3, d3, tmin, clip)
            valid = need[:, None] & (ts > 0.0) & (ts < best[:, None])
            tm = torch.where(valid, ts, INF)
            tb = tm.min(dim=1).values
            j = torch.where(tm == tb[:, None], lane, c).min(dim=1).values
            upd = tb < best
            best = torch.where(upd, tb, best)
            row = torch.where(upd, k * c + j, row)
        t_out[sl] = best
        row_out[sl] = row
        cost_out[sl] = swept * c
    if with_cost:
        return t_out, row_out, cost_out
    return t_out, row_out


def _cluster_types(ct: int, scene_types_: tuple) -> tuple:
    """Intersectors a cluster needs: its own type, or every type of the
    scene for a mixed (hand-built) cluster."""
    if ct < 0:
        return scene_types_
    return (ct == 1, ct == 2, ct == 0)


def _launch(name: str, ops: TraceOperands, od, cp, clip_on, outs, group=False,
            tables=()):
    """Check the operands and launch kernel `name` of the library on od's
    card and stream: (od, n, soa, box, [gbox, G,] ctype, K, cp, clip_on, *tables,
    *outs); tables: (tensor, dtype) inputs. Raises on a refused launch."""
    from .kernels import check_operand, launch

    if ops.soa.shape[-1] != 128:
        raise ValueError("the CUDA trace kernels take clusters of 128 primitives")
    for x, dt in ((od, torch.float32), (ops.soa, torch.float32),
                  (ops.box, torch.float32), (ops.gbox, torch.float32),
                  (ops.ctype, torch.int32), (cp, torch.float32), *tables):
        check_operand(x, dt, od.device)
    groups = (ops.gbox.data_ptr(), ops.gbox.shape[0]) if group else ()
    err = launch(
        name, od.device, od.data_ptr(), od.shape[1], ops.soa.data_ptr(),
        ops.box.data_ptr(), *groups, ops.ctype.data_ptr(), ops.soa.shape[0],
        cp.data_ptr(), int(clip_on), *(x.data_ptr() for x, _ in tables),
        *(o.data_ptr() for o in outs))
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def _closest_cuda(ops: TraceOperands, od, cp, clip_on, perray=False, with_cost=False):
    """(t, row, cost): cost is None unless with_cost, which launches the
    kernel's cost form."""
    name = ("trace_closest_perray" if perray else "trace_closest") + (
        "_cost" if with_cost else "")
    n = od.shape[1]
    outs = [torch.empty(n, dtype=torch.float32, device=od.device),
            torch.empty(n, dtype=torch.int32, device=od.device)]
    if with_cost:
        outs.append(torch.empty(n, dtype=torch.int32, device=od.device))
    if n:
        _launch("wrt_" + name, ops, od, cp, clip_on, outs, group=perray)
        launches[name] += 1
    return outs[0], outs[1], (outs[2] if with_cost else None)


# ---------------------------------------------------------------------------
# Closest hit with the winner's attribute row.


def trace_closest_attrs(scene, o3, d3, t_min, clip=None, active=None, impl=None):
    """Closest hit and the winner's attribute row: (t f32[N], BIG on a
    miss; attrs f32[N,32], attr_operand's row of the winning slot). A miss,
    an inactive lane included, gets an all-zero row with column 11 = -1.
    t is trace_closest's (scene-centred rounding); the row carries
    everything _finalize_hit and shading read, so neither gathers."""
    ops = scene.trace_operands
    od = closest_operand(o3, d3, t_min, active, ops.mid)
    cp, clip_on = clip_operand(clip, ops)
    if _use_kernel(od, impl):
        n = od.shape[1]
        t = torch.empty(n, dtype=torch.float32, device=od.device)
        attrs = torch.empty((n, 32), dtype=torch.float32, device=od.device)
        if n:
            if ops.attr.data_ptr() % 16 or attrs.data_ptr() % 16:
                raise ValueError("the attrs kernel moves rows as 16-byte vectors")
            _launch("wrt_trace_closest_attrs", ops, od, cp, clip_on, (t, attrs),
                    tables=((ops.attr, torch.float32),))
            launches["trace_closest_attrs"] += 1
        return t, attrs
    return closest_attrs_plain(ops, od, cp, clip_on)


def closest_attrs_plain(ops: TraceOperands, od, cp, clip_on):
    """Plain version of the attrs kernel: the closest walk, then a gather
    of the winner's table row (the miss row where there is none)."""
    t, row = closest_plain(ops, od, cp, clip_on)
    hit = row >= 0
    attrs = torch.where(hit[:, None], ops.attr[torch.clamp_min(row, 0).long()], 0.0)
    attrs[:, ATTR_MISS_COL] = torch.where(hit, attrs[:, ATTR_MISS_COL], -1.0)
    return t, attrs


# ---------------------------------------------------------------------------
# Three-direction shadow fan.


def any3_operand(o3, d3s, t_min, accept_lo, actives, mid):
    """od f32[16,N] (pallas_trace.trace_any3's layout): rows 0-2 d0,
    3-5 centred origin, 6 activity bitmask a0 + 2 a1 + 4 a2, 7 unused,
    8 t_min, 9 accept_lo, 10-12 d1, 13-15 d2."""
    n = o3[0].shape[0]
    device = o3[0].device
    amask = torch.zeros(n, dtype=torch.float32, device=device)
    for j, a in enumerate(actives):
        bit = (torch.ones(n, dtype=torch.float32, device=device) if a is None
               else a.to(torch.float32))
        amask = amask + bit * float(1 << j)
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    return torch.stack([
        d3s[0][0], d3s[0][1], d3s[0][2],
        o3[0] - mid[0], o3[1] - mid[1], o3[2] - mid[2],
        amask, zero, _f32_row(t_min, n, device),
        _f32_row(accept_lo, n, device),
        d3s[1][0], d3s[1][1], d3s[1][2],
        d3s[2][0], d3s[2][1], d3s[2][2]]).contiguous()


def trace_any3(scene, o3, d3s, t_min, accept_min=None, clip=None,
               actives=(None, None, None), impl=None, with_cost=False):
    """Occlusion of three co-origin rays per lane with t in (accept_min,
    BIG): (occ0, occ1, occ2) bool [N]. d3s: three direction triples;
    actives: three candidate masks (None = all live). with_cost returns
    ((occ0, occ1, occ2), cost i32[N]) as the JAX package's trace_any3
    does, the count summed over the three directions (trace_any3_cost on
    the card)."""
    ops = scene.trace_operands
    lo = 0.0 if accept_min is None else accept_min
    od = any3_operand(o3, d3s, t_min, lo, actives, ops.mid)
    cp, clip_on = clip_operand(clip, ops)
    if _use_kernel(od, impl):
        bits, cost = _any3_cuda(ops, od, cp, clip_on, with_cost)
    else:
        bits, cost = any3_plain(ops, od, cp, clip_on, with_cost=True)
    occ = tuple((bits & (1 << j)) != 0 for j in range(3))
    return (occ, cost) if with_cost else occ


def any3_plain(ops: TraceOperands, od, cp, clip_on, with_cost=False):
    """Plain version of the shadow-fan kernel on the same operands:
    i32[N] bitmask, bit j set when direction j is occluded. Direction j
    sweeps cluster k only where its ray enters k's AABB and is unresolved
    (the relevance gate; occlusion is an order-free OR, so gating never
    changes a bit). with_cost appends the count: C x the (direction,
    cluster) sweeps, in index order, each direction's up to and including
    the first cluster that occludes it."""
    n = od.shape[1]
    device = od.device
    c = ops.soa.shape[-1]
    clip = _clip_of(cp, clip_on)
    bits_out = torch.zeros(n, dtype=torch.int32, device=device)
    cost_out = torch.zeros(n, dtype=torch.int32, device=device)
    for s in range(0, n, PLAIN_CHUNK):
        sl = slice(s, min(n, s + PLAIN_CHUNK))
        o3 = (od[3, sl], od[4, sl], od[5, sl])
        tmin = od[8, sl]
        lo = od[9, sl][:, None]
        am = od[6, sl].to(torch.int32)
        dirs = [(od[r, sl], od[r + 1, sl], od[r + 2, sl]) for r in (0, 10, 13)]
        entries, found = [], []
        swept = torch.zeros_like(am)
        for j in range(3):
            act = (am & (1 << j)) != 0
            e = cluster_entry_t(ops.box[:, :3], ops.box[:, 3:], o3, dirs[j])
            entries.append(torch.where(act[:, None], e, INF))
            found.append(torch.zeros_like(act))
        for k, ct in enumerate(ops.ctype_host):
            types = _cluster_types(ct, ops.types)
            for j in range(3):
                need = (entries[j][:, k] < INF) & ~found[j]
                if not bool(need.any()):
                    continue
                swept += need.to(torch.int32)
                ts = intersect_soa_t(types, ops.soa[k], o3, dirs[j], tmin, clip)
                hit = ((ts > lo) & (ts < BIG)).any(dim=1)
                found[j] = found[j] | (hit & need)
        bits_out[sl] = (found[0].to(torch.int32) + 2 * found[1].to(torch.int32)
                        + 4 * found[2].to(torch.int32))
        cost_out[sl] = swept * c
    if with_cost:
        return bits_out, cost_out
    return bits_out


def _any3_cuda(ops: TraceOperands, od, cp, clip_on, with_cost=False):
    """(bits, cost): cost is None unless with_cost (trace_any3_cost)."""
    name = "trace_any3_cost" if with_cost else "trace_any3"
    n = od.shape[1]
    outs = [torch.empty(n, dtype=torch.int32, device=od.device)]
    if with_cost:
        outs.append(torch.empty(n, dtype=torch.int32, device=od.device))
    if n:
        _launch("wrt_" + name, ops, od, cp, clip_on, outs)
        launches[name] += 1
    return outs[0], (outs[1] if with_cost else None)


# ---------------------------------------------------------------------------
# Plain version of the per-ray walks.


def _perray_walk(ops: TraceOperands, od, cp, clip_on, any_hit: bool):
    """Plain version of the per-ray kernels' walk (intersect.cuh
    perray_walk), group by group: each ray pops its nearest unvisited
    group of GROUP clusters (lowest group among equal entries) while that
    entry is before its cap, and inside the group its nearest unvisited
    cluster (lowest index among equal entries) while that entry is before
    its cap. The cap is the best t so far (closest; the lexicographic (t,
    row) update) or t_max (occlusion, until a hit is found). od is
    closest_operand's layout, or any_operand's when any_hit. A flat walk
    over all clusters gives the same (t, row) and bits but, above GROUP
    clusters, another count: it can skip a cluster of an early group that
    the group walk sweeps before a later group lowers the best t.
    Returns (t, row, found, cost), cost C x the clusters popped."""
    n = od.shape[1]
    device = od.device
    k, c = ops.soa.shape[0], ops.soa.shape[-1]
    g = ops.gbox.shape[0]
    clip = _clip_of(cp, clip_on)
    gio = torch.arange(g, device=device)
    lane = torch.arange(c, device=device)
    jio = torch.arange(GROUP, device=device)
    t_out = torch.full((n,), BIG, dtype=torch.float32, device=device)
    row_out = torch.full((n,), -1, dtype=torch.int32, device=device)
    found_out = torch.zeros((n,), dtype=torch.bool, device=device)
    cost_out = torch.zeros((n,), dtype=torch.int32, device=device)
    for s in range(0, n, PLAIN_CHUNK):
        sl = slice(s, min(n, s + PLAIN_CHUNK))
        m = sl.stop - sl.start
        d3 = (od[0, sl], od[1, sl], od[2, sl])
        o3 = (od[3, sl], od[4, sl], od[5, sl])
        tmin = od[6, sl]
        act = od[7, sl] > 0.0
        entry = torch.full((m, g * GROUP), INF, dtype=torch.float32, device=device)
        entry[:, :k] = cluster_entry_t(ops.box[:, :3], ops.box[:, 3:], o3, d3)
        entry = torch.where(act[:, None], entry, INF).reshape(m, g, GROUP)
        gent = torch.where(act[:, None],
                           cluster_entry_t(ops.gbox[:, :3], ops.gbox[:, 3:], o3, d3), INF)
        if any_hit:
            cap, lo = od[8, sl], od[9, sl]
        best, row = t_out[sl].clone(), row_out[sl].clone()
        found, cost = found_out[sl].clone(), cost_out[sl].clone()
        grp = torch.full((m,), -1, dtype=torch.int64, device=device)
        live = act.clone()
        while True:
            limit = cap if any_hit else best
            # Rays between groups pop their next group, or end their walk.
            rs = (live & (grp < 0)).nonzero().squeeze(1)
            if rs.numel():
                ge = gent[rs]
                gm = ge.min(dim=1).values
                gi = torch.where(ge == gm[:, None], gio, g).min(dim=1).values
                ok = gm < limit[rs]
                live[rs[~ok]] = False
                rs, gi = rs[ok], gi[ok]
                grp[rs] = gi
                gent[rs, gi] = INF
            # Rays inside a group pop their next cluster, or leave the group.
            rs = (live & (grp >= 0)).nonzero().squeeze(1)
            if rs.numel() == 0:
                if not bool(live.any()):
                    break
                continue
            gr = grp[rs]
            er = entry[rs, gr]
            em = er.min(dim=1).values
            go = em < limit[rs]
            grp[rs[~go]] = -1
            rs, gr, er, em = rs[go], gr[go], er[go], em[go]
            if rs.numel() == 0:
                continue
            j = torch.where(er == em[:, None], jio, GROUP).min(dim=1).values
            entry[rs, gr, j] = INF
            idx = gr * GROUP + j
            cost[rs] += c
            ts = intersect_soa_t(ops.types, ops.soa[idx],
                                 tuple(x[rs] for x in o3), tuple(x[rs] for x in d3),
                                 tmin[rs], clip)
            if any_hit:
                hit = ((ts > lo[rs, None]) & (ts < cap[rs, None])).any(dim=1)
                found[rs] = hit
                live[rs[hit]] = False
                continue
            tm = torch.where(ts > 0.0, ts, INF)
            tb = tm.min(dim=1).values
            cand = (idx * c + torch.where(tm == tb[:, None], lane, c).min(dim=1).values
                    ).to(torch.int32)
            b0, r0 = best[rs], row[rs]
            upd = (tb < b0) | ((tb == b0) & (cand < r0))
            best[rs] = torch.where(upd, tb, b0)
            row[rs] = torch.where(upd, cand, r0)
        t_out[sl], row_out[sl], found_out[sl], cost_out[sl] = best, row, found, cost
    return t_out, row_out, found_out, cost_out


# ---------------------------------------------------------------------------
# Single-direction occlusion (block and per-ray).


def any_operand(o3, d3, t_min, t_max, accept_lo, active, mid):
    """od f32[10,N]: rows 0-2 direction, 3-5 centred origin, 6 t_min,
    7 activity (1/0), 8 t_max, 9 accept_lo."""
    n = o3[0].shape[0]
    device = o3[0].device
    act = (torch.ones(n, dtype=torch.float32, device=device) if active is None
           else active.to(torch.float32))
    return torch.stack([
        d3[0], d3[1], d3[2],
        o3[0] - mid[0], o3[1] - mid[1], o3[2] - mid[2],
        _f32_row(t_min, n, device), act, _f32_row(t_max, n, device),
        _f32_row(accept_lo, n, device)]).contiguous()


def trace_any(scene, o3, d3, t_min, t_max=BIG, accept_min=None, clip=None,
              active=None, perray=False, impl=None, with_cost=False):
    """Occlusion: bool [N], True where some primitive is hit with t in
    (accept_min, t_max). perray=True takes the per-ray walk (kernel
    trace_any_perray); the bits are the same. with_cost returns (bits,
    cost i32[N]) (trace_any_cost, trace_any_perray_cost on the card)."""
    ops = scene.trace_operands
    od = any_operand(o3, d3, t_min, t_max, 0.0 if accept_min is None else accept_min,
                     active, ops.mid)
    cp, clip_on = clip_operand(clip, ops)
    if _use_kernel(od, impl):
        name = ("trace_any_perray" if perray else "trace_any") + (
            "_cost" if with_cost else "")
        n = od.shape[1]
        outs = [torch.empty(n, dtype=torch.int32, device=od.device)]
        if with_cost:
            outs.append(torch.empty(n, dtype=torch.int32, device=od.device))
        if n:
            _launch("wrt_" + name, ops, od, cp, clip_on, outs, group=perray)
            launches[name] += 1
        found, cost = outs[0] != 0, (outs[1] if with_cost else None)
    elif perray:
        _, _, found, cost = _perray_walk(ops, od, cp, clip_on, any_hit=True)
    else:
        found, cost = any_plain(ops, od, cp, clip_on, with_cost=True)
    return (found, cost) if with_cost else found


def any_plain(ops: TraceOperands, od, cp, clip_on, with_cost=False):
    """Plain version of the occlusion kernel on the same operands: bool
    [N]. Cluster k is swept for a ray still unresolved whose entry into
    k's AABB is before its t_max. with_cost appends the count: C x the
    clusters so swept, in index order, up to and including the first one
    that occludes the ray (either schedule of the kernel)."""
    n = od.shape[1]
    c = ops.soa.shape[-1]
    clip = _clip_of(cp, clip_on)
    found_out = torch.zeros((n,), dtype=torch.bool, device=od.device)
    cost_out = torch.zeros((n,), dtype=torch.int32, device=od.device)
    for s in range(0, n, PLAIN_CHUNK):
        sl = slice(s, min(n, s + PLAIN_CHUNK))
        d3 = (od[0, sl], od[1, sl], od[2, sl])
        o3 = (od[3, sl], od[4, sl], od[5, sl])
        tmin, cap, lo = od[6, sl], od[8, sl][:, None], od[9, sl][:, None]
        entry = cluster_entry_t(ops.box[:, :3], ops.box[:, 3:], o3, d3)
        live = (od[7, sl][:, None] > 0.0) & (entry < cap)
        found = torch.zeros_like(found_out[sl])
        swept = torch.zeros_like(cost_out[sl])
        for k, ct in enumerate(ops.ctype_host):
            need = live[:, k] & ~found
            if not bool(need.any()):
                continue
            swept += need.to(torch.int32)
            ts = intersect_soa_t(_cluster_types(ct, ops.types), ops.soa[k],
                                 o3, d3, tmin, clip)
            found = found | (need & ((ts > lo) & (ts < cap)).any(dim=1))
        found_out[sl] = found
        cost_out[sl] = swept * c
    if with_cost:
        return found_out, cost_out
    return found_out
