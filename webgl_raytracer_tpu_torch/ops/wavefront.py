"""Cluster tracer front end: slab entries, the cluster SoA intersector,
hit finalisation, the brute-force sweep and the trace routing.

Counterpart of webgl_raytracer_tpu/ops/wavefront.py. `cluster_entry_t`
and `intersect_soa_t` are the same expressions as the reference (and as
the hand-written kernels in csrc/), so the plain versions in ops/trace.py
that use them round exactly like the kernels. Every closest-hit and shadow
query goes through ops/trace.py: a CUDA tensor takes the kernel, which
serves every scene; a CPU tensor takes the plain version. Secondary
closest traces and divergent (env-NEE) occlusion batches on cluster-rich
scenes take the per-ray kernels, where the JAX package routes them.

force_dense=True (the reference's useBvh=false brute-force mode) takes
_dense_trace instead: every cluster swept for every ray, unculled, in
plain PyTorch on any device. It reads no host value, so a frame on it is
captured like any other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..scene.bvh import PRIM_CYLINDER, PRIM_SPHERE, PRIM_TRIANGLE
from . import vec3 as V

BIG = float(np.float32(1e20))
INF = float("inf")


@dataclass
class HitRecord:
    """Closest-hit record per ray (the JAX package's HitRecord fields)."""
    t: torch.Tensor            # f32[B], BIG on a miss
    prim_type: torch.Tensor    # i32[B], -1 on a miss
    prim_local: torch.Tensor   # i32[B], per-type index, -1 on a miss
    prim_slot: torch.Tensor    # i32[B], cluster*C + lane, -1 on a miss
    extra: torch.Tensor        # f32[B,3]: (cap code | barycentric u, v, 0)
    cost: torch.Tensor | None  # i32[B] primitives swept (ops/trace.py,
    #                            "Counts") when the trace was asked for it, else None


def scene_types(scene) -> tuple[bool, bool, bool]:
    """(has_spheres, has_cylinders, has_triangles)."""
    return (scene.sphere_count > 0, scene.cylinder_count > 0,
            scene.tri_count > 0)


def cluster_entry_t(bmin, bmax, o3, d3):
    """Entry distance of each ray into each cluster AABB, +inf on a miss.

    o3/d3: component triples of [B]; bmin/bmax [K,3] -> [B,K]. Branchless
    slab test per axis; the |d| < 1e-8 case folds into an inside check."""
    shape = (o3[0].shape[0], bmin.shape[0])
    tn = torch.full(shape, -BIG, dtype=torch.float32, device=bmin.device)
    tf = torch.full(shape, BIG, dtype=torch.float32, device=bmin.device)
    axis_ok = torch.ones(shape, dtype=torch.bool, device=bmin.device)
    for axis in range(3):
        o = o3[axis][:, None]
        d = d3[axis][:, None]
        lo = bmin[None, :, axis]
        hi = bmax[None, :, axis]
        parallel = torch.abs(d) < 1e-8
        inv = 1.0 / torch.where(parallel, 1.0, d)
        t1 = (lo - o) * inv
        t2 = (hi - o) * inv
        near = torch.where(parallel, -BIG, torch.minimum(t1, t2))
        far = torch.where(parallel, BIG, torch.maximum(t1, t2))
        tn = torch.maximum(tn, near)
        tf = torch.minimum(tf, far)
        axis_ok &= ~parallel | ((o >= lo) & (o <= hi))
    tn0 = torch.clamp_min(tn, 0.0)
    hit = axis_ok & (tf >= tn0)
    return torch.where(hit, tn0, INF)


def intersect_soa_t(types, soa, o3, d3, t_min, clip):
    """t [B,C] of [B] rays against one cluster's SoA block soa [12,C], or
    against one block per ray, soa [B,12,C] (-1 = no hit). types =
    (has_spheres, has_cylinders, has_triangles) selects the intersectors
    to evaluate; each lane keeps its own type's result. clip is None or
    ((nx, ny, nz), offset, side): triangle hits on the clipped side are
    rejected."""
    def row(i):
        return soa[i][None, :] if soa.dim() == 2 else soa[:, i, :]

    ox, oy, oz = (c[:, None] for c in o3)
    dx, dy, dz = (c[:, None] for c in d3)
    tmin = t_min[:, None]
    ptype = row(11)
    ra = row(3)
    has_sph, has_cyl, has_tri = types

    t = torch.full((o3[0].shape[0], soa.shape[-1]), -1.0,
                   dtype=torch.float32, device=soa.device)

    if has_sph:
        sx = ox - row(0)
        sy = oy - row(1)
        sz = oz - row(2)
        b = sx * dx + sy * dy + sz * dz
        cterm = sx * sx + sy * sy + sz * sz - ra * ra
        disc = b * b - cterm
        ok = disc >= 0.0
        sq = V.sqrt(torch.where(ok, disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        ts = torch.where(t0 > tmin, t0, t1)
        ts = torch.where(ok & (ts > tmin), ts, -1.0)
        t = torch.where(ptype == PRIM_SPHERE, ts, t)

    if has_cyl:
        p1x, p1y, p1z = row(0), row(1), row(2)
        p2x, p2y, p2z = row(4), row(5), row(6)
        avx = p2x - p1x
        avy = p2y - p1y
        avz = p2z - p1z
        h2 = avx * avx + avy * avy + avz * avz
        height = V.sqrt(h2)
        degen = height < 1e-6
        inv_h = 1.0 / torch.where(degen, 1.0, height)
        ax_ = avx * inv_h
        ay_ = avy * inv_h
        az_ = avz * inv_h

        ocx = ox - p1x
        ocy = oy - p1y
        ocz = oz - p1z
        dir_dot = dx * ax_ + dy * ay_ + dz * az_
        oc_dot = ocx * ax_ + ocy * ay_ + ocz * az_
        dpx = dx - ax_ * dir_dot
        dpy = dy - ay_ * dir_dot
        dpz = dz - az_ * dir_dot
        opx = ocx - ax_ * oc_dot
        opy = ocy - ay_ * oc_dot
        opz = ocz - az_ * oc_dot
        a_q = dpx * dpx + dpy * dpy + dpz * dpz
        b_q = 2.0 * (dpx * opx + dpy * opy + dpz * opz)
        c_q = opx * opx + opy * opy + opz * opz - ra * ra
        disc = b_q * b_q - 4.0 * a_q * c_q
        okq = (a_q > 1e-8) & (disc >= 0.0)
        sq = V.sqrt(torch.where(okq, disc, 0.0))
        den = torch.where(okq, 2.0 * a_q, 1.0)
        t1c = (-b_q - sq) / den
        t2c = (-b_q + sq) / den
        hh1 = oc_dot + t1c * dir_dot
        hh2 = oc_dot + t2c * dir_dot
        ok1 = okq & (t1c > tmin) & (hh1 >= 0.0) & (hh1 <= height)
        ok2 = okq & ~ok1 & (t2c > tmin) & (hh2 >= 0.0) & (hh2 <= height)
        tc = torch.where(ok1, t1c, torch.where(ok2, t2c, -1.0))

        for px, py, pz, sign in ((p1x, p1y, p1z, -1.0), (p2x, p2y, p2z, 1.0)):
            qx = ox - px
            qy = oy - py
            qz = oz - pz
            bq = qx * dx + qy * dy + qz * dz
            cq = qx * qx + qy * qy + qz * qz - ra * ra
            dq = bq * bq - cq
            okc = dq >= 0.0
            sqc = V.sqrt(torch.where(okc, dq, 0.0))
            tq = torch.where(-bq - sqc > tmin, -bq - sqc, -bq + sqc)
            tq = torch.where(okc & (tq > tmin), tq, -1.0)
            h = (qx + dx * tq) * ax_ + (qy + dy * tq) * ay_ + (qz + dz * tq) * az_
            better = (tq > tmin) & ((tc < 0.0) | (tq < tc)) & ((h * sign) >= 0.0)
            tc = torch.where(better, tq, tc)

        # Degenerate cylinder: plain sphere at p1.
        qx = ox - p1x
        qy = oy - p1y
        qz = oz - p1z
        bq = qx * dx + qy * dy + qz * dz
        cq = qx * qx + qy * qy + qz * qz - ra * ra
        dq = bq * bq - cq
        okc = dq >= 0.0
        sqc = V.sqrt(torch.where(okc, dq, 0.0))
        tq = torch.where(-bq - sqc > tmin, -bq - sqc, -bq + sqc)
        tq = torch.where(okc & (tq > tmin), tq, -1.0)
        tc = torch.where(degen, tq, tc)
        t = torch.where(ptype == PRIM_CYLINDER, tc, t)

    if has_tri:
        v0x, v0y, v0z = row(0), row(1), row(2)
        e1x = row(4) - v0x
        e1y = row(5) - v0y
        e1z = row(6) - v0z
        e2x = row(8) - v0x
        e2y = row(9) - v0y
        e2z = row(10) - v0z
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        okt = torch.abs(det) >= 1e-6
        inv = 1.0 / torch.where(okt, det, 1.0)
        tvx = ox - v0x
        tvy = oy - v0y
        tvz = oz - v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv
        okt &= (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > tmin)
        tt = torch.where(okt, tt, -1.0)
        if clip is not None:
            normal, offset, side = clip
            hx = ox + dx * tt
            hy = oy + dy * tt
            hz = oz + dz * tt
            s = hx * normal[0] + hy * normal[1] + hz * normal[2] - offset
            tt = torch.where(s * side > 0.0, -1.0, tt)
        t = torch.where(ptype == PRIM_TRIANGLE, tt, t)

    return torch.where(ptype >= 0.0, t, -1.0)


def _finalize_hit(scene, o3, d3, t_min, clip, closest, best_row, cost,
                  refine_sphere_t=False, row=None):
    """Hit attributes of the winning primitive per ray: one [B,12] row
    gather, then barycentrics / cylinder cap code in component form.

    refine_sphere_t: recompute sphere winners' t with the quadratic in
    GLOBAL coordinates, removing the kernel's scene-centred rounding so
    hit positions match an uncentred trace to f32 ulps.

    row: the winners' [B,12] cluster rows when the caller has them (the
    attrs kernel's rows, columns 0-11); then nothing is gathered. They
    equal the gathered rows on every hit lane."""
    if row is None:
        row = scene.cluster_prims.reshape(-1, 12)[torch.clamp_min(best_row, 0).long()]
    ox, oy, oz = o3
    dx, dy, dz = d3
    ptype = row[:, 11].to(torch.int32)
    plocal = row[:, 7].to(torch.int32)

    if refine_sphere_t and scene.sphere_count:
        sx = ox - row[:, 0]
        sy = oy - row[:, 1]
        sz = oz - row[:, 2]
        b = sx * dx + sy * dy + sz * dz
        cterm = sx * sx + sy * sy + sz * sz - row[:, 3] * row[:, 3]
        disc = b * b - cterm
        sq = V.sqrt(torch.clamp_min(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        ts = torch.where(t0 > t_min, t0, t1)
        ok = ((best_row >= 0) & (ptype == PRIM_SPHERE)
              & (disc >= 0.0) & (ts > t_min))
        closest = torch.where(ok, ts, closest)

    e0 = torch.zeros_like(closest)
    e1 = torch.zeros_like(closest)

    if scene.cylinder_count:
        # Cap code from the winning t: cap when the hit height falls
        # outside the finite body.
        p1x, p1y, p1z = row[:, 0], row[:, 1], row[:, 2]
        p2x, p2y, p2z = row[:, 4], row[:, 5], row[:, 6]
        avx, avy, avz = p2x - p1x, p2y - p1y, p2z - p1z
        height = V.sqrt(avx * avx + avy * avy + avz * avz)
        degen = height < 1e-6
        inv_h = 1.0 / torch.where(degen, 1.0, height)
        ax_, ay_, az_ = avx * inv_h, avy * inv_h, avz * inv_h
        hx = ox + dx * closest - p1x
        hy = oy + dy * closest - p1y
        hz = oz + dz * closest - p1z
        h = hx * ax_ + hy * ay_ + hz * az_
        htype = torch.where(h < 0.0, 1.0, torch.where(h > height, 2.0, 0.0))
        htype = torch.where(degen, 0.0, htype)
        e0 = torch.where(ptype == PRIM_CYLINDER, htype, e0)

    if scene.tri_count:
        v0x, v0y, v0z = row[:, 0], row[:, 1], row[:, 2]
        e1x, e1y, e1z = row[:, 4] - v0x, row[:, 5] - v0y, row[:, 6] - v0z
        e2x, e2y, e2z = row[:, 8] - v0x, row[:, 9] - v0y, row[:, 10] - v0z
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = 1.0 / torch.where(torch.abs(det) >= 1e-6, det, 1.0)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        uu = (tvx * px + tvy * py + tvz * pz) * inv
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        vv = (dx * qx + dy * qy + dz * qz) * inv
        is_tri = ptype == PRIM_TRIANGLE
        e0 = torch.where(is_tri, uu, e0)
        e1 = torch.where(is_tri, vv, e1)

    hit = best_row >= 0
    extra = torch.stack([torch.where(hit, e0, 0.0), torch.where(hit, e1, 0.0),
                         torch.zeros_like(e0)], dim=-1)
    return HitRecord(
        t=torch.where(hit, closest, BIG),
        prim_type=torch.where(hit, ptype, -1),
        prim_local=torch.where(hit, plocal, -1),
        prim_slot=best_row,
        extra=extra,
        cost=cost,
    )


# Rays per slice of the brute sweep: bounds its [rays, C] temporaries
# (128 MB each at C = 128; a 1080p frame's 2,073,600 rays at once would
# make them 1.06 GB each).
DENSE_CHUNK = 1 << 18


def _dense_trace(scene, o3, d3, t_min, clip, any_hit, accept_min, t_max, active):
    """The brute sweep, the JAX package's _dense_trace: each of the K
    clusters of cluster_soa (world coordinates) intersected with every ray
    (intersect_soa_t), in cluster order. Closest hit: the first lane of a
    cluster's least valid t (t > 0 and below the ray's closest), taken
    where strictly smaller than the closest so far; finalised by
    _finalize_hit with cost K * C and no sphere refinement. Occlusion: any
    t in (accept_min, t_max). Inactive rays miss. The rays are swept in
    slices of DENSE_CHUNK; the loop counts are static and nothing is read
    back to the host."""
    from .trace import _cluster_types

    n = o3[0].shape[0]
    device = o3[0].device
    k, c = scene.num_clusters, scene.cluster_size
    types = scene_types(scene)
    ctypes = scene.trace_operands.ctype_host
    lane = torch.arange(c, dtype=torch.int32, device=device)

    def row(x, fill):
        if x is None:
            x = fill
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32).expand(n)
        return torch.full((n,), x, dtype=torch.float32, device=device)

    cap = row(t_max, BIG)
    lo_all = row(accept_min, 0.0)
    act_all = (torch.ones(n, dtype=torch.bool, device=device) if active is None
               else active)
    closest_out = torch.empty(n, dtype=torch.float32, device=device)
    row_out = torch.empty(n, dtype=torch.int32, device=device)
    found_out = torch.empty(n, dtype=torch.bool, device=device)
    for s in range(0, n, DENSE_CHUNK):
        sl = slice(s, min(n, s + DENSE_CHUNK))
        o, d, tmin = tuple(x[sl] for x in o3), tuple(x[sl] for x in d3), t_min[sl]
        act = act_all[sl][:, None]
        closest = cap[sl].clone(memory_format=torch.contiguous_format)
        best = torch.full(closest.shape, -1, dtype=torch.int32, device=device)
        found = torch.zeros(closest.shape, dtype=torch.bool, device=device)
        for kk in range(k):
            t_c = intersect_soa_t(_cluster_types(ctypes[kk], types), scene.cluster_soa[kk],
                                  o, d, tmin, clip)
            if any_hit:
                valid = (t_c > lo_all[sl][:, None]) & (t_c < closest[:, None]) & act
                found = found | valid.any(dim=1)
            else:
                valid = (t_c > 0.0) & (t_c < closest[:, None]) & act
                t_masked = torch.where(valid, t_c, INF)
                t_best = t_masked.min(dim=1).values
                j = torch.where(t_masked == t_best[:, None], lane, c).min(dim=1).values
                upd = t_best < closest
                closest = torch.where(upd, t_best, closest)
                best = torch.where(upd, kk * c + j, best)
        closest_out[sl], row_out[sl], found_out[sl] = closest, best, found
    if any_hit:
        return found_out
    return _finalize_hit(scene, o3, d3, t_min, clip, closest_out, row_out,
                         cost=torch.full((n,), k * c, dtype=torch.int32, device=device))


def _broadcast_t_min(t_min, like):
    """t_min as f32 in like's shape: a tensor converted, a number filled
    (no host value copied to the card)."""
    if isinstance(t_min, torch.Tensor):
        return t_min.to(device=like.device, dtype=torch.float32).expand(like.shape)
    return torch.full(like.shape, t_min, dtype=torch.float32, device=like.device)


def wf_trace_closest_v3(scene, o3, d3, t_min, clip=None, active=None,
                        secondary=False, full_record=True, with_attrs=False,
                        impl=None, with_cost=False, force_dense=False):
    """Closest hit over the cluster SoA; rays as component triples.
    prim_slot indexes the padded cluster table ([K*C, 12]). The kernel's
    t is rounded in scene-centred coordinates; finalisation refines
    sphere winners in global coordinates.

    secondary: the batch is divergent bounce rays; on cluster-rich scenes
    it goes to the per-ray kernel (ops/trace.perray_auto_secondary), as
    the JAX package routes it.

    full_record=False: the caller needs only (t, prim_slot) and finalises
    later (the chunked transports): t stays the kernel's unrefined t,
    prim_type is a 0/-1 hit flag and no row is gathered.

    with_attrs: returns (record, attrs f32[B,32]) through the attrs kernel
    (ops/trace.trace_closest_attrs), the winner's attribute row, so that
    neither this call nor shading gathers. Every closest trace with attrs
    takes that block kernel, secondaries included, as the JAX package
    routes it.

    with_cost: the record's cost is the trace's count (the kernel's cost
    form on the card); otherwise it is None. The attrs kernel has no cost
    form, so with_attrs and with_cost do not go together.

    force_dense: the brute sweep (_dense_trace), whose full record (cost
    K * C) is returned whatever full_record, with_attrs and with_cost
    ask, as in the JAX package."""
    from . import trace as T

    t_min = _broadcast_t_min(t_min, o3[0])
    if force_dense:
        return _dense_trace(scene, o3, d3, t_min, clip, any_hit=False, accept_min=None,
                            t_max=None, active=active)
    if with_attrs and with_cost:
        raise ValueError("the attrs kernel has no cost form")
    if with_attrs:
        t, attrs = T.trace_closest_attrs(scene, o3, d3, t_min, clip=clip,
                                         active=active, impl=impl)
        rec = _finalize_hit(scene, o3, d3, t_min, clip, t, T.attr_slot(attrs),
                            cost=None, refine_sphere_t=True, row=attrs[:, :12])
        return rec, attrs
    perray = secondary and T.perray_auto_secondary(scene)
    out = T.trace_closest(scene, o3, d3, t_min, clip=clip, active=active, perray=perray,
                          impl=impl, with_cost=with_cost)
    closest, best_row = out[:2]
    cost = out[2] if with_cost else None
    if not full_record:
        hit = best_row >= 0
        return HitRecord(
            t=torch.where(hit, closest, BIG),
            prim_type=torch.where(hit, 0, -1).to(torch.int32),
            prim_local=torch.full_like(best_row, -1),
            prim_slot=best_row,
            extra=torch.zeros((best_row.shape[0], 3), dtype=torch.float32,
                              device=best_row.device),
            cost=cost)
    return _finalize_hit(scene, o3, d3, t_min, clip, closest, best_row,
                         cost=cost, refine_sphere_t=True)


def wf_trace_any_v3(scene, o3, d3, t_min, t_max=BIG, accept_min=None,
                    clip=None, active=None, divergent=False, impl=None,
                    force_dense=False):
    """Occlusion (any hit with t in (accept_min, t_max)): bool [N].
    divergent=True marks batches whose directions scatter over the sphere
    (env-NEE occlusion); on cluster-rich scenes those go to the per-ray
    kernel (ops/trace.perray_auto_any), as the JAX package routes them.
    force_dense: the brute sweep (_dense_trace)."""
    from . import trace as T

    t_min = _broadcast_t_min(t_min, o3[0])
    if force_dense:
        return _dense_trace(scene, o3, d3, t_min, clip, any_hit=True,
                            accept_min=accept_min, t_max=t_max, active=active)
    return T.trace_any(scene, o3, d3, t_min, t_max=t_max, accept_min=accept_min,
                       clip=clip, active=active,
                       perray=T.perray_auto_any(scene, divergent), impl=impl)


def wf_trace_any3_v3(scene, o3, d3s, t_min, accept_min=None, clip=None,
                     actives=(None, None, None), impl=None):
    """Occlusion of THREE rays per lane sharing one origin (the 3-light
    shadow fan) in one launch: three bool [N] tensors. The brute sweep
    never comes here: under use_bvh=False the integrator traces the fan as
    one [3N] any-hit batch (wf_trace_any_v3, force_dense)."""
    from . import trace as T

    t_min = _broadcast_t_min(t_min, o3[0])
    return T.trace_any3(scene, o3, d3s, t_min, accept_min=accept_min,
                        clip=clip, actives=actives, impl=impl)
