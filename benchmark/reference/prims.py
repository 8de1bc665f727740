"""Exact ray queries over spheres, capped cylinders and triangles through a
uniform grid, in plain PyTorch: the molecule kind's acceleration structure
(grid.py's idea, for three types and hundreds of thousands of
primitives).

The grid only narrows which primitives a ray is tested against; each test
is the shader's own (webgl.js:364-523: the sphere quadratic, the
cylinder's perpendicular-projection body with two cap spheres, Moller-
Trumbore), so the grid cannot change a result. Why nothing is missed: a
ray is sampled every STEP units of t (its direction has unit length)
across the grid's box, and each sample looks up the cell it lies in. A hit
point lies in its primitive's bounding box and within STEP / 2 of a
sample, so that sample lies in the box grown by STEP / 2 on each side, and
every cell that grown box touches lists the primitive. MARGIN adds room
for the rounding of a sample's position. A closest-hit query stops a ray
once its samples pass its best hit by STEP / 2 (no later sample can find
a nearer hit); an occlusion query stops it at its first hit in range.

Cells list their primitives in CSR form (a start and a count a cell, one
list of global ids: triangles, then spheres, then cylinders); a step
expands the live rays' cells into (ray, primitive) pairs, tests them by
type and keeps each ray's least t. The tests run in coordinates centred on
the midpoint of the primitives' bounds, the frame the viewer's cluster
tracer tests in; a sphere's t is then taken again in world coordinates
(where that test still hits), as the traced program refines it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fmath as M
from .grid import BIG

STEP = 1.0
MARGIN = 1e-3
TRI, SPH, CYL = 0, 1, 2


def _boxes(spheres, cylinders, triangles):
    """f32 [N, 3] lo and hi of every primitive in global-id order."""
    c, r = spheres
    p1, p2, rc = cylinders
    tv = triangles
    lo = [tv.min(axis=1), c - r[:, None], np.minimum(p1, p2) - rc[:, None]]
    hi = [tv.max(axis=1), c + r[:, None], np.maximum(p1, p2) + rc[:, None]]
    return np.concatenate(lo).astype(np.float32), np.concatenate(hi).astype(np.float32)


def bounds(spheres, cylinders, triangles):
    """The primitives' world box as float32 (lo, hi)."""
    lo, hi = _boxes(spheres, cylinders, triangles)
    return lo.min(axis=0), hi.max(axis=0)


class PrimGrid:
    """Spheres (c f32[S,3], r f32[S]), cylinders (p1, p2 f32[C,3], r
    f32[C]) and triangles (f32[T,3,3]) in `dtype`, listed by cell."""

    def __init__(self, spheres, cylinders, triangles, device, dtype=torch.float32):
        spheres = tuple(np.asarray(x, np.float32) for x in spheres)
        cylinders = tuple(np.asarray(x, np.float32) for x in cylinders)
        triangles = np.asarray(triangles, np.float32).reshape(-1, 3, 3)
        self.counts = (triangles.shape[0], spheres[0].shape[0], cylinders[0].shape[0])
        lo_p, hi_p = _boxes(spheres, cylinders, triangles)
        mid = 0.5 * (lo_p.min(axis=0) + hi_p.max(axis=0))
        grow = STEP / 2 + MARGIN
        lo_g = torch.as_tensor(lo_p - grow, device=device)
        hi_g = torch.as_tensor(hi_p + grow, device=device)
        self.lo = lo_g.min(dim=0).values
        self.hi = hi_g.max(dim=0).values
        self.dims = torch.clamp_min(torch.ceil((self.hi - self.lo) / STEP), 1).long()
        i0 = torch.clamp(torch.floor((lo_g - self.lo) / STEP).long(), min=0)
        i1 = torch.minimum(torch.floor((hi_g - self.lo) / STEP).long(), self.dims - 1)
        nx, ny = int(self.dims[0]), int(self.dims[1])
        self.ncells = nx * ny * int(self.dims[2])
        span = (i1 - i0 + 1)
        # Every (cell, primitive) pair of the grown boxes, by offsets within
        # the largest span.
        cells, prims = [], []
        smax = span.max(dim=0).values.tolist()
        ids = torch.arange(lo_g.shape[0], device=device)
        for dz in range(smax[2]):
            for dy in range(smax[1]):
                for dx in range(smax[0]):
                    ok = (dx < span[:, 0]) & (dy < span[:, 1]) & (dz < span[:, 2])
                    cells.append((i0[ok, 0] + dx) + nx * ((i0[ok, 1] + dy)
                                                          + ny * (i0[ok, 2] + dz)))
                    prims.append(ids[ok])
        cell = torch.cat(cells)
        prim = torch.cat(prims)
        order = torch.argsort(cell * lo_g.shape[0] + prim)
        self.items = prim[order]
        self.count = torch.bincount(cell, minlength=self.ncells)
        self.start = torch.cumsum(self.count, 0) - self.count
        self.samples = int(math.ceil(float(torch.linalg.vector_norm(self.hi - self.lo))
                                     / STEP)) + 2
        t = lambda a: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
        self.mid = t(mid)
        self.sph_c, self.sph_r = t(spheres[0]), t(spheres[1])
        self.cyl_p1, self.cyl_p2, self.cyl_r = t(cylinders[0]), t(cylinders[1]), t(cylinders[2])
        self.tri = t(triangles)
        self.sph_cc = t(spheres[0] - mid)
        self.cyl_p1c, self.cyl_p2c = t(cylinders[0] - mid), t(cylinders[1] - mid)
        self.tri_c = t(triangles - mid)
        self.device, self.dtype = device, dtype

    # -- one type's tests, on (ray, primitive) pairs ---------------------

    @staticmethod
    def _sphere(o, d, tmin, c, r):
        sx, sy, sz = o[0] - c[:, 0], o[1] - c[:, 1], o[2] - c[:, 2]
        b = sx * d[0] + sy * d[1] + sz * d[2]
        cc = sx * sx + sy * sy + sz * sz - r * r
        disc = b * b - cc
        ok = disc >= 0.0
        sq = M.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
        t0, t1 = -b - sq, -b + sq
        ts = torch.where(t0 > tmin, t0, t1)
        return torch.where(ok & (ts > tmin), ts, torch.full_like(ts, -1.0))

    @classmethod
    def _cylinder(cls, o, d, tmin, p1, p2, r):
        av = p2 - p1
        height = M.sqrt((av * av).sum(-1))
        degen = height < 1e-6
        a = av / torch.where(degen, torch.ones_like(height), height)[:, None]
        oc = tuple(o[i] - p1[:, i] for i in range(3))
        dir_dot = d[0] * a[:, 0] + d[1] * a[:, 1] + d[2] * a[:, 2]
        oc_dot = oc[0] * a[:, 0] + oc[1] * a[:, 1] + oc[2] * a[:, 2]
        dp = tuple(d[i] - a[:, i] * dir_dot for i in range(3))
        op = tuple(oc[i] - a[:, i] * oc_dot for i in range(3))
        qa = dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2]
        qb = 2.0 * (dp[0] * op[0] + dp[1] * op[1] + dp[2] * op[2])
        qc = op[0] * op[0] + op[1] * op[1] + op[2] * op[2] - r * r
        disc = qb * qb - 4.0 * qa * qc
        okq = (qa > 1e-8) & (disc >= 0.0)
        sq = M.sqrt(torch.where(okq, disc, torch.zeros_like(disc)))
        den = torch.where(okq, 2.0 * qa, torch.ones_like(qa))
        t1, t2 = (-qb - sq) / den, (-qb + sq) / den
        h1, h2 = oc_dot + t1 * dir_dot, oc_dot + t2 * dir_dot
        ok1 = okq & (t1 > tmin) & (h1 >= 0.0) & (h1 <= height)
        ok2 = okq & ~ok1 & (t2 > tmin) & (h2 >= 0.0) & (h2 <= height)
        neg = torch.full_like(t1, -1.0)
        tc = torch.where(ok1, t1, torch.where(ok2, t2, neg))
        for p, sign in ((p1, -1.0), (p2, 1.0)):
            tq = cls._sphere(o, d, tmin, p, r)
            q = tuple(o[i] - p[:, i] + d[i] * tq for i in range(3))
            h = q[0] * a[:, 0] + q[1] * a[:, 1] + q[2] * a[:, 2]
            better = (tq > tmin) & ((tc < 0.0) | (tq < tc)) & ((h * sign) >= 0.0)
            tc = torch.where(better, tq, tc)
        return torch.where(degen, cls._sphere(o, d, tmin, p1, r), tc)

    @staticmethod
    def triangle_uvt(o, d, v0, v1, v2):
        """Moller-Trumbore: (u, v, t, det ok)."""
        e1, e2 = v1 - v0, v2 - v0
        p = (d[1] * e2[:, 2] - d[2] * e2[:, 1], d[2] * e2[:, 0] - d[0] * e2[:, 2],
             d[0] * e2[:, 1] - d[1] * e2[:, 0])
        det = e1[:, 0] * p[0] + e1[:, 1] * p[1] + e1[:, 2] * p[2]
        ok = torch.abs(det) >= 1e-6
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tv = tuple(o[i] - v0[:, i] for i in range(3))
        u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv
        q = (tv[1] * e1[:, 2] - tv[2] * e1[:, 1], tv[2] * e1[:, 0] - tv[0] * e1[:, 2],
             tv[0] * e1[:, 1] - tv[1] * e1[:, 0])
        v = (d[0] * q[0] + d[1] * q[1] + d[2] * q[2]) * inv
        t = (e2[:, 0] * q[0] + e2[:, 1] * q[1] + e2[:, 2] * q[2]) * inv
        return u, v, t, ok

    @classmethod
    def _triangle(cls, o, d, tmin, tri):
        u, v, t, ok = cls.triangle_uvt(o, d, tri[:, 0], tri[:, 1], tri[:, 2])
        ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
        return torch.where(ok, t, torch.full_like(t, -1.0))

    def _test(self, oc, d, tmin, prim):
        """t of rays (centred origins oc, directions d, tmin: [m] each) at
        their primitives `prim` [m] (global ids), -1 for none."""
        t = torch.full(prim.shape, -1.0, dtype=self.dtype, device=self.device)
        nt, ns, _ = self.counts
        kinds = ((prim < nt), (prim >= nt) & (prim < nt + ns), prim >= nt + ns)
        for kind, sel in enumerate(kinds):
            idx = torch.nonzero(sel)[:, 0]
            if idx.numel() == 0:
                continue
            o = tuple(x[idx] for x in oc)
            dd = tuple(x[idx] for x in d)
            lo = tmin[idx]
            local = prim[idx] - (0 if kind == TRI else nt if kind == SPH else nt + ns)
            if kind == TRI:
                t[idx] = self._triangle(o, dd, lo, self.tri_c[local])
            elif kind == SPH:
                t[idx] = self._sphere(o, dd, lo, self.sph_cc[local], self.sph_r[local])
            else:
                t[idx] = self._cylinder(o, dd, lo, self.cyl_p1c[local], self.cyl_p2c[local],
                                        self.cyl_r[local])
        return t

    # -- the march ---------------------------------------------------------

    def _march(self, o, d, tmin, lo, hi, closest: bool):
        """closest: (t [n], global id [n], -1 for a miss) of the nearest
        hit past tmin; else [n] bool, some hit with lo < t < hi."""
        n = o[0].shape[0]
        dev = self.device
        o32 = torch.stack([x.float() for x in o], -1)
        d32 = torch.stack([x.float() for x in d], -1)
        inv = 1.0 / torch.where(d32 == 0, torch.full_like(d32, 1e-30), d32)
        ta, tb = (self.lo - o32) * inv, (self.hi - o32) * inv
        t_in = torch.clamp_min(torch.minimum(ta, tb).max(dim=1).values, 0.0)
        t_out = torch.maximum(ta, tb).min(dim=1).values
        oc = tuple(o[i] - self.mid[i] for i in range(3))
        best_t = torch.full((n,), BIG, dtype=self.dtype, device=dev)
        best_id = torch.full((n,), -1, dtype=torch.long, device=dev)
        hit_any = torch.zeros(n, dtype=torch.bool, device=dev)
        live = torch.nonzero(t_in <= t_out + STEP)[:, 0]
        nx, ny = int(self.dims[0]), int(self.dims[1])
        k = 0
        while live.numel() and k < self.samples:
            tk = t_in[live] + k * STEP
            p = o32[live] + d32[live] * tk[:, None]
            idx = torch.floor((p - self.lo) / STEP).long()
            inside = ((idx >= 0) & (idx < self.dims)).all(dim=-1)
            cell = idx[:, 0] + nx * (idx[:, 1] + ny * idx[:, 2])
            cnt = torch.where(inside, self.count[torch.where(inside, cell, 0)], 0)
            total = int(cnt.sum())
            if total:
                ray = torch.repeat_interleave(torch.arange(live.numel(), device=dev), cnt)
                first = torch.cumsum(cnt, 0) - cnt
                slot = torch.arange(total, device=dev) - first[ray] + self.start[cell[ray]]
                prim = self.items[slot]
                lane = live[ray]
                t = self._test(tuple(x[lane] for x in oc), tuple(x[lane] for x in d),
                               tmin[lane], prim)
                if closest:
                    t = torch.where(t > 0.0, t, torch.full_like(t, BIG))
                    least = torch.full((live.numel(),), BIG, dtype=self.dtype, device=dev)
                    least.scatter_reduce_(0, ray, t, reduce="amin")
                    win = (t == least[ray]) & (t < BIG)
                    pick = torch.full((live.numel(),), 1 << 62, dtype=torch.long, device=dev)
                    pick.scatter_reduce_(0, ray[win], prim[win], reduce="amin")
                    better = (least < best_t[live]) | ((least == best_t[live])
                                                       & (pick < best_id[live]))
                    better &= least < BIG
                    best_t[live] = torch.where(better, least, best_t[live])
                    best_id[live] = torch.where(better, pick, best_id[live])
                else:
                    ok = (t > lo[lane]) & (t < hi[lane])
                    found = torch.zeros(live.numel(), dtype=torch.bool, device=dev)
                    found[ray[ok]] = True
                    hit_any[live] |= found
            k += 1
            t_next = t_in[live] + k * STEP
            keep = t_next <= t_out[live] + STEP
            if closest:
                keep &= ~(best_t[live] < t_next - STEP / 2 - MARGIN)
            else:
                keep &= ~hit_any[live]
            live = live[keep]
        return (best_t, best_id) if closest else hit_any

    def closest(self, o, d, tmin):
        """(t [n], global id [n], -1 for a miss); a sphere's t refined in
        world coordinates."""
        t, gid = self._march(o, d, tmin, None, None, True)
        nt, ns, _ = self.counts
        sph = (gid >= nt) & (gid < nt + ns)
        if bool(sph.any()):
            local = torch.clamp(gid - nt, 0, max(ns - 1, 0))
            tw = self._sphere(o, d, tmin, self.sph_c[local], self.sph_r[local])
            t = torch.where(sph & (tw > 0.0), tw, t)
        return t, gid

    def any_hit(self, o, d, tmin, lo, hi):
        return self._march(o, d, tmin, lo, hi, False)
