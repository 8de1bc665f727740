"""Exact ray-sphere queries over a uniform grid, in plain PyTorch.

The grid only narrows which spheres a ray is tested against; each test is
the shader's own sphere intersection, so the grid cannot change a result.
Why nothing is missed: a ray is sampled every STEP units of t (its
direction has unit length) across the grid's box, and each sample looks up
the cell it lies in. A hit point lies in its sphere's bounding box and
within STEP / 2 of a sample, so that sample lies in the box grown by
STEP / 2 on each side, and every cell that grown box touches lists the
sphere. MARGIN adds room for the rounding of a sample's position.

The tests run in coordinates centred on the midpoint of the spheres'
bounds, the frame the viewer's cluster tracer tests in: the closest hit is
chosen by its centred t, then its t is taken again in world coordinates
where that test still hits; an occlusion test keeps the centred t. In a
path tracer one ulp in a hit point sends a path elsewhere within a few
bounces, so the reference rounds where the traced program rounds.

Both queries take triples of [n] tensors and test rays in blocks of
BLOCK_PAIRS sphere slots at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fmath as M

STEP = 1.0                  # cell size, and the t spacing of a ray's samples
MARGIN = 1e-3
BLOCK_PAIRS = 1 << 25
BIG = float(np.float32(1e20))


class SphereGrid:
    """Spheres (centers f32[N,3], radii f32[N]) in `dtype`, listed by cell."""

    def __init__(self, centers, radii, device, dtype=torch.float32):
        c = torch.as_tensor(np.asarray(centers, np.float32), device=device)
        r = torch.as_tensor(np.asarray(radii, np.float32), device=device)
        grow = STEP / 2 + MARGIN
        lo_s, hi_s = c - r[:, None] - grow, c + r[:, None] + grow
        self.lo = lo_s.min(dim=0).values
        self.hi = hi_s.max(dim=0).values
        self.dims = torch.clamp_min(torch.ceil((self.hi - self.lo) / STEP), 1).long()
        i0 = torch.clamp(torch.floor((lo_s - self.lo) / STEP).long(), min=0)
        i1 = torch.minimum(torch.floor((hi_s - self.lo) / STEP).long(), self.dims - 1)
        span = int((i1 - i0 + 1).max())
        offs = torch.arange(span, device=device)
        # Every (sphere, cell) pair of the grown boxes.
        ix = i0[:, None, 0] + offs[None, :]
        iy = i0[:, None, 1] + offs[None, :]
        iz = i0[:, None, 2] + offs[None, :]
        ok = ((ix <= i1[:, None, 0])[:, :, None, None] & (iy <= i1[:, None, 1])[:, None, :, None]
              & (iz <= i1[:, None, 2])[:, None, None, :])
        nx, ny = int(self.dims[0]), int(self.dims[1])
        cell = (ix[:, :, None, None] + nx * (iy[:, None, :, None] + ny * iz[:, None, None, :]))
        sphere = torch.arange(c.shape[0], device=device)[:, None, None, None].expand_as(cell)
        cell, sphere = cell[ok], sphere[ok]
        order = torch.argsort(cell * c.shape[0] + sphere)
        cell, sphere = cell[order], sphere[order]
        ncells = nx * ny * int(self.dims[2])
        counts = torch.bincount(cell, minlength=ncells)
        start = torch.cumsum(counts, 0) - counts
        self.width = int(counts.max())
        table = torch.full((ncells + 1, self.width), -1, dtype=torch.long, device=device)
        table[cell, torch.arange(cell.shape[0], device=device) - start[cell]] = sphere
        self.table = table                        # row ncells: the empty cell
        self.ncells = ncells
        self.samples = int(math.ceil(float(torch.linalg.vector_norm(self.hi - self.lo))
                                     / STEP)) + 2
        lo_b, hi_b = (c - r[:, None]).min(dim=0).values, (c + r[:, None]).max(dim=0).values
        self.mid = (0.5 * (lo_b + hi_b)).to(dtype)
        self.center = c.to(dtype)
        self.centered = (c - 0.5 * (lo_b + hi_b)).to(dtype)
        self.radius = r.to(dtype)
        self.count = c.shape[0]

    def _candidates(self, o, d):
        """[n, samples*width] sphere indices (-1: none) that rays o + t d
        may hit, from float32 copies of the rays."""
        o32 = torch.stack([x.float() for x in o], -1)
        d32 = torch.stack([x.float() for x in d], -1)
        inv = 1.0 / torch.where(d32 == 0, torch.full_like(d32, 1e-30), d32)
        t1 = (self.lo - o32) * inv
        t2 = (self.hi - o32) * inv
        t_in = torch.clamp_min(torch.minimum(t1, t2).max(dim=1).values, 0.0)
        t_out = torch.maximum(t1, t2).min(dim=1).values
        k = torch.arange(self.samples, device=o32.device, dtype=torch.float32)
        t = t_in[:, None] + k[None, :] * STEP
        inside = t <= t_out[:, None] + STEP
        p = o32[:, None, :] + d32[:, None, :] * t[..., None]
        idx = torch.floor((p - self.lo) / STEP).long()
        inside &= ((idx >= 0) & (idx < self.dims)).all(dim=-1)
        nx, ny = int(self.dims[0]), int(self.dims[1])
        cell = idx[..., 0] + nx * (idx[..., 1] + ny * idx[..., 2])
        cell = torch.where(inside, cell, self.ncells)
        return self.table[cell].reshape(cell.shape[0], -1)

    def _centred(self, o):
        return tuple(o[i] - self.mid[i] for i in range(3))

    def _t(self, oc, d, tmin, cand, centers=None):
        """[n, m] hit distance of each candidate, -1 for none: the shader's
        sphere test (first root beyond tmin, else the second), from the
        centred origins `oc` and centres (world ones where given)."""
        safe = torch.clamp_min(cand, 0)
        cen = (self.centered if centers is None else centers)[safe]
        if cen.dim() == 2:
            cen, ra = cen[:, None, :], self.radius[safe][:, None]
            oc, d, tmin = (tuple(x[:, None] for x in oc), tuple(x[:, None] for x in d),
                           tmin[:, None])
            return self._sphere(oc, d, tmin, cen, ra, cand[:, None])[:, 0]
        return self._sphere(tuple(x[:, None] for x in oc), tuple(x[:, None] for x in d),
                            tmin[:, None], cen, self.radius[safe], cand)

    @staticmethod
    def _sphere(o, d, tmin, cen, ra, cand):
        sx = o[0] - cen[..., 0]
        sy = o[1] - cen[..., 1]
        sz = o[2] - cen[..., 2]
        b = sx * d[0] + sy * d[1] + sz * d[2]
        c = sx * sx + sy * sy + sz * sz - ra * ra
        disc = b * b - c
        ok = disc >= 0.0
        sq = M.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
        t0 = -b - sq
        t1 = -b + sq
        ts = torch.where(t0 > tmin, t0, t1)
        return torch.where(ok & (ts > tmin) & (cand >= 0), ts, torch.full_like(ts, -1.0))

    def _blocks(self, n):
        step = max(1, BLOCK_PAIRS // (self.samples * self.width))
        return range(0, n, step), step

    def closest(self, o, d, tmin):
        """(t [n], sphere index [n], -1 for a miss)."""
        n = o[0].shape[0]
        t_out = torch.full((n,), BIG, dtype=o[0].dtype, device=o[0].device)
        i_out = torch.full((n,), -1, dtype=torch.long, device=o[0].device)
        starts, step = self._blocks(n)
        for s in starts:
            sl = slice(s, s + step)
            ob, db = tuple(x[sl] for x in o), tuple(x[sl] for x in d)
            cand = self._candidates(ob, db)
            t = self._t(self._centred(ob), db, tmin[sl], cand)
            t = torch.where(t > 0.0, t, torch.full_like(t, BIG))
            best = torch.argmin(t, dim=1)
            tb = t.gather(1, best[:, None])[:, 0]
            hit = tb < BIG
            win = torch.where(hit, cand.gather(1, best[:, None])[:, 0], -1)
            tw = self._t(ob, db, tmin[sl], win, self.center)
            t_out[sl] = torch.where(hit, torch.where(tw > 0.0, tw, tb), t_out[sl])
            i_out[sl] = win
        return t_out, i_out

    def any_hit(self, o, d, tmin, lo, hi):
        """[n] bool: some sphere hit with lo < t < hi."""
        n = o[0].shape[0]
        out = torch.zeros(n, dtype=torch.bool, device=o[0].device)
        starts, step = self._blocks(n)
        for s in starts:
            sl = slice(s, s + step)
            ob, db = tuple(x[sl] for x in o), tuple(x[sl] for x in d)
            t = self._t(self._centred(ob), db, tmin[sl], self._candidates(ob, db))
            out[sl] = ((t > lo[sl, None]) & (t < hi[sl, None])).any(dim=1)
        return out

    def brute_closest(self, o, d, tmin):
        """closest() by testing every sphere: the grid's own check."""
        cand = torch.arange(self.count, device=o[0].device)[None, :].expand(o[0].shape[0], -1)
        t = self._t(self._centred(o), d, tmin, cand)
        t = torch.where(t > 0.0, t, torch.full_like(t, BIG))
        best = torch.argmin(t, dim=1)
        tb = t.gather(1, best[:, None])[:, 0]
        return torch.where(tb < BIG, tb, BIG), torch.where(tb < BIG, best, -1)
