"""Marching cubes as PyTorch tensor operations on a device.

Counterpart of webgl_raytracer_tpu/ops/marching.py (marching_cubes_device),
the device backend of models/surface.marching_cubes (backend="device" or
WRT_DEVICE_MC=1; the default backend stays numpy, as in the JAX package).
A one-shot stage of the scene build, so it stays tensor code: cube
indices, edge crossings, vertex interpolation and gradient normals are
dense grid operations, and the variable-size outputs come from
torch.nonzero (one host read each).

Vertices follow the numpy path's order (crossing x-edges, then y-, then
z-edges, each in flat scan order) and its interpolation, done in float64
as numpy does it; triangles follow its order too (every active cell's
first triangle in cell order, then every second one, ...), so the winding
is the numpy path's. The JAX package's compile-shape bucketing (_bucket,
_ladder) and axis canonicalisation exist for XLA's compile cache and are
not carried over; without the canonicalisation there is no mirrored grid
whose winding would need its fix.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device

_TABLES = np.load(os.path.join(os.path.dirname(__file__), "..", "assets",
                               "marching_cubes.npz"))
EDGE_TABLE = _TABLES["edge_table"]
TRI_TABLE = _TABLES["tri_table"]

EDGE_CORNERS = np.array([
    [0, 1], [1, 2], [2, 3], [3, 0],
    [4, 5], [5, 6], [6, 7], [7, 4],
    [0, 4], [1, 5], [2, 6], [3, 7],
], np.int32)
CORNER_OFFSETS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int32)


def _edge_axis_offset(e: int):
    """(axis, (ox, oy, oz)) of cell edge e's global edge."""
    o0, o1 = CORNER_OFFSETS[EDGE_CORNERS[e, 0]], CORNER_OFFSETS[EDGE_CORNERS[e, 1]]
    axis = int(np.nonzero(o0 != o1)[0][0])
    return axis, tuple(int(v) for v in np.minimum(o0, o1))


def _edge_pair(data, axis):
    """(a, b): the grid values at each axis-aligned edge's two ends."""
    if axis == 0:
        return data[:, :, :-1], data[:, :, 1:]
    if axis == 1:
        return data[:, :-1, :], data[:, 1:, :]
    return data[:-1, :, :], data[1:, :, :]


def _sample(data, gmin, resolution, max_dist, p):
    """Trilinear sample at float64 points p [N,3] with out-of-bounds
    corners at max_dist (models/surface._sample_trilinear; there the
    corner values, max_dist included, are f32 before the float64 lerps)."""
    nz, ny, nx = data.shape
    f = (p - gmin) / resolution
    i0 = torch.floor(f).to(torch.int64)
    t = f - i0
    flat = data.reshape(-1)

    def val(ix, iy, iz):
        inside = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                  & (iz >= 0) & (iz < nz))
        v = flat[(iz.clamp(0, nz - 1) * ny + iy.clamp(0, ny - 1)) * nx
                 + ix.clamp(0, nx - 1)].to(torch.float64)
        return torch.where(inside, v, float(max_dist))

    ix, iy, iz = i0[:, 0], i0[:, 1], i0[:, 2]
    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]
    c000 = val(ix, iy, iz)
    c100 = val(ix + 1, iy, iz)
    c010 = val(ix, iy + 1, iz)
    c110 = val(ix + 1, iy + 1, iz)
    c001 = val(ix, iy, iz + 1)
    c101 = val(ix + 1, iy, iz + 1)
    c011 = val(ix, iy + 1, iz + 1)
    c111 = val(ix + 1, iy + 1, iz + 1)
    c00 = c000 * (1 - tx) + c100 * tx
    c10 = c010 * (1 - tx) + c110 * tx
    c01 = c001 * (1 - tx) + c101 * tx
    c11 = c011 * (1 - tx) + c111 * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def _gradient_normals(data, gmin, resolution, max_dist, p):
    """Central-difference gradient of the field at p, normalised; (0, 1, 0)
    where it vanishes (models/surface._gradient_normals)."""
    cols = []
    for axis in range(3):
        dp = torch.zeros(3, dtype=torch.float64, device=p.device)
        dp[axis] = resolution
        cols.append(_sample(data, gmin, resolution, max_dist, p + dp)
                    - _sample(data, gmin, resolution, max_dist, p - dp))
    n = torch.stack(cols, dim=1)
    lens = torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2])[:, None]
    fallback = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=p.device)
    return torch.where(lens > 1e-4, n / torch.where(lens > 0, lens, 1.0), fallback)


def _empty():
    return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.uint32))


def marching_cubes_device(data, grid_min, resolution, max_dist, isovalue=0.0,
                          verts_only=False, device=None):
    """Marching cubes on `device` (None: cuda:0, raising without a GPU).
    data: f32[nz, ny, nx] (numpy or a tensor). Returns numpy (vertices
    f32[V,3], normals f32[V,3], indices u32[T,3]); with verts_only=True
    just the vertices (normals and indices empty)."""
    device = resolve_device(device)
    data = torch.as_tensor(np.asarray(data, np.float32), device=device).contiguous()
    nz, ny, nx = data.shape
    if nx < 2 or ny < 2 or nz < 2:
        return _empty()
    iso = float(isovalue)
    gmin = torch.as_tensor(np.asarray(grid_min, np.float32).astype(np.float64),
                           device=device)
    res = float(resolution)
    inside = data < iso

    # --- vertices: one per crossing edge ---------------------------------
    verts, ids, base = [], [], 0
    for axis in range(3):
        a, b = _edge_pair(data, axis)
        ia, ib = _edge_pair(inside, axis)
        cross = ia != ib
        idx = torch.nonzero(cross)                    # [count, 3] (z, y, x), scan order
        count = idx.shape[0]
        local = torch.cumsum(cross.reshape(-1).to(torch.int64), 0) - 1 + base
        ids.append(torch.where(cross.reshape(-1), local, -1).reshape(cross.shape))
        base += count
        if count:
            zz, yy, xx = idx[:, 0], idx[:, 1], idx[:, 2]
            v1 = a[zz, yy, xx].to(torch.float64)
            v2 = b[zz, yy, xx].to(torch.float64)
            p1 = torch.stack([xx, yy, zz], dim=1).to(torch.float64)
            p2 = p1.clone()
            p2[:, axis] += 1.0
            denom = v2 - v1
            t = torch.where(denom.abs() < 1e-5, 0.0,
                            (iso - v1) / torch.where(denom == 0, 1.0, denom))
            # The reference's endpoint snapping (interpolateVertex epsilons).
            t = torch.where((iso - v1).abs() < 1e-5, 0.0, t)
            t = torch.where((iso - v2).abs() < 1e-5, 1.0, t)
            p = p1 + (p2 - p1) * t[:, None]
            verts.append(gmin + p * res)
    if base == 0:
        return _empty()
    vertices = torch.cat(verts)
    if verts_only:
        return (vertices.to(torch.float32).cpu().numpy(), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.uint32))

    # --- triangles -------------------------------------------------------
    ci = torch.zeros((nz - 1, ny - 1, nx - 1), dtype=torch.int64, device=device)
    for corner in range(8):
        ox, oy, oz = (int(v) for v in CORNER_OFFSETS[corner])
        ci |= inside[oz:nz - 1 + oz, oy:ny - 1 + oy, ox:nx - 1 + ox].to(torch.int64) << corner
    edge_table = torch.as_tensor(EDGE_TABLE, device=device)
    cells = torch.nonzero(edge_table[ci] != 0)
    if cells.shape[0] == 0:
        return _empty()
    cz, cy, cx = cells[:, 0], cells[:, 1], cells[:, 2]
    tri_rows = torch.as_tensor(TRI_TABLE, dtype=torch.int64, device=device)[ci[cz, cy, cx]]
    cell_edge_vert = torch.stack([
        ids[axis][cz + oz, cy + oy, cx + ox]
        for axis, (ox, oy, oz) in map(_edge_axis_offset, range(12))], dim=1)   # [cells, 12]

    tris = []
    for k in range(0, 15, 3):
        rows = torch.nonzero(tri_rows[:, k] >= 0).squeeze(1)
        if rows.numel() == 0:
            break
        corners = [cell_edge_vert[rows, tri_rows[rows, k + j]] for j in range(3)]
        ok = (corners[0] >= 0) & (corners[1] >= 0) & (corners[2] >= 0)
        tris.append(torch.stack([c[ok] for c in corners], dim=1))
    indices = torch.cat(tris)

    normals = _gradient_normals(data, gmin, res, float(np.float32(max_dist)), vertices)
    return (vertices.to(torch.float32).cpu().numpy(),
            normals.to(torch.float32).cpu().numpy(),
            indices.cpu().numpy().astype(np.uint32))
