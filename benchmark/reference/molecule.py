"""The molecule kind's plain reference of a scene: atoms to spheres, bonds
to cylinders, the solvent-excluded surface to triangles, as upstream's
viewer builds them (src/molecular.js, src/surface_webgl.js:1009-1091,
src/main.js loadMolecularGeometry), from the atoms and the configuration
alone.

Atoms: CPK colours (Jmol), van der Waals radii (Bondi) scaled by the
configuration's atom_scale. Bonds: the file's CONECT records where it has
any; else inferred, every pair with 0.4 A <= d <= r_cov(i) + r_cov(j) +
0.45 A (Cordero covalent radii), molecular.js:253-325. Each bond is a
cylinder of bond_radius in BOND_COLOR.

The SES (ses): over the standard (non-HETATM) atoms at their van der Waals
radii, with the probe and the grid step of the configuration:
  1. the SAS field: at each grid point, min over atoms of |p - c| - (r +
     probe), clamped to +/- 2 step; the grid spans the atoms' box grown by
     2 probe + the largest radius + step;
  2. marching cubes at 0 (the standard tables, marching_cubes.txt);
  3. the SAS vertices, deduplicated on a step/2 grid (the first in vertex
     order of each cell), become probe centres; the SES field is min over
     them of |p - c| - probe, clamped alike, on the same grid;
  4. marching cubes at 0; vertex normals by central differences of the
     trilinear field (step h), normalised;
  5. where the triangles' vertices form more than one connected
     component, each component whose first vertex lies within r + 1.5
     probe of no atom is dropped (interior voids; a surface of one
     component is kept whole), and the normals flipped.
Fields are computed on the device: each sphere writes the grid points
within its reach (radius + clamp) by a scatter-min, blocks of spheres at
a time. Vertex positions interpolate the float32
field in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BOND_TOLERANCE = 0.45
BOND_MIN_DIST = 0.4
BOND_COLOR = (0.9, 0.9, 0.9)
SES_COLOR = (0.7, 0.75, 0.9)

CPK = {"H": (1.000, 1.000, 1.000), "C": (0.565, 0.565, 0.565), "N": (0.188, 0.314, 0.973),
       "O": (1.000, 0.051, 0.051), "F": (0.565, 0.878, 0.314), "Cl": (0.122, 0.941, 0.122),
       "Br": (0.651, 0.161, 0.161), "I": (0.580, 0.000, 0.580), "S": (1.000, 0.784, 0.196),
       "P": (1.000, 0.502, 0.000), "Fe": (0.878, 0.400, 0.200), "Zn": (0.490, 0.502, 0.690),
       "Cu": (0.784, 0.502, 0.200), "Mg": (0.541, 1.000, 0.000), "Ca": (0.239, 1.000, 0.000),
       "Na": (0.671, 0.361, 0.949), "K": (0.561, 0.251, 0.831)}
CPK_DEFAULT = (0.800, 0.400, 0.800)
VDW = {"H": 1.20, "C": 1.70, "N": 1.55, "O": 1.52, "F": 1.47, "Cl": 1.75, "Br": 1.85,
       "I": 1.98, "S": 1.80, "P": 1.80, "Fe": 1.80, "Zn": 1.39, "Cu": 1.40, "Mg": 1.73,
       "Ca": 2.31, "Na": 2.27, "K": 2.75}
VDW_DEFAULT = 1.70
COVALENT = {"H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66, "S": 1.05, "P": 1.07, "F": 0.57,
            "Cl": 1.02, "Br": 1.20, "I": 1.39, "Fe": 1.32, "Zn": 1.22, "Ca": 1.76, "Mg": 1.41,
            "Na": 1.66, "K": 2.03}
COVALENT_DEFAULT = 0.80

_TABLES = np.loadtxt(__file__.rsplit("/", 1)[0] + "/marching_cubes.txt", dtype=np.int64)
EDGE_TABLE = _TABLES[:, 0]
TRI_TABLE = _TABLES[:, 1:]
# Cell corners and the corners each of the 12 cell edges joins (the
# standard layout of the tables).
CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)
EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
                  [0, 4], [1, 5], [2, 6], [3, 7]], np.int64)
FIELD_BLOCK = 1 << 16


def covalent_radius(element: str) -> float:
    return COVALENT.get(element, COVALENT_DEFAULT)


def infer_bonds(positions, elements) -> np.ndarray:
    """i32[B, 2] (i < j, sorted rows): every pair with BOND_MIN_DIST <= d
    <= r_cov(i) + r_cov(j) + BOND_TOLERANCE, d in float64."""
    pos = np.asarray(positions, np.float64)
    cov = np.array([covalent_radius(e) for e in elements])
    n = pos.shape[0]
    reach = 2.0 * cov.max(initial=0.0) + BOND_TOLERANCE
    cell = np.floor(pos / reach).astype(np.int64)
    order = np.lexsort(cell.T[::-1])
    keys = {}
    for i in order:
        keys.setdefault(tuple(cell[i]), []).append(i)
    out = []
    for key, members in keys.items():
        a = np.array(members)
        nb = [j for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
              for j in keys.get((key[0] + dx, key[1] + dy, key[2] + dz), ())]
        b = np.array(nb)
        d = np.linalg.norm(pos[a][:, None] - pos[b][None], axis=-1)
        ok = (d >= BOND_MIN_DIST) & (d <= cov[a][:, None] + cov[b][None] + BOND_TOLERANCE)
        ok &= a[:, None] < b[None]
        ii, jj = np.nonzero(ok)
        out.append(np.stack([a[ii], b[jj]], axis=1))
    if n < 2 or not out:
        return np.zeros((0, 2), np.int32)
    pairs = np.concatenate(out)
    return np.unique(pairs, axis=0).astype(np.int32)


def molecule_bonds(positions, elements, conect) -> np.ndarray:
    """The bonds the viewer draws: the CONECT pairs where the file has
    any, else the inferred ones."""
    conect = np.asarray(conect, np.int64).reshape(-1, 2)
    if conect.shape[0]:
        return np.unique(np.sort(conect, axis=1), axis=0).astype(np.int32)
    return infer_bonds(positions, elements)


def ball_and_stick(positions, elements, bonds, atom_scale: float, bond_radius: float):
    """(sphere centres f32[N,3], radii f32[N], colours f32[N,3], cylinder
    p1, p2 f32[M,3], radii f32[M], colours f32[M,3])."""
    c = np.asarray(positions, np.float32)
    radii = (np.array([VDW.get(e, VDW_DEFAULT) for e in elements], np.float32)
             * np.float32(atom_scale))
    colors = np.array([CPK.get(e, CPK_DEFAULT) for e in elements], np.float32).reshape(-1, 3)
    bonds = np.asarray(bonds, np.int64).reshape(-1, 2)
    m = bonds.shape[0] if bond_radius > 0 else 0
    p1, p2 = c[bonds[:m, 0]], c[bonds[:m, 1]]
    return (c, radii, colors, p1, p2, np.full(m, bond_radius, np.float32),
            np.tile(np.asarray(BOND_COLOR, np.float32), (m, 1)))


class Field:
    """A clamped distance field f32[nz, ny, nx] on the grid from `lo` with
    step `res`."""

    def __init__(self, data, lo, res, clamp):
        self.data, self.lo, self.res, self.clamp = data, lo, res, clamp


def grid_of(centers, radii, probe: float, res: float):
    """(lo, (nx, ny, nz)) of the SES grid over the atoms: the count from
    the float64 span, the origin rounded to float32 (where the field's
    points and the vertices are measured from)."""
    c = np.asarray(centers, np.float64)
    pad = 2.0 * probe + float(np.max(radii)) + res
    lo = c.min(axis=0) - pad
    hi = c.max(axis=0) + pad
    dims = tuple(int(math.ceil(s / res)) + 1 for s in (hi - lo))
    return lo.astype(np.float32).astype(np.float64), dims


def distance_field(centers, radii, lo, dims, res: float, clamp: float, device) -> Field:
    """min over spheres of |p - c| - r at every grid point, clamped to
    +/- clamp (float32 arithmetic from float32 centres), on `device`. Each
    sphere writes the grid points within r + clamp + res of its nearest
    grid point (beyond them its value is the clamp), blocks of spheres at
    a time, by a scatter-min."""
    nx, ny, nz = dims
    c = torch.as_tensor(np.asarray(centers, np.float32), device=device)
    r = torch.as_tensor(np.asarray(radii, np.float32), device=device)
    data = torch.full((nz * ny * nx,), clamp, dtype=torch.float32, device=device)
    if c.shape[0] == 0:
        return Field(data.view(nz, ny, nx), lo, res, clamp)
    w = int(math.ceil((float(r.max()) + clamp) / res)) + 1
    ax = torch.arange(-w, w + 1, device=device)
    off = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    off = off[(off * off).sum(-1) <= w * w]
    lo_t = torch.as_tensor(np.asarray(lo, np.float32), device=device)
    dims_t = torch.tensor([nx, ny, nz], device=device)
    block = max(1, FIELD_BLOCK * 64 // off.shape[0])
    for s in range(0, c.shape[0], block):
        cb, rb = c[s:s + block], r[s:s + block]
        base = torch.round((cb - lo_t) / res).long()
        idx = base[:, None, :] + off[None]
        ok = ((idx >= 0) & (idx < dims_t)).all(-1)
        idx = idx[ok]
        ray = torch.nonzero(ok)[:, 0]
        p = lo_t + idx.float() * res
        diff = p - cb[ray]
        d2 = (diff[:, 2] * diff[:, 2] + diff[:, 1] * diff[:, 1]) + diff[:, 0] * diff[:, 0]
        dist = torch.clamp(torch.sqrt(d2) - rb[ray], -clamp, clamp)
        flat = idx[:, 0] + nx * (idx[:, 1] + ny * idx[:, 2])
        data.scatter_reduce_(0, flat, dist, reduce="amin")
    return Field(data.view(nz, ny, nx), lo, res, clamp)


def marching_cubes(field: Field, verts_only: bool = False):
    """(vertices f64[V,3], triangles i64[T,3]) of the 0 level set: one
    vertex per crossing grid edge, numbered by axis (x, y, z edges) and in
    each axis by the edge's flat index; the triangles from the standard
    tables, cell by cell."""
    data = field.data
    dev = data.device
    nz, ny, nx = data.shape
    inside = data < 0.0
    verts, base, flats = [], [], []
    count = 0
    lo = torch.as_tensor(np.asarray(field.lo, np.float64), device=dev)
    for axis in range(3):
        sl_a = [slice(None)] * 3
        sl_b = [slice(None)] * 3
        sl_a[2 - axis] = slice(0, -1)
        sl_b[2 - axis] = slice(1, None)
        a, b = data[tuple(sl_a)], data[tuple(sl_b)]
        cross = (a < 0.0) != (b < 0.0)
        flat = torch.nonzero(cross.reshape(-1))[:, 0]
        shape = cross.shape
        flats.append((flat, shape))
        base.append(count)
        count += flat.shape[0]
        v1 = a.reshape(-1)[flat].double()
        v2 = b.reshape(-1)[flat].double()
        iz = flat // (shape[1] * shape[2])
        iy = (flat // shape[2]) % shape[1]
        ix = flat % shape[2]
        p1 = torch.stack([ix, iy, iz], dim=1).double()
        den = v2 - v1
        t = torch.where(den.abs() < 1e-5, torch.zeros_like(den),
                        (0.0 - v1) / torch.where(den == 0, torch.ones_like(den), den))
        t = torch.where(v1.abs() < 1e-5, torch.zeros_like(t), t)
        t = torch.where(v2.abs() < 1e-5, torch.ones_like(t), t)
        p1[:, axis] += t
        verts.append(lo + p1 * field.res)
    vertices = torch.cat(verts)
    if verts_only:
        return vertices, None
    ci = torch.zeros((nz - 1, ny - 1, nx - 1), dtype=torch.long, device=dev)
    for k, (ox, oy, oz) in enumerate(CORNERS.tolist()):
        ci |= inside[oz:nz - 1 + oz, oy:ny - 1 + oy, ox:nx - 1 + ox].long() << k
    edge_table = torch.as_tensor(EDGE_TABLE, device=dev)
    tri_table = torch.as_tensor(TRI_TABLE, device=dev)
    active = torch.nonzero((edge_table[ci] != 0).reshape(-1))[:, 0]
    cz = active // ((ny - 1) * (nx - 1))
    cy = (active // (nx - 1)) % (ny - 1)
    cx = active % (nx - 1)
    rows = tri_table[ci.reshape(-1)[active]]
    cell_vert = torch.empty((active.shape[0], 12), dtype=torch.long, device=dev)
    for e, (c0, c1) in enumerate(EDGES.tolist()):
        o0, o1 = CORNERS[c0], CORNERS[c1]
        axis = int(np.nonzero(o0 != o1)[0][0])
        m = np.minimum(o0, o1)
        flat, shape = flats[axis]
        q = ((cz + int(m[2])) * shape[1] + cy + int(m[1])) * shape[2] + cx + int(m[0])
        pos = torch.searchsorted(flat, q)
        found = (pos < flat.shape[0]) & (flat[torch.clamp_max(pos, flat.shape[0] - 1)] == q)
        cell_vert[:, e] = torch.where(found, base[axis] + pos, -1)
    tris = []
    for k in range(0, 15, 3):
        valid = rows[:, k] >= 0
        sel = torch.nonzero(valid)[:, 0]
        if sel.numel() == 0:
            break
        ids = torch.stack([cell_vert[sel, rows[sel, k + j]] for j in range(3)], dim=1)
        tris.append(ids[(ids >= 0).all(dim=1)])
    # Cell-major order, as a cell's triangles follow each other.
    triangles = torch.cat(tris) if tris else torch.zeros((0, 3), dtype=torch.long, device=dev)
    return vertices, triangles


def _trilinear(field: Field, pts):
    """The field at points f64[n, 3] (outside the grid: the clamp)."""
    data = field.data
    nz, ny, nx = data.shape
    lo = torch.as_tensor(np.asarray(field.lo, np.float64), device=pts.device)
    f = (pts - lo) / field.res
    i0 = torch.floor(f).long()
    t = f - i0
    out = torch.zeros(pts.shape[0], dtype=torch.float64, device=pts.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz
                ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz)
                v = data[iz.clamp(0, nz - 1), iy.clamp(0, ny - 1), ix.clamp(0, nx - 1)].double()
                v = torch.where(ok, v, torch.full_like(v, field.clamp))
                w = ((t[:, 0] if dx else 1 - t[:, 0]) * (t[:, 1] if dy else 1 - t[:, 1])
                     * (t[:, 2] if dz else 1 - t[:, 2]))
                out = out + w * v
    return out


def _normals(field: Field, pts):
    g = []
    for axis in range(3):
        dp = torch.zeros(3, dtype=torch.float64, device=pts.device)
        dp[axis] = field.res
        g.append(_trilinear(field, pts + dp) - _trilinear(field, pts - dp))
    n = torch.stack(g, dim=1)
    length = torch.linalg.vector_norm(n, dim=1, keepdim=True)
    fallback = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=pts.device)
    return torch.where(length > 1e-4, n / torch.where(length > 0, length, 1.0), fallback)


def _components(n_vert: int, tris):
    """[n_vert] label of each vertex: the smallest vertex index of its
    connected component over the triangles' edges."""
    dev = tris.device
    label = torch.arange(n_vert, device=dev)
    a = torch.cat([tris[:, 0], tris[:, 1], tris[:, 2]])
    b = torch.cat([tris[:, 1], tris[:, 2], tris[:, 0]])
    while True:
        m = torch.minimum(label[a], label[b])
        new = label.clone()
        new.scatter_reduce_(0, a, m, reduce="amin")
        new.scatter_reduce_(0, b, m, reduce="amin")
        new = new[new]
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            return label
        label = new


def ses(centers, radii, probe: float, res: float, device):
    """(vertices f32[V,3], normals f32[V,3], triangles i64[T,3]) of the SES."""
    centers = np.asarray(centers, np.float64)
    radii = np.asarray(radii, np.float64)
    clamp = 2.0 * res
    lo, dims = grid_of(centers, radii, probe, res)
    sas = distance_field(centers, radii + probe, lo, dims, res, clamp, device)
    sas_v, _ = marching_cubes(sas, verts_only=True)
    if sas_v.shape[0] == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.int64))
    sas_v = sas_v.float()
    cell = torch.floor(sas_v / (res * 0.5)).long()
    _, inv = torch.unique(cell, dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), sas_v.shape[0], dtype=torch.long,
                       device=sas_v.device)
    first.scatter_reduce_(0, inv, torch.arange(sas_v.shape[0], device=sas_v.device),
                          reduce="amin")
    probes = sas_v[torch.sort(first).values].double().cpu().numpy()
    field = distance_field(probes, np.full(probes.shape[0], probe), lo, dims, res, clamp,
                           device)
    v, tris = marching_cubes(field)
    n = _normals(field, v)
    v32 = v.float()
    if tris.shape[0]:
        label = _components(v.shape[0], tris)
        roots = torch.unique(label)
        if roots.shape[0] > 1:
            reps = v32[roots].double()
            c = torch.as_tensor(centers, device=v.device)
            r = torch.as_tensor(radii, device=v.device)
            ok = torch.zeros(roots.shape[0], dtype=torch.bool, device=v.device)
            for s in range(0, roots.shape[0], 256):
                d = torch.linalg.vector_norm(reps[s:s + 256, None] - c[None], dim=-1)
                ok[s:s + 256] = (d < r[None] + 1.5 * probe).any(dim=1)
            keep_root = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
            keep_root[roots[ok]] = True
            tris = tris[keep_root[label[tris[:, 0]]]]
            used = torch.unique(tris)
            remap = torch.full((v.shape[0],), -1, dtype=torch.long, device=v.device)
            remap[used] = torch.arange(used.shape[0], device=v.device)
            v32, n, tris = v32[used], n[used], remap[tris]
    return (v32.cpu().numpy(), (-n).float().cpu().numpy(), tris.cpu().numpy())


def scene_geometry(geo: dict, config: dict, device) -> dict:
    """The scene of a molecule kind's `geo` (the generator's atoms,
    elements, HETATM flags and CONECT pairs) under the configuration's
    display keys: ball-and-stick atoms and bonds, and with show_surface
    the SES over the standard atoms (surface_atom_mode "all": the atoms
    stay). Other styles and modes raise."""
    if config["display_style"] != "ball-and-stick":
        raise ValueError("the reference supports display_style 'ball-and-stick' only")
    if config["show_surface"] and config["surface_atom_mode"] != "all":
        raise ValueError("the reference supports surface_atom_mode 'all' only")
    pos = np.asarray(geo["positions"], np.float32)
    elements = list(geo["elements"])
    bonds = molecule_bonds(pos, elements, geo["conect"])
    c, r, col, p1, p2, cr, cc = ball_and_stick(pos, elements, bonds,
                                               float(config["atom_scale"]),
                                               float(config["bond_radius"]))
    out = {"sphere_centers": c, "sphere_radii": r, "sphere_colors": col, "cyl_p1": p1,
           "cyl_p2": p2, "cyl_radii": cr, "cyl_colors": cc,
           "tri_verts": np.zeros((0, 3, 3), np.float32),
           "tri_normals": np.zeros((0, 3, 3), np.float32),
           "tri_colors": np.zeros((0, 3), np.float32)}
    std = ~np.asarray(geo["is_het"], bool)
    if config["show_surface"] and std.any():
        radii = np.array([VDW.get(e, VDW_DEFAULT) for e, s in zip(elements, std) if s],
                         np.float32)
        v, n, tris = ses(pos[std].astype(np.float64), radii.astype(np.float64),
                         float(config["probe_radius"]), float(config["surface_resolution"]),
                         device)
        out["tri_verts"] = v[tris]
        out["tri_normals"] = n[tris]
        out["tri_colors"] = np.tile(np.asarray(SES_COLOR, np.float32), (tris.shape[0], 1))
    return out
