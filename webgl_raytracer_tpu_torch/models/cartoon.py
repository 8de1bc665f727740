"""Protein backbone cartoon generator: helices as pinched red/white solid
ribbons, beta sheets as flat green ribbons with arrowheads, loops as gray
tubes.

The port's own copy of webgl_raytracer_tpu/models/cartoon.py (host numpy,
the same arithmetic, so the same mesh bit for bit). That module follows
the reference viewer's cartoon.js: residue assembly from N/CA/C/O with
altLoc/occupancy preference, DSSP-style H-bond energy
E = 0.084*332*(1/rON + 1/rCH - 1/rOH - 1/rCN) with cutoff -0.5, helix
assignment from i->i+3/4/5 H-bonds and sheets from mutual pairs,
short-segment cleanup (minHelix 4 / minSheet 2), PDB HELIX/SHEET ranges
taking precedence with DSSP filling gaps, per-strand sheet normals from
inter-strand contact directions with a PCA plane fallback and smoothing,
rotation-minimizing ribbon frames, Catmull-Rom resampling, and the
strip/tube/masked loop tube/pinched-profile solid ribbon volume/arrow
prism emitters with the default option table. Line references (:N) are
to cartoon.js.

Host-side numpy implementation: O(R^2) H-bond energies evaluated as masked
matrix math, PCA plane fits via eigh, splines vectorized over control
points; the per-strand frame propagation stays a (short) sequential loop,
as it is inherently recursive.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from .mesh import MeshBuilder, TriangleMesh
from .molecular import MolData, SecondaryRange

DEFAULT_OPTIONS = dict(
    helix_radius=0.35,
    loop_radius=0.2,
    sheet_width=2.9,
    helix_width=2.7,
    helix_edge_width_scale=0.72,
    helix_cross_section_segments=3,
    helix_thickness=0.25,
    sheet_thickness=0.25,
    helix_sides=20,
    loop_sides=16,
    helix_subdivisions=8,
    loop_subdivisions=7,
    sheet_subdivisions=6,
    max_gap=4.8,
    arrow_base_scale=1.8,
    arrow_length=2.3,
    hbond_distance=4.0,
    hbond_energy_cutoff=-0.5,
    helix_front_color=(0.85, 0.1, 0.1),
    helix_back_color=(0.95, 0.95, 0.95),
    sheet_color=(0.2, 0.7, 0.2),
    loop_color=(0.65, 0.65, 0.65),
)

BACKBONE_NAMES = ("N", "CA", "C", "O")


# --------------------------------------------------------------------------
# small vector helpers (host, float64)

def _norm(v):
    n = np.linalg.norm(v)
    return v / n if n > 1e-8 else np.zeros(3)


def _project_out(a, n):
    return a - n * float(np.dot(a, n))


def _rotate_around_axis(v, axis, angle):
    c, s = math.cos(angle), math.sin(angle)
    return v * c + np.cross(axis, v) * s + axis * float(np.dot(axis, v)) * (1 - c)


def _pick_perpendicular(t):
    up = np.array([0.0, 1.0, 0.0]) if abs(t[1]) < 0.8 else np.array([1.0, 0.0, 0.0])
    return _norm(np.cross(up, t))


def smoothstep(t):
    x = np.clip(t, 0.0, 1.0)
    return x * x * (3 - 2 * x)


# --------------------------------------------------------------------------
# residues

@dataclass
class Residue:
    key: str
    chain_id: str
    res_seq: int
    i_code: str
    res_name: str
    order: int
    index: int = -1
    # positions of N/CA/C/O; alt metadata used for picking preference
    atoms: dict = field(default_factory=dict)      # name -> np.ndarray[3]
    _meta: dict = field(default_factory=dict)      # name -> (alt_loc, occupancy)
    complete: bool = False
    plane_normal: Optional[np.ndarray] = None


def _prefer(alt_loc: str) -> bool:
    return (not alt_loc) or alt_loc == "A"


def build_residues(mol: MolData) -> list[Residue]:
    """Group non-HETATM atoms into residues keyed by chain:resSeq:iCode,
    keeping the preferred altLoc/occupancy backbone atom per slot."""
    residues: dict[str, Residue] = {}
    order = 0
    n = mol.num_atoms
    for i in range(n):
        if mol.is_het[i]:
            continue
        if not mol.res_seq_valid[i]:
            continue
        chain = mol.chain_ids[i] if mol.chain_ids else " "
        i_code = mol.i_codes[i] if mol.i_codes else ""
        res_seq = int(mol.res_seqs[i])
        key = f"{chain}:{res_seq}:{i_code}"
        res = residues.get(key)
        if res is None:
            order += 1
            res = Residue(
                key=key, chain_id=chain, res_seq=res_seq, i_code=i_code,
                res_name=mol.res_names[i] if mol.res_names else "",
                order=order,
            )
            residues[key] = res

        name = (mol.names[i] or "").strip().upper()
        canonical = "O" if name == "OXT" else name
        if canonical in BACKBONE_NAMES:
            alt = mol.alt_locs[i] if mol.alt_locs else ""
            occ = float(mol.occupancies[i]) if mol.occupancies.size else float("nan")
            occ = occ if np.isfinite(occ) else 0.0
            existing = res._meta.get(canonical)
            take = True
            if existing is not None:
                e_alt, e_occ = existing
                if _prefer(alt) and not _prefer(e_alt):
                    take = True
                elif _prefer(e_alt) and not _prefer(alt):
                    take = False
                else:
                    take = occ > e_occ
            if take:
                res.atoms[canonical] = mol.positions[i].astype(np.float64)
                res._meta[canonical] = (alt, occ)

    out = sorted(residues.values(), key=lambda r: r.order)
    for idx, res in enumerate(out):
        res.index = idx
        res.complete = all(k in res.atoms for k in BACKBONE_NAMES)
        if res.complete:
            v1 = res.atoms["C"] - res.atoms["CA"]
            v2 = res.atoms["N"] - res.atoms["CA"]
            res.plane_normal = _norm(np.cross(v1, v2))
    return out


# --------------------------------------------------------------------------
# DSSP-style H-bonds and secondary structure

def compute_hbonds(residues: list[Residue], hbond_distance=4.0,
                   hbond_energy_cutoff=-0.5) -> list[set]:
    """hbonds[i] = set of acceptor->donor partners j with E < cutoff.

    Vectorized: the Kabsch-Sander electrostatic energy is evaluated as
    matrix math over all (i, j) pairs with |O_i - N_j| <= maxDist and a
    valid preceding residue for j (for the amide H estimate)."""
    r = len(residues)
    hbonds: list[set] = [set() for _ in range(r)]
    if r < 2:
        return hbonds

    O = np.stack([res.atoms["O"] for res in residues])
    C = np.stack([res.atoms["C"] for res in residues])
    N = np.stack([res.atoms["N"] for res in residues])
    chains = np.array([res.chain_id for res in residues])

    has_prev = np.zeros(r, bool)
    has_prev[1:] = chains[1:] == chains[:-1]

    # Amide H estimate: N_j + normalize(N_j - C_{j-1}).
    hn = np.zeros_like(N)
    hn[1:] = N[1:] - C[:-1]
    hn_len = np.linalg.norm(hn, axis=1)
    valid_h = has_prev & (hn_len >= 1e-6)
    safe = np.where(hn_len > 0, hn_len, 1.0)[:, None]
    H = N + hn / safe

    d_on = np.linalg.norm(O[:, None, :] - N[None, :, :], axis=2)
    pair_ok = (d_on <= hbond_distance) & valid_h[None, :]
    np.fill_diagonal(pair_ok, False)
    ii, jj = np.nonzero(pair_ok)
    if ii.size == 0:
        return hbonds

    r_on = d_on[ii, jj]
    r_ch = np.linalg.norm(C[ii] - H[jj], axis=1)
    r_oh = np.linalg.norm(O[ii] - H[jj], axis=1)
    r_cn = np.linalg.norm(C[ii] - N[jj], axis=1)
    ok = (r_on >= 1e-6) & (r_ch >= 1e-6) & (r_oh >= 1e-6) & (r_cn >= 1e-6)
    energy = np.where(
        ok, 0.084 * 332.0 * (1.0 / r_on + 1.0 / r_ch - 1.0 / r_oh - 1.0 / r_cn), 0.0
    )
    bond = energy < hbond_energy_cutoff
    for a, b in zip(ii[bond], jj[bond]):
        hbonds[a].add(int(b))
    return hbonds


def assign_secondary_structure(residues: list[Residue], hbonds: list[set]) -> list[str]:
    """'H' from i->i+3/4/5 H-bonds, 'E' from mutual pairs (|j-i|>=4)."""
    r = len(residues)
    ss = ["C"] * r
    for i in range(r):
        for offset in (3, 4, 5):
            j = i + offset
            if j < r and residues[i].chain_id == residues[j].chain_id and j in hbonds[i]:
                for k in range(i + 1, j + 1):
                    ss[k] = "H"
    for i in range(r):
        for j in range(i + 4, r):
            if ss[i] == "H" or ss[j] == "H":
                continue
            if residues[i].chain_id != residues[j].chain_id:
                continue
            if j in hbonds[i] and i in hbonds[j]:
                ss[i] = "E"
                ss[j] = "E"
    return ss


def adjust_short_segments(residues: list[Residue], ss: list[str],
                          min_helix=4, min_sheet=2) -> list[str]:
    adjusted = ss[:]
    r = len(residues)
    start = 0
    while start < r:
        chain = residues[start].chain_id
        end = start + 1
        while end < r and residues[end].chain_id == chain:
            end += 1
        seg_start = start
        for i in range(start + 1, end + 1):
            if i == end or adjusted[i] != adjusted[seg_start]:
                length = i - seg_start
                kind = adjusted[seg_start]
                if (kind == "H" and length < min_helix) or (kind == "E" and length < min_sheet):
                    for k in range(seg_start, i):
                        adjusted[k] = "C"
                seg_start = i
        start = end
    return adjusted


def apply_secondary_ranges(residues: list[Residue], ss: list[str],
                           ranges: list[SecondaryRange], kind: str) -> int:
    if not ranges:
        return 0
    count = 0
    for rng in ranges:
        chain = rng.chain_id or " "
        end_chain = rng.end_chain_id or chain
        for res in residues:
            if res.chain_id != chain and res.chain_id != end_chain:
                continue
            if res.res_seq < rng.start_seq or res.res_seq > rng.end_seq:
                continue
            if ss[res.index] != kind:
                ss[res.index] = kind
                count += 1
    return count


# --------------------------------------------------------------------------
# sheet normals

def residue_tangent(index: int, residues: list[Residue]) -> np.ndarray:
    curr = residues[index]
    prev = residues[index - 1] if index > 0 and residues[index - 1].chain_id == curr.chain_id else None
    nxt = (residues[index + 1]
           if index < len(residues) - 1 and residues[index + 1].chain_id == curr.chain_id
           else None)
    ca = curr.atoms["CA"]
    if prev and nxt:
        t = (nxt.atoms["CA"] - ca) + (ca - prev.atoms["CA"])
    elif nxt:
        t = nxt.atoms["CA"] - ca
    elif prev:
        t = ca - prev.atoms["CA"]
    else:
        t = np.array([1.0, 0.0, 0.0])
    return _norm(t)


def is_inter_strand_pair(residues, i, j) -> bool:
    return residues[i].chain_id != residues[j].chain_id or abs(j - i) > 2


def collect_sheet_distance_contacts(residues, ss, hbond_distance=4.0):
    """Directed O_i -> N_j contacts between sheet residues on different
    strands within the H-bond distance."""
    directed = []
    outgoing = [set() for _ in residues]
    sheet_idx = [i for i in range(len(residues)) if ss[i] == "E"]
    for a in range(len(sheet_idx)):
        for b in range(a + 1, len(sheet_idx)):
            i, j = sheet_idx[a], sheet_idx[b]
            if not is_inter_strand_pair(residues, i, j):
                continue
            for src, dst in ((i, j), (j, i)):
                d = residues[dst].atoms["N"] - residues[src].atoms["O"]
                dist = np.linalg.norm(d)
                if 1e-6 < dist <= hbond_distance:
                    directed.append({"from": src, "to": dst, "direction": d})
                    outgoing[src].add(dst)
    return directed, outgoing


def fit_plane_normal(points: np.ndarray) -> np.ndarray:
    """Best-fit plane normal (smallest-eigenvalue direction of the
    covariance; the reference's power iteration computes the same plane)."""
    pts = np.asarray(points, np.float64)
    if pts.shape[0] < 3:
        return np.array([0.0, 1.0, 0.0])
    centered = pts - pts.mean(axis=0)
    cov = centered.T @ centered
    _, vecs = np.linalg.eigh(cov)
    n = vecs[:, 0]
    return n if np.linalg.norm(n) > 1e-6 else np.array([0.0, 1.0, 0.0])


def _make_incoming(outgoing, count):
    incoming = [set() for _ in range(count)]
    for i, partners in enumerate(outgoing):
        for j in partners:
            if 0 <= j < count:
                incoming[j].add(i)
    return incoming


def compute_sheet_normals(residues, ss, hbonds, options=None) -> list:
    """Per-residue sheet normals from local inter-strand contact directions
    (normal = tangent x avg contact dir), gap-filled along each strand,
    PCA-plane fallback, lightly smoothed."""
    opts = {**DEFAULT_OPTIONS, **(options or {})}
    r = len(residues)
    aligned = [None] * r
    _, outgoing = collect_sheet_distance_contacts(residues, ss, opts["hbond_distance"])
    incoming = _make_incoming(outgoing, r)
    strands = [s for s in segment_by_type(residues, ss, opts["max_gap"]) if s["type"] == "E"]

    for strand in strands:
        members = [res.index for res in strand["residues"]]
        local = [None] * len(members)
        strand_ref = None

        for m, i in enumerate(members):
            t = residue_tangent(i, residues)
            if np.linalg.norm(t) < 1e-6:
                continue
            h_accum = np.zeros(3)
            h_ref = None
            h_count = 0

            def accumulate(raw, t=t):
                nonlocal h_accum, h_ref, h_count
                if np.linalg.norm(raw) < 1e-6:
                    return
                d = _project_out(raw, t)
                if np.linalg.norm(d) < 1e-6:
                    return
                d = _norm(d)
                if h_ref is not None and np.dot(d, h_ref) < 0:
                    d = -d
                if h_ref is None:
                    h_ref = d
                h_accum = h_accum + d
                h_count += 1

            for j in outgoing[i]:
                if ss[j] == "E" and is_inter_strand_pair(residues, i, j):
                    accumulate(residues[j].atoms["N"] - residues[i].atoms["O"])
            for j in incoming[i]:
                if ss[j] == "E" and is_inter_strand_pair(residues, i, j):
                    accumulate(residues[i].atoms["N"] - residues[j].atoms["O"])

            if h_count > 0 and np.linalg.norm(h_accum) > 1e-6:
                n = np.cross(t, _norm(h_accum))
                if np.linalg.norm(n) > 1e-6:
                    n = _norm(n)
                    if strand_ref is not None and np.dot(n, strand_ref) < 0:
                        n = -n
                    if strand_ref is None:
                        strand_ref = n
                    local[m] = n

        ca = np.stack([residues[i].atoms["CA"] for i in members])
        fallback = fit_plane_normal(ca)
        if strand_ref is not None and np.dot(fallback, strand_ref) < 0:
            fallback = -fallback

        last = None
        for m in range(len(local)):
            if local[m] is not None:
                last = local[m]
            elif last is not None:
                local[m] = last
        last = None
        for m in range(len(local) - 1, -1, -1):
            if local[m] is not None:
                last = local[m]
            elif last is not None:
                local[m] = last
        local = [fallback if n is None else n for n in local]

        for _ in range(2):
            nxt = local[:]
            for m in range(1, len(local) - 1):
                left, center, right = local[m - 1], local[m], local[m + 1]
                if np.dot(left, center) < 0:
                    left = -left
                if np.dot(right, center) < 0:
                    right = -right
                blended = center * 2.0 + left + right
                if np.linalg.norm(blended) > 1e-6:
                    nxt[m] = _norm(blended)
            local = nxt

        for m in range(1, len(local)):
            if np.dot(local[m], local[m - 1]) < 0:
                local[m] = -local[m]

        for m, i in enumerate(members):
            aligned[i] = local[m]

    return aligned


def compute_sheet_strand_diagnostics(residues, ss, hbonds, sheet_normals,
                                     segments, options=None):
    """Per-strand H-bond contact counts and normal-vs-bond angle stats
    (cartoon.js:1442-1514)."""
    opts = {**DEFAULT_OPTIONS, **(options or {})}
    directed, _ = collect_sheet_distance_contacts(residues, ss, opts["hbond_distance"])
    diagnostics = []
    sheet_segments = [s for s in segments if s["type"] == "E"]
    for strand_index, segment in enumerate(sheet_segments):
        indices = [res.index for res in segment["residues"]]
        residue_set = set(indices)
        strand_normal = next((sheet_normals[i] for i in indices
                              if sheet_normals[i] is not None), None)
        outgoing_count = incoming_count = 0
        partners = set()
        angles = []
        for contact in directed:
            from_in = contact["from"] in residue_set
            to_in = contact["to"] in residue_set
            if from_in == to_in:
                continue
            if from_in:
                outgoing_count += 1
                partners.add(contact["to"])
            else:
                incoming_count += 1
                partners.add(contact["from"])
            inside = contact["from"] if from_in else contact["to"]
            normal = sheet_normals[inside] if sheet_normals[inside] is not None else strand_normal
            if normal is not None:
                n = _norm(np.asarray(normal))
                d = _norm(contact["direction"])
                if np.linalg.norm(n) >= 1e-6 and np.linalg.norm(d) >= 1e-6:
                    angles.append(math.degrees(math.acos(
                        float(np.clip(abs(np.dot(n, d)), 0, 1)))))
        diagnostics.append({
            "strand_index": strand_index,
            "chain_id": segment["residues"][0].chain_id if segment["residues"] else "?",
            "start_seq": segment["residues"][0].res_seq if segment["residues"] else None,
            "end_seq": segment["residues"][-1].res_seq if segment["residues"] else None,
            "residue_count": len(segment["residues"]),
            "outgoing_count": outgoing_count,
            "incoming_count": incoming_count,
            "total_count": outgoing_count + incoming_count,
            "partner_residue_count": len(partners),
            "angle_count": len(angles),
            "angle_mean": float(np.mean(angles)) if angles else None,
            "angle_min": float(np.min(angles)) if angles else None,
            "angle_max": float(np.max(angles)) if angles else None,
        })
    return diagnostics


# --------------------------------------------------------------------------
# splines + frames

def resample_catmull_rom(points: np.ndarray, subdivisions: int) -> np.ndarray:
    points = np.asarray(points, np.float64)
    if subdivisions <= 1 or points.shape[0] < 2:
        return points.copy()
    n = points.shape[0]
    p0 = points[np.maximum(np.arange(n - 1) - 1, 0)]
    p1 = points[:-1]
    p2 = points[1:]
    p3 = points[np.minimum(np.arange(1, n) + 1, n - 1)]
    t = (np.arange(subdivisions) / subdivisions)[None, :, None]
    t2 = t * t
    t3 = t2 * t
    m0 = -0.5 * t3 + t2 - 0.5 * t
    m1 = 1.5 * t3 - 2.5 * t2 + 1.0
    m2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    m3 = 0.5 * t3 - 0.5 * t2
    seg = p0[:, None] * m0 + p1[:, None] * m1 + p2[:, None] * m2 + p3[:, None] * m3
    return np.concatenate([seg.reshape(-1, 3), points[-1:]], axis=0)


def hermite_interpolate(points: np.ndarray, subdivisions: int, tension=0.5) -> np.ndarray:
    points = np.asarray(points, np.float64)
    if subdivisions <= 1 or points.shape[0] < 2:
        return points.copy()
    n = points.shape[0]
    p0 = points[np.maximum(np.arange(n - 1) - 1, 0)]
    p1 = points[:-1]
    p2 = points[1:]
    p3 = points[np.minimum(np.arange(1, n) + 1, n - 1)]
    scale = (1 - tension) * 0.5
    m1v = (p2 - p0) * scale
    m2v = (p3 - p1) * scale
    t = (np.arange(subdivisions) / subdivisions)[None, :, None]
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    seg = p1[:, None] * h00 + m1v[:, None] * h10 + p2[:, None] * h01 + m2v[:, None] * h11
    return np.concatenate([seg.reshape(-1, 3), points[-1:]], axis=0)


def smooth_points_fixed_endpoints(points: np.ndarray, iterations=1, weight=0.5) -> np.ndarray:
    pts = np.asarray(points, np.float64).copy()
    if pts.shape[0] < 3 or iterations <= 0:
        return pts
    w = float(np.clip(weight, 0, 1))
    for _ in range(iterations):
        avg = 0.5 * (pts[:-2] + pts[2:])
        pts[1:-1] = pts[1:-1] * (1 - w) + avg * w
    return pts


def compute_tangents(points: np.ndarray) -> np.ndarray:
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    t = np.zeros_like(pts)
    t[0] = pts[1] - pts[0]
    t[-1] = pts[-1] - pts[-2]
    if n > 2:
        t[1:-1] = (pts[2:] - pts[1:-1]) + (pts[1:-1] - pts[:-2])
    lens = np.linalg.norm(t, axis=1, keepdims=True)
    return np.where(lens > 1e-8, t / np.where(lens > 0, lens, 1), 0.0)


def compute_ribbon_frames(points, normal_hint=None):
    """Rotation-minimizing frames along a polyline (cartoon.js:239-276)."""
    pts = np.asarray(points, np.float64)
    tangents = compute_tangents(pts)
    n_pts = pts.shape[0]
    normals = np.zeros_like(pts)
    binormals = np.zeros_like(pts)

    n0 = None
    if normal_hint is not None:
        proj = _project_out(np.asarray(normal_hint, np.float64), tangents[0])
        if np.linalg.norm(proj) >= 1e-6:
            n0 = _norm(proj)
    if n0 is None:
        n0 = _pick_perpendicular(tangents[0])
    b0 = _norm(np.cross(tangents[0], n0))
    normals[0] = _norm(np.cross(b0, tangents[0]))
    binormals[0] = b0

    for i in range(1, n_pts):
        prev_t, t = tangents[i - 1], tangents[i]
        n = normals[i - 1]
        axis = np.cross(prev_t, t)
        axis_len = np.linalg.norm(axis)
        if axis_len > 1e-6:
            angle = math.acos(float(np.clip(np.dot(prev_t, t), -1, 1)))
            n = _rotate_around_axis(n, axis / axis_len, angle)
        if np.dot(n, normals[i - 1]) < 0:
            n = -n
        b = _norm(np.cross(t, n))
        normals[i] = _norm(np.cross(b, t))
        binormals[i] = b
    return tangents, normals, binormals


def compute_ribbon_frames_with_targets(points, target_normals, weight=0.7):
    pts = np.asarray(points, np.float64)
    tangents = compute_tangents(pts)
    n_pts = pts.shape[0]
    normals = np.zeros_like(pts)
    binormals = np.zeros_like(pts)

    t0 = tangents[0]
    n0 = None
    if target_normals[0] is not None:
        proj = _project_out(np.asarray(target_normals[0], np.float64), t0)
        if np.linalg.norm(proj) >= 1e-6:
            n0 = _norm(proj)
    if n0 is None:
        n0 = _pick_perpendicular(t0)
    b0 = _norm(np.cross(t0, n0))
    normals[0] = _norm(np.cross(b0, t0))
    binormals[0] = b0
    prev_target = normals[0]

    for i in range(1, n_pts):
        prev_t, t = tangents[i - 1], tangents[i]
        n = normals[i - 1]
        axis = np.cross(prev_t, t)
        axis_len = np.linalg.norm(axis)
        if axis_len > 1e-6:
            angle = math.acos(float(np.clip(np.dot(prev_t, t), -1, 1)))
            n = _rotate_around_axis(n, axis / axis_len, angle)

        target = None
        if target_normals[i] is not None:
            proj = _project_out(np.asarray(target_normals[i], np.float64), t)
            if np.linalg.norm(proj) >= 1e-6:
                target = _norm(proj)
        if target is None:
            target = n
        if prev_target is not None and np.dot(target, prev_target) < 0:
            target = -target
        if np.dot(target, n) < 0:
            target = -target

        blended = n * (1 - weight) + target * weight
        if np.linalg.norm(blended) < 1e-6:
            blended = target
        blended = _norm(blended)
        if np.dot(blended, target) < 0:
            blended = -blended

        b = _norm(np.cross(t, blended))
        normals[i] = _norm(np.cross(b, t))
        binormals[i] = b
        prev_target = target
    return tangents, normals, binormals


def compute_flat_sheet_frames(points, sheet_normal):
    pts = np.asarray(points, np.float64)
    tangents = compute_tangents(pts)
    sn = _norm(np.asarray(sheet_normal, np.float64))
    normals = np.zeros_like(pts)
    binormals = np.zeros_like(pts)
    for i in range(pts.shape[0]):
        t = tangents[i]
        b = np.cross(t, sn)
        b = _pick_perpendicular(t) if np.linalg.norm(b) < 1e-6 else _norm(b)
        if i > 0 and np.dot(b, binormals[i - 1]) < 0:
            b = -b
        normals[i] = _norm(np.cross(b, t))
        binormals[i] = b
    return tangents, normals, binormals


# --------------------------------------------------------------------------
# geometry emitters

def compute_ribbon_half_widths(width, edge_width_scale=1.0):
    half_w = width * 0.5
    edge_half_w = half_w * float(np.clip(edge_width_scale, 0.2, 1.0))
    return half_w, edge_half_w


def make_tapered_widths(count, full_width, end_width, fraction=0.2):
    if count <= 1:
        return np.array([full_width])
    ramp = max(1, int(count * np.clip(fraction, 0.05, 0.45)))
    d = np.minimum(np.arange(count), count - 1 - np.arange(count))
    t = smoothstep(d / ramp)
    widths = np.where(d >= ramp, full_width, end_width * (1 - t) + full_width * t)
    return widths


def append_strip(out: MeshBuilder, points_a, points_b, normals_a, normals_b, color, flip):
    points_a = np.asarray(points_a)
    points_b = np.asarray(points_b)
    n = points_a.shape[0]
    if n < 2 or points_b.shape[0] != n:
        return
    verts = np.empty((n * 2, 3))
    verts[0::2] = points_a
    verts[1::2] = points_b
    norms = np.empty((n * 2, 3))
    norms[0::2] = normals_a
    norms[1::2] = normals_b
    base = out.add_vertices(verts, norms)

    i = np.arange(n - 1)
    i0 = base + i * 2
    i1 = i0 + 1
    i2 = base + (i + 1) * 2 + 1
    i3 = base + (i + 1) * 2
    if flip:
        tris = np.stack([np.stack([i0, i1, i2], 1), np.stack([i0, i2, i3], 1)], 1)
    else:
        tris = np.stack([np.stack([i0, i2, i1], 1), np.stack([i0, i3, i2], 1)], 1)
    out.add_triangles(tris.reshape(-1, 3), color)


def _tube_vertices(points, radius, sides, reference_normal=None):
    _, normals, binormals = compute_ribbon_frames(points, reference_normal)
    angles = 2 * np.pi * np.arange(sides) / sides
    radial = (normals[:, None, :] * np.cos(angles)[None, :, None]
              + binormals[:, None, :] * np.sin(angles)[None, :, None])
    pos = np.asarray(points)[:, None, :] + radial * radius
    return pos.reshape(-1, 3), radial.reshape(-1, 3)


def _tube_indices(base, n_points, sides, segment_mask=None):
    segs = []
    for i in range(n_points - 1):
        if segment_mask is not None and not segment_mask[i]:
            continue
        k = np.arange(sides)
        k_next = (k + 1) % sides
        i0 = base + i * sides + k
        i1 = base + (i + 1) * sides + k
        i2 = base + (i + 1) * sides + k_next
        i3 = base + i * sides + k_next
        segs.append(np.stack([i0, i1, i2], 1))
        segs.append(np.stack([i0, i2, i3], 1))
    return np.concatenate(segs) if segs else np.zeros((0, 3), np.int64)


def append_tube(out: MeshBuilder, points, radius, sides, color,
                segment_mask=None, reference_normal=None):
    points = np.asarray(points)
    if points.shape[0] < 2:
        return
    verts, norms = _tube_vertices(points, radius, sides, reference_normal)
    base = out.add_vertices(verts, norms)
    tris = _tube_indices(base, points.shape[0], sides, segment_mask)
    if tris.shape[0]:
        out.add_triangles(tris, color)


def append_ribbon(out: MeshBuilder, points, normal_hint, widths, color,
                  double_sided=False, back_color=None):
    """Flat ribbon strip (cartoon.js appendRibbon / appendRibbonDoubleSided)."""
    points = np.asarray(points)
    n = points.shape[0]
    if n < 2:
        return
    _, normals, binormals = compute_ribbon_frames(points, normal_hint)
    half = np.asarray(widths)[:, None] * 0.5
    left = points - binormals * half
    right = points + binormals * half
    verts = np.empty((n * 2, 3))
    verts[0::2] = left
    verts[1::2] = right
    norms = np.repeat(normals, 2, axis=0)
    base = out.add_vertices(verts, norms)
    i = np.arange(n - 1)
    i0 = base + i * 2
    i1 = i0 + 1
    i2 = base + (i + 1) * 2 + 1
    i3 = base + (i + 1) * 2
    front = np.concatenate([np.stack([i0, i1, i2], 1), np.stack([i0, i2, i3], 1)])
    out.add_triangles(front, color)
    if double_sided:
        back = np.concatenate([np.stack([i0, i2, i1], 1), np.stack([i0, i3, i2], 1)])
        out.add_triangles(back, back_color if back_color is not None else color)


def append_ribbon_volume(out: MeshBuilder, points, normal_hint, widths, thickness,
                         colors, target_normals=None, target_weight=0.7,
                         flat_sheet_normal=None):
    """Solid ribbon with a pinched lens cross-section (cartoon.js:550-639)."""
    points = np.asarray(points)
    n = points.shape[0]
    if n < 2:
        return
    if flat_sheet_normal is not None:
        _, normals, binormals = compute_flat_sheet_frames(points, flat_sheet_normal)
    elif target_normals is not None:
        _, normals, binormals = compute_ribbon_frames_with_targets(points, target_normals, target_weight)
    else:
        _, normals, binormals = compute_ribbon_frames(points, normal_hint)

    half_t = thickness * 0.5
    edge_width_scale = colors.get("edge_width_scale", 1.0)
    edge_profile_segments = max(1, int(colors.get("edge_profile_segments", 1)))
    profile_rows = edge_profile_segments * 2 + 1

    widths = np.asarray(widths)
    half_w = widths * 0.5
    edge_half_w = half_w * float(np.clip(edge_width_scale, 0.2, 1.0))

    row_t = np.arange(profile_rows) / (profile_rows - 1)
    theta = (0.5 - row_t) * np.pi
    cos_t = np.cos(theta)
    sin_t = np.sin(theta)
    # side_half [n, rows]; vertical [rows]
    side_half = edge_half_w[:, None] + (half_w - edge_half_w)[:, None] * (cos_t ** 2)[None, :]
    vertical = half_t * sin_t

    nrm = normals[:, None, :]
    bin_ = binormals[:, None, :]
    p = points[:, None, :]
    left = p - bin_ * side_half[..., None] + nrm * vertical[None, :, None]
    right = p + bin_ * side_half[..., None] + nrm * vertical[None, :, None]
    left_n = -bin_ * cos_t[None, :, None] + nrm * sin_t[None, :, None]
    right_n = bin_ * cos_t[None, :, None] + nrm * sin_t[None, :, None]

    def norm_rows(a):
        lens = np.linalg.norm(a, axis=-1, keepdims=True)
        return a / np.where(lens > 1e-12, lens, 1)

    left_n = norm_rows(left_n)
    right_n = norm_rows(right_n)

    top = colors.get("top") or colors.get("side")
    bottom = colors.get("bottom") or colors.get("side")
    side = colors.get("side") or top or bottom

    append_strip(out, left[:, 0], right[:, 0], left_n[:, 0], right_n[:, 0], top, False)
    append_strip(out, left[:, -1], right[:, -1], left_n[:, -1], right_n[:, -1], bottom, True)
    for row in range(profile_rows - 1):
        append_strip(out, left[:, row], left[:, row + 1],
                     left_n[:, row], left_n[:, row + 1], side, True)
        append_strip(out, right[:, row], right[:, row + 1],
                     right_n[:, row], right_n[:, row + 1], side, False)


def append_triangle_prism(out: MeshBuilder, a, b, c, normal, thickness, color):
    """Extruded triangle (the sheet arrowhead; cartoon.js:716-775)."""
    n = _norm(np.asarray(normal, np.float64))
    half = n * (thickness * 0.5)
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    top = [a + half, b + half, c + half]
    bot = [a - half, b - half, c - half]

    verts = top + bot
    norms = [n, n, n, -n, -n, -n]
    base = out.add_vertices(np.stack(verts), np.stack(norms))
    out.add_triangles(np.array([[base, base + 1, base + 2],
                                [base + 5, base + 4, base + 3]]), color)

    edges = [
        (top[0], top[1], bot[1], bot[0]),
        (top[1], top[2], bot[2], bot[1]),
        (top[2], top[0], bot[0], bot[2]),
    ]
    for quad in edges:
        e1 = quad[1] - quad[0]
        e2 = quad[3] - quad[0]
        nn = _norm(np.cross(e1, e2))
        if np.linalg.norm(nn) < 1e-6:
            nn = np.array([0.0, 1.0, 0.0])
        qbase = out.add_vertices(np.stack(quad), np.stack([nn] * 4))
        out.add_triangles(np.array([[qbase, qbase + 1, qbase + 2],
                                    [qbase, qbase + 2, qbase + 3]]), color)


def polyline_length(points) -> float:
    pts = np.asarray(points)
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def trim_polyline_tail(points, vectors, tail_length, min_body_length=0.6):
    """Cut `tail_length` off the end of a polyline, returning the shortened
    body + split-point data (for arrowhead placement; cartoon.js:649-714)."""
    pts = [np.asarray(p, np.float64) for p in points]
    if len(pts) < 2:
        return None
    if vectors is not None and len(vectors) != len(pts):
        raise ValueError("trim_polyline_tail vectors length must match points length.")
    total = polyline_length(pts)
    if total <= 1e-8:
        return None
    clamped = float(np.clip(tail_length, 0, max(0.0, total - min_body_length)))
    if clamped <= 1e-6:
        return None

    remaining = clamped
    for i in range(len(pts) - 1, 0, -1):
        p0, p1 = pts[i - 1], pts[i]
        seg = p1 - p0
        seg_len = np.linalg.norm(seg)
        if seg_len <= 1e-8:
            continue
        if remaining > seg_len:
            remaining -= seg_len
            continue
        t = (seg_len - remaining) / seg_len
        base_point = p0 * (1 - t) + p1 * t
        base_tangent = seg / seg_len
        body_points = pts[:i] + [base_point]
        body_vectors = None
        if vectors is not None:
            body_vectors = [np.asarray(v, np.float64) for v in vectors[:i]]
            v0 = np.asarray(vectors[i - 1] if vectors[i - 1] is not None else vectors[0])
            v1 = np.asarray(vectors[i] if vectors[i] is not None else v0)
            v_split = v0 * (1 - t) + v1 * t
            if np.linalg.norm(v_split) <= 1e-8:
                v_split = v0
            v_split = _norm(v_split)
            if body_vectors and np.dot(v_split, body_vectors[-1]) < 0:
                v_split = -v_split
            body_vectors.append(v_split)
        return {
            "body_points": body_points,
            "body_vectors": body_vectors,
            "base_point": base_point,
            "base_tangent": base_tangent,
            "arrow_length": clamped,
        }
    return None


# --------------------------------------------------------------------------
# segmentation + assembly

def split_by_chain(residues):
    chains: dict[str, list[Residue]] = {}
    for res in residues:
        chains.setdefault(res.chain_id, []).append(res)
    return chains


def segment_by_type(residues, ss, max_gap):
    segments = []
    for chain_residues in split_by_chain(residues).values():
        start = 0
        while start < len(chain_residues):
            kind = ss[chain_residues[start].index]
            end = start + 1
            while end < len(chain_residues):
                prev, curr = chain_residues[end - 1], chain_residues[end]
                gap = np.linalg.norm(curr.atoms["CA"] - prev.atoms["CA"])
                if gap > max_gap or ss[curr.index] != kind:
                    break
                end += 1
            segments.append({"type": kind, "residues": chain_residues[start:end]})
            start = end
    return segments


def _build_loop_tubes(residues, ss, opts, out: MeshBuilder):
    subdivisions = max(1, opts["loop_subdivisions"])
    for chain_residues in split_by_chain(residues).values():
        if len(chain_residues) < 2:
            continue
        start = 0
        while start < len(chain_residues) - 1:
            end = start + 1
            while end < len(chain_residues):
                a, b = chain_residues[end - 1], chain_residues[end]
                if np.linalg.norm(b.atoms["CA"] - a.atoms["CA"]) > opts["max_gap"]:
                    break
                end += 1
            run = chain_residues[start:end]
            if len(run) >= 2:
                points = np.stack([r.atoms["CA"] for r in run])
                smooth = resample_catmull_rom(points, subdivisions)
                labels = [ss[r.index] for r in run]
                total = smooth.shape[0] - 1
                seg_res = np.minimum(len(run) - 2, np.arange(total) // subdivisions)
                mask = [
                    labels[int(k)] == "C" or labels[int(k) + 1] == "C"
                    for k in seg_res
                ]
                append_tube(out, smooth, opts["loop_radius"], opts["loop_sides"],
                            opts["loop_color"], segment_mask=mask)
            start = max(end, start + 1)


def _pick_helix_normal(segment, residues, hbonds):
    accum = np.zeros(3)
    ref = None
    count = 0
    for res in segment["residues"]:
        i = res.index
        partners = hbonds[i]
        if not partners:
            continue
        target = None
        for offset in (4, 3, 5):
            if i + offset < len(residues) and (i + offset) in partners:
                target = i + offset
                break
        if target is None:
            for j in partners:
                if residues[j].chain_id == res.chain_id:
                    target = j
                    break
        if target is None:
            continue
        hdir = _norm(residues[target].atoms["N"] - res.atoms["O"])
        t = residue_tangent(i, residues)
        n = np.cross(t, hdir)
        if np.linalg.norm(n) < 1e-6:
            continue
        n = _norm(n)
        if ref is not None and np.dot(n, ref) < 0:
            n = -n
        if ref is None:
            ref = n
        accum += n
        count += 1
    if count > 0:
        return _norm(accum)

    avg = np.zeros(3)
    ref_plane = None
    for res in segment["residues"]:
        if res.plane_normal is None:
            continue
        n = res.plane_normal
        if ref_plane is not None and np.dot(n, ref_plane) < 0:
            n = -n
        if ref_plane is None:
            ref_plane = n
        avg += n
    avg_n = _norm(avg)
    return avg_n if np.linalg.norm(avg_n) > 1e-6 else np.array([0.0, 1.0, 0.0])


def resample_segment_normals(segment_residues, residue_normals, sample_count):
    count = len(segment_residues)
    if count == 0 or sample_count <= 0:
        return []
    base = []
    for res in segment_residues:
        n = residue_normals[res.index]
        if n is None:
            n = res.plane_normal if res.plane_normal is not None else np.array([0.0, 1.0, 0.0])
        base.append(_norm(np.asarray(n, np.float64)))
    for i in range(1, len(base)):
        if np.dot(base[i], base[i - 1]) < 0:
            base[i] = -base[i]
    if sample_count == 1:
        return [base[0]]
    if sample_count == len(base):
        return base[:]
    out = []
    for s in range(sample_count):
        u = (s / (sample_count - 1)) * (len(base) - 1)
        i0 = int(u)
        i1 = min(len(base) - 1, i0 + 1)
        t = u - i0
        n0, n1 = base[i0], base[i1]
        if np.dot(n0, n1) < 0:
            n1 = -n1
        n = n0 * (1 - t) + n1 * t
        n = n0 if np.linalg.norm(n) < 1e-6 else _norm(n)
        if out and np.dot(n, out[-1]) < 0:
            n = -n
        out.append(n)
    return out


def _prepare(mol: MolData, opts):
    residues = build_residues(mol)
    if not residues:
        raise ValueError("Cartoon mode requires PDB residue data with backbone atoms.")
    incomplete = sum(1 for r in residues if not r.complete)
    if incomplete:
        raise ValueError(
            f"Cartoon mode requires complete backbone atoms (N/CA/C/O). "
            f"Missing in {incomplete} residues."
        )
    hbonds = compute_hbonds(residues, opts["hbond_distance"], opts["hbond_energy_cutoff"])
    ss = ["C"] * len(residues)
    has_pdb_secondary = bool(mol.helices) or bool(mol.sheets)
    if has_pdb_secondary:
        apply_secondary_ranges(residues, ss, mol.helices, "H")
        apply_secondary_ranges(residues, ss, mol.sheets, "E")
    dssp = assign_secondary_structure(residues, hbonds)
    for i in range(len(ss)):
        if ss[i] == "C" and dssp[i] != "C":
            ss[i] = dssp[i]
    adjusted = ss if has_pdb_secondary else adjust_short_segments(residues, ss)
    return residues, hbonds, adjusted


def build_backbone_cartoon(mol: MolData, debug_sheet_orientation=False,
                           debug_log=None, **options) -> TriangleMesh:
    """Full cartoon mesh (buildBackboneCartoon, cartoon.js:1670-1843)."""
    opts = {**DEFAULT_OPTIONS, **options}
    residues, hbonds, adjusted = _prepare(mol, opts)
    if len(residues) < 4:
        raise ValueError("Cartoon mode requires at least four residues with backbone atoms.")

    sheet_normals = compute_sheet_normals(residues, adjusted, hbonds, opts)
    segments = segment_by_type(residues, adjusted, opts["max_gap"])
    diagnostics = compute_sheet_strand_diagnostics(
        residues, adjusted, hbonds, sheet_normals, segments, opts
    )
    if debug_sheet_orientation:
        log = debug_log or print
        log(f"[cartoon] Sheet strand diagnostics ({len(diagnostics)} strands)")
        for d in diagnostics:
            angle = (f"angle(deg) mean={d['angle_mean']:.1f} min={d['angle_min']:.1f} "
                     f"max={d['angle_max']:.1f}" if d["angle_count"] else "angle(deg) n/a")
            log(f"[cartoon] Strand {d['strand_index'] + 1} "
                f"{d['chain_id']}:{d['start_seq']}-{d['end_seq']} "
                f"residues={d['residue_count']} hbonds total={d['total_count']} "
                f"out={d['outgoing_count']} in={d['incoming_count']} "
                f"partners={d['partner_residue_count']} source=distance {angle}")

    out = MeshBuilder()

    for segment in segments:
        points = np.stack([r.atoms["CA"] for r in segment["residues"]])
        if points.shape[0] < 2:
            continue

        if segment["type"] == "H":
            smooth = resample_catmull_rom(points, opts["helix_subdivisions"])
            end_width = max(0.01, opts["loop_radius"] * 2.0)
            widths = make_tapered_widths(smooth.shape[0], opts["helix_width"], end_width, 0.2)
            avg_normal = _pick_helix_normal(segment, residues, hbonds)
            axis_dir = _norm(smooth[-1] - smooth[0])
            if np.linalg.norm(axis_dir) < 1e-6:
                axis_dir = np.array([1.0, 0.0, 0.0])
            axis_origin = smooth.mean(axis=0)
            target_normals = []
            prev_radial = None
            for p in smooth:
                rel = p - axis_origin
                radial = rel - axis_dir * float(np.dot(rel, axis_dir))
                radial = avg_normal if np.linalg.norm(radial) < 1e-6 else _norm(radial)
                if prev_radial is not None and np.dot(radial, prev_radial) < 0:
                    radial = -radial
                prev_radial = radial
                target_normals.append(radial)
            append_ribbon_volume(
                out, smooth, avg_normal, widths, opts["helix_thickness"],
                dict(top=opts["helix_front_color"], bottom=opts["helix_back_color"],
                     side=opts["helix_front_color"],
                     edge_width_scale=opts["helix_edge_width_scale"],
                     edge_profile_segments=opts["helix_cross_section_segments"]),
                target_normals=target_normals, target_weight=0.95,
            )
        elif segment["type"] == "E":
            sheet_points = smooth_points_fixed_endpoints(points, 2, 0.6)
            if opts["sheet_subdivisions"] > 1:
                sheet_points = resample_catmull_rom(sheet_points, opts["sheet_subdivisions"])
            target_normals = resample_segment_normals(
                segment["residues"], sheet_normals, sheet_points.shape[0]
            )
            sheet_normal = target_normals[0] if target_normals else np.array([0.0, 1.0, 0.0])
            arrow_tail = trim_polyline_tail(
                list(sheet_points), target_normals, opts["arrow_length"]
            )
            body_points = (np.stack(arrow_tail["body_points"])
                           if arrow_tail else sheet_points)
            body_normals = (arrow_tail["body_vectors"]
                            if arrow_tail else target_normals)
            body_widths = np.full(body_points.shape[0], opts["sheet_width"])

            append_ribbon_volume(
                out, body_points, sheet_normal, body_widths, opts["sheet_thickness"],
                dict(top=opts["sheet_color"], bottom=opts["sheet_color"],
                     side=opts["sheet_color"]),
                target_normals=body_normals, target_weight=0.95,
            )

            if body_points.shape[0] >= 2:
                base_center = (arrow_tail["base_point"] if arrow_tail
                               else body_points[-1])
                last_t = (arrow_tail["base_tangent"] if arrow_tail
                          else compute_tangents(body_points)[-1])
                arrow_length = arrow_tail["arrow_length"] if arrow_tail else opts["arrow_length"]
                end_normal = (body_normals[-1] if body_normals and body_normals[-1] is not None
                              else sheet_normal)
                binormal = np.cross(last_t, end_normal)
                binormal = (_pick_perpendicular(last_t)
                            if np.linalg.norm(binormal) < 1e-6 else _norm(binormal))
                tip = base_center + last_t * arrow_length
                base_half = opts["sheet_width"] * opts["arrow_base_scale"] * 0.5
                append_triangle_prism(
                    out,
                    base_center - binormal * base_half,
                    base_center + binormal * base_half,
                    tip, end_normal, opts["sheet_thickness"], opts["sheet_color"],
                )

    _build_loop_tubes(residues, adjusted, opts, out)
    mesh = out.build()
    if debug_sheet_orientation:
        mesh.sheet_diagnostics = diagnostics  # type: ignore[attr-defined]
    return mesh


def build_sheet_hbond_cylinders(mol: MolData, hbond_radius=0.06,
                                hbond_color=(0.2, 0.7, 1.0), normal_radius=0.05,
                                normal_length=1.5, normal_color=(0.95, 0.75, 0.2),
                                **options):
    """Debug overlay: inter-strand H-bond contacts + sheet normals as
    cylinders (cartoon.js:1845-1926). Returns (p1 f32[M,3], p2 f32[M,3],
    radii f32[M], colors f32[M,3])."""
    opts = {**DEFAULT_OPTIONS, **options}
    residues, hbonds, adjusted = _prepare(mol, opts)
    sheet_normals = compute_sheet_normals(residues, adjusted, hbonds, opts)
    directed, _ = collect_sheet_distance_contacts(residues, adjusted, opts["hbond_distance"])

    p1, p2, radii, colors = [], [], [], []
    for contact in directed:
        p1.append(residues[contact["from"]].atoms["O"])
        p2.append(residues[contact["to"]].atoms["N"])
        radii.append(hbond_radius)
        colors.append(hbond_color)
    for i, res in enumerate(residues):
        if adjusted[i] != "E" or sheet_normals[i] is None:
            continue
        ca = res.atoms["CA"]
        p1.append(ca)
        p2.append(ca + sheet_normals[i] * normal_length)
        radii.append(normal_radius)
        colors.append(normal_color)

    if not p1:
        z3 = np.zeros((0, 3), np.float32)
        return z3, z3.copy(), np.zeros(0, np.float32), z3.copy()
    return (np.asarray(p1, np.float32), np.asarray(p2, np.float32),
            np.asarray(radii, np.float32), np.asarray(colors, np.float32))
