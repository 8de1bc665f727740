"""A protein of a deposited entry's composition, drawn from the seed, as
upstream's viewer loads a PDB entry (index.html:541-551, `pdb:4HHB`): the
molecule scene kind.

The structure: the configuration's chains, each of its residue composition
in an order drawn from the seed, every standard residue with its heavy
atoms at ideal bond lengths (backbone N-CA 1.458, CA-C 1.525, C-N 1.329,
C=O 1.231, trans peptides; side chains by their internal coordinates,
rings as rigid planar polygons), a terminal OXT; and one HEM group a
subunit (43 heavy atoms: a planar porphyrin, Fe at its centre 2.0 A from
its four nitrogens, two methyl-vinyl and two methyl-propionate pyrroles,
the propionates out of the plane) as HETATM with CONECT records, in both
directions as the RCSB writes them.

A chain is a globin-like bundle of ideal alpha helices (phi -63, psi
-42) of about helix_length residues, in two rows of a hexagonal lattice
of rod_spacing (a globin's two layers of helices), neighbours
antiparallel, the chain broken between helices (no loops are built, so
no peptide bond joins two helices); its HEM caps one end of the first
row. The HEM goes first, then each helix's backbone and CB, turned and
shifted at random where they fit and where every side chain near them
keeps some place among the backbones; then the side chains are packed,
the largest first, each by rotamer draws (chi wells 60, 180, -60 with
noise, then any angle), and one that finds no place lifts the fewest
side chains in its way, which are packed again. A proline takes the
first place of a helix, where its ring meets no turn before it. Each
subunit is grown alone; the four are then docked at the corners of a
tetrahedron, subunit k turned by the half-turn that takes corner 0 to
corner k (haemoglobin's D2 symmetry), its half-sides shrunk to contact
and chosen so that the box comes nearest the entry's `extent`.
Fitting means: no two atoms that are not bonded lie within the
bond-inference cutoff (covalent radii + 0.45 A, the port's rule) plus
MARGIN, and atoms more than three bonds apart lie at least CONTACT_FLOOR
apart (the closest contacts of a deposited entry, hydrogen bonds). So
bond inference over the atoms finds exactly the covalent bonds, and the
structure packs about as densely as a folded protein.

The scene: models/molecular.py's parse of the text (CONECT present, so
the parse takes the CONECT bonds and infers none: the HEM groups' bonds,
as upstream's parser does with a deposited file) through the program's
load_molecule_scene with the configuration's style, SES and surface atom
mode. The reference (reference/molecule.py, reference/transport.py)
works the same scene out again from the atoms and the configuration.

The scene kind's four functions: benchmark/README.md, "Adding a
configuration of another scene kind".
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from benchmark.reference import molecule as MOL
from benchmark.reference import transport as TR

ROTAMER_TRIES = 48
REPACK_ROUNDS = 1
PACK_TRIES = 2
FEASIBLE_REACH = 12.0
SUBUNIT_TRIES = 16
DOCK_TOL = 0.1
ROD_TRIES = 6
ROD_SHIFT = 0.5
HELIX_PHI_PSI = (-63.0, -42.0)
MARGIN = 0.05
CONTACT_FLOOR = 2.6
CELL = 3.0
GRID = 96
PER_CELL = 16

ROTAMERS = (60.0, 180.0, -60.0)

# Side chains by internal coordinates: (name, element, (a, b, c), bond,
# angle, dihedral), the dihedral either a number or ("chi", k, offset).
# Atoms a, b, c are placed before; CB is placed for every residue but GLY.
SIDE = {
    "ALA": (),
    "GLY": (),
    "SER": (("OG", "O", ("N", "CA", "CB"), 1.417, 110.8, ("chi", 0, 0.0)),),
    "CYS": (("SG", "S", ("N", "CA", "CB"), 1.808, 113.8, ("chi", 0, 0.0)),),
    "VAL": (("CG1", "C", ("N", "CA", "CB"), 1.524, 110.7, ("chi", 0, 0.0)),
            ("CG2", "C", ("N", "CA", "CB"), 1.524, 110.4, ("chi", 0, 120.0))),
    "THR": (("OG1", "O", ("N", "CA", "CB"), 1.433, 109.2, ("chi", 0, 0.0)),
            ("CG2", "C", ("N", "CA", "CB"), 1.521, 110.5, ("chi", 0, -120.0))),
    "ILE": (("CG1", "C", ("N", "CA", "CB"), 1.530, 110.4, ("chi", 0, 0.0)),
            ("CG2", "C", ("N", "CA", "CB"), 1.521, 110.5, ("chi", 0, -120.0)),
            ("CD1", "C", ("CA", "CB", "CG1"), 1.513, 113.8, ("chi", 1, 0.0))),
    "LEU": (("CG", "C", ("N", "CA", "CB"), 1.530, 116.3, ("chi", 0, 0.0)),
            ("CD1", "C", ("CA", "CB", "CG"), 1.521, 110.7, ("chi", 1, 0.0)),
            ("CD2", "C", ("CA", "CB", "CG"), 1.521, 110.7, ("chi", 1, 120.0))),
    "ASP": (("CG", "C", ("N", "CA", "CB"), 1.516, 112.6, ("chi", 0, 0.0)),
            ("OD1", "O", ("CA", "CB", "CG"), 1.249, 118.4, ("chi", 1, 0.0)),
            ("OD2", "O", ("CA", "CB", "CG"), 1.249, 118.4, ("chi", 1, 180.0))),
    "ASN": (("CG", "C", ("N", "CA", "CB"), 1.516, 112.6, ("chi", 0, 0.0)),
            ("OD1", "O", ("CA", "CB", "CG"), 1.231, 120.8, ("chi", 1, 0.0)),
            ("ND2", "N", ("CA", "CB", "CG"), 1.328, 116.4, ("chi", 1, 180.0))),
    "GLU": (("CG", "C", ("N", "CA", "CB"), 1.520, 114.1, ("chi", 0, 0.0)),
            ("CD", "C", ("CA", "CB", "CG"), 1.516, 112.6, ("chi", 1, 0.0)),
            ("OE1", "O", ("CB", "CG", "CD"), 1.249, 118.4, ("chi", 2, 0.0)),
            ("OE2", "O", ("CB", "CG", "CD"), 1.249, 118.4, ("chi", 2, 180.0))),
    "GLN": (("CG", "C", ("N", "CA", "CB"), 1.520, 114.1, ("chi", 0, 0.0)),
            ("CD", "C", ("CA", "CB", "CG"), 1.516, 112.6, ("chi", 1, 0.0)),
            ("OE1", "O", ("CB", "CG", "CD"), 1.231, 120.8, ("chi", 2, 0.0)),
            ("NE2", "N", ("CB", "CG", "CD"), 1.328, 116.4, ("chi", 2, 180.0))),
    "LYS": (("CG", "C", ("N", "CA", "CB"), 1.520, 114.1, ("chi", 0, 0.0)),
            ("CD", "C", ("CA", "CB", "CG"), 1.520, 111.3, ("chi", 1, 0.0)),
            ("CE", "C", ("CB", "CG", "CD"), 1.520, 111.3, ("chi", 2, 0.0)),
            ("NZ", "N", ("CG", "CD", "CE"), 1.489, 111.9, ("chi", 3, 0.0))),
    "ARG": (("CG", "C", ("N", "CA", "CB"), 1.520, 114.1, ("chi", 0, 0.0)),
            ("CD", "C", ("CA", "CB", "CG"), 1.520, 111.3, ("chi", 1, 0.0)),
            ("NE", "N", ("CB", "CG", "CD"), 1.460, 112.0, ("chi", 2, 0.0)),
            ("CZ", "C", ("CG", "CD", "NE"), 1.329, 124.2, ("chi", 3, 0.0)),
            ("NH1", "N", ("CD", "NE", "CZ"), 1.326, 120.0, 0.0),
            ("NH2", "N", ("CD", "NE", "CZ"), 1.326, 120.0, 180.0)),
    "MET": (("CG", "C", ("N", "CA", "CB"), 1.520, 114.1, ("chi", 0, 0.0)),
            ("SD", "S", ("CA", "CB", "CG"), 1.807, 112.7, ("chi", 1, 0.0)),
            ("CE", "C", ("CB", "CG", "SD"), 1.791, 100.9, ("chi", 2, 0.0))),
    # The ring's torsions close CD-N at 1.473 A.
    "PRO": (("CG", "C", ("N", "CA", "CB"), 1.495, 104.5, 0.0),
            ("CD", "C", ("CA", "CB", "CG"), 1.507, 106.5, 13.0)),
    "PHE": (("CG", "C", ("N", "CA", "CB"), 1.502, 113.8, ("chi", 0, 0.0)),),
    "TYR": (("CG", "C", ("N", "CA", "CB"), 1.512, 113.9, ("chi", 0, 0.0)),),
    "TRP": (("CG", "C", ("N", "CA", "CB"), 1.498, 113.6, ("chi", 0, 0.0)),),
    "HIS": (("CG", "C", ("N", "CA", "CB"), 1.497, 113.8, ("chi", 0, 0.0)),),
}


def _polygon(n, side):
    """The corners of a regular n-gon of `side`, corner 0 at the origin,
    its centre on +x, in the xy plane."""
    radius = side / (2.0 * math.sin(math.pi / n))
    ang = math.pi + 2.0 * math.pi * np.arange(n) / n
    pts = np.stack([radius + radius * np.cos(ang), radius * np.sin(ang),
                    np.zeros(n)], axis=1)
    return pts


def _rings():
    """Rigid planar rings, in a frame where CG is at the origin, the CB-CG
    bond lies along +x (the ring beyond CG) and the ring in the xy plane:
    name -> (names, elements, coordinates)."""
    hexagon = _polygon(6, 1.39)             # CG, CD1, CE1, CZ, CE2, CD2
    phe = (["CD1", "CE1", "CZ", "CE2", "CD2"], ["C"] * 5, hexagon[1:])
    oh = hexagon[3] + 1.36 * hexagon[3] / np.linalg.norm(hexagon[3])
    tyr = (phe[0] + ["OH"], phe[1] + ["O"], np.vstack([hexagon[1:], oh]))
    pentagon = _polygon(5, 1.37)            # CG, ND1, CE1, NE2, CD2
    his = (["ND1", "CE1", "NE2", "CD2"], ["N", "C", "N", "C"], pentagon[1:])
    # Indole: the pentagon CG, CD1, NE1, CE2, CD2, and the hexagon on its
    # CD2-CE2 edge, both with sides 1.39.
    pent = _polygon(5, 1.39)
    cd2, ce2 = pent[4], pent[3]
    mid = 0.5 * (cd2 + ce2)
    outward = mid - pent.mean(axis=0)
    outward /= np.linalg.norm(outward)
    centre = mid + outward * (1.39 * math.sqrt(3.0) / 2.0)
    ring = []
    for k in range(6):
        rel = cd2 - centre
        a = 2.0 * math.pi * k / 6.0
        rot = np.array([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                        [0.0, 0.0, 1.0]])
        ring.append(centre + rot @ rel)
    # ring[0] = CD2; going one way around reaches CE2 at ring[1] or ring[5].
    if np.linalg.norm(ring[1] - ce2) > 1e-6:
        ring = [ring[0]] + ring[1:][::-1]
    trp_pts = np.vstack([pent[1], pent[2], ce2, cd2, ring[5], ring[4], ring[3], ring[2]])
    trp = (["CD1", "NE1", "CE2", "CD2", "CE3", "CZ3", "CH2", "CZ2"],
           ["C", "N", "C", "C", "C", "C", "C", "C"], trp_pts)
    return {"PHE": phe, "TYR": tyr, "HIS": his, "TRP": trp}


RINGS = _rings()

# Bonds within a residue, by atom name (the peptide bond C(i)-N(i+1) and
# OXT apart).
_RING_BONDS = {
    "PHE": [("CG", "CD1"), ("CD1", "CE1"), ("CE1", "CZ"), ("CZ", "CE2"), ("CE2", "CD2"),
            ("CD2", "CG")],
    "HIS": [("CG", "ND1"), ("ND1", "CE1"), ("CE1", "NE2"), ("NE2", "CD2"), ("CD2", "CG")],
    "TRP": [("CG", "CD1"), ("CD1", "NE1"), ("NE1", "CE2"), ("CE2", "CD2"), ("CD2", "CG"),
            ("CD2", "CE3"), ("CE3", "CZ3"), ("CZ3", "CH2"), ("CH2", "CZ2"), ("CZ2", "CE2")],
}
_RING_BONDS["TYR"] = _RING_BONDS["PHE"] + [("CZ", "OH")]


def residue_bonds(res: str) -> list:
    bonds = [("N", "CA"), ("CA", "C"), ("C", "O")]
    if res != "GLY":
        bonds.append(("CA", "CB"))
    for name, _, parents, *_ in SIDE[res]:
        bonds.append((parents[2], name))
    bonds += _RING_BONDS.get(res, [])
    if res == "PRO":
        bonds.append(("CD", "N"))
    return bonds


def _nerf(a, b, c, bond, angle_deg, dihedral_deg):
    """D with |CD| = bond, angle BCD = angle, dihedral ABCD = dihedral
    (scalar arithmetic: this is the generator's inner loop)."""
    ang = math.radians(angle_deg)
    dih = math.radians(dihedral_deg)
    ax, ay, az = (float(v) for v in a)
    bx, by, bz = (float(v) for v in b)
    cx, cy, cz = (float(v) for v in c)
    ux, uy, uz = cx - bx, cy - by, cz - bz
    inv = 1.0 / math.sqrt(ux * ux + uy * uy + uz * uz)
    ux, uy, uz = ux * inv, uy * inv, uz * inv
    vx, vy, vz = bx - ax, by - ay, bz - az
    nx, ny, nz = vy * uz - vz * uy, vz * ux - vx * uz, vx * uy - vy * ux
    inv = 1.0 / max(math.sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    mx, my, mz = ny * uz - nz * uy, nz * ux - nx * uz, nx * uy - ny * ux
    k0 = -bond * math.cos(ang)
    k1 = bond * math.sin(ang) * math.cos(dih)
    k2 = bond * math.sin(ang) * math.sin(dih)
    return np.array([cx + k0 * ux + k1 * mx + k2 * nx, cy + k0 * uy + k1 * my + k2 * ny,
                     cz + k0 * uz + k1 * mz + k2 * nz])


def _place_ring(res, atoms, chi2):
    """The rigid ring of `res` at CG, turned by chi2 about CB-CG."""
    names, elements, local = RINGS[res]
    cb, cg, ca = atoms["CB"], atoms["CG"], atoms["CA"]
    x = cg - cb
    x /= np.linalg.norm(x)
    ref = ca - cb
    y = ref - x * (ref @ x)
    y /= np.linalg.norm(y)
    z = np.cross(x, y)
    c, s = math.cos(math.radians(chi2)), math.sin(math.radians(chi2))
    y, z = c * y + s * z, -s * y + c * z
    for name, p in zip(names, local):
        atoms[name] = cg + p[0] * x + p[1] * y + p[2] * z
    return list(zip(names, elements))


def _side_chain(res, atoms, chis):
    """Side-chain atoms of `res` placed into `atoms`; returns (name,
    element) in order."""
    out = []
    if res == "GLY":
        return out
    atoms["CB"] = _nerf(atoms["C"], atoms["N"], atoms["CA"], 1.530, 110.5, -122.6)
    out.append(("CB", "C"))
    for name, element, (a, b, c), bond, angle, dih in SIDE[res]:
        if isinstance(dih, tuple):
            dih = chis[dih[1]] + dih[2]
        atoms[name] = _nerf(atoms[a], atoms[b], atoms[c], bond, angle, dih)
        out.append((name, element))
    if res in RINGS:
        out += _place_ring(res, atoms, chis[1])
    return out


def hem_template():
    """(names, elements, coordinates f64[43, 3] with Fe at the origin and
    the porphyrin in the xy plane, bonds by name)."""
    names, elements, pts, bonds = ["FE"], ["Fe"], [np.zeros(3)], []
    rot90 = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])  # clockwise
    # One pyrrole with N on +y: N, C1 (left alpha), C2, C3 (betas), C4
    # (right alpha); the meso carbon after it between C4 and the next
    # pyrrole's C1.
    pyrrole = {"N": (0.0, 2.0), "C1": (-1.09, 2.82), "C2": (-0.68, 4.22),
               "C3": (0.68, 4.22), "C4": (1.09, 2.82)}
    meso = np.array([2.44, 2.44, 0.0])
    # Substituents on C2 and C3 of rings A-D: (kind on C2, kind on C3).
    subs = {"A": ("propionate", "methyl"), "B": ("methyl", "vinyl"),
            "C": ("methyl", "vinyl"), "D": ("methyl", "propionate")}
    meso_names = ["CHB", "CHC", "CHD", "CHA"]
    rot = np.eye(3)
    index = {"FE": 0}

    def add(name, element, p):
        index[name] = len(names)
        names.append(name)
        elements.append(element)
        pts.append(np.asarray(p, np.float64))

    for k, ring in enumerate("ABCD"):
        for atom, (x, y) in pyrrole.items():
            name = f"N{ring}" if atom == "N" else f"{atom}{ring}"
            add(name, "N" if atom == "N" else "C", rot @ np.array([x, y, 0.0]))
        bonds += [("FE", f"N{ring}"), (f"N{ring}", f"C1{ring}"), (f"C1{ring}", f"C2{ring}"),
                  (f"C2{ring}", f"C3{ring}"), (f"C3{ring}", f"C4{ring}"),
                  (f"C4{ring}", f"N{ring}")]
        add(meso_names[k], "C", rot @ meso)
        bonds.append((f"C4{ring}", meso_names[k]))
        for slot, kind in zip(("C2", "C3"), subs[ring]):
            at = pts[index[f"{slot}{ring}"]]
            pa = pts[index[f"{'C1' if slot == 'C2' else 'C4'}{ring}"]]
            pb = pts[index[f"{'C3' if slot == 'C2' else 'C2'}{ring}"]]
            u = -((pa - at) / np.linalg.norm(pa - at) + (pb - at) / np.linalg.norm(pb - at))
            u /= np.linalg.norm(u)
            # Turn the chain away from the pyrrole's other beta carbon.
            side = np.cross(np.array([0.0, 0.0, 1.0]), u)
            if side @ (pb - at) > 0:
                side = -side

            def turn(v, deg):
                r = math.radians(deg)
                return math.cos(r) * v + math.sin(r) * side

            if kind == "methyl":
                add(f"CM{ring}", "C", at + 1.50 * u)
                bonds.append((f"{slot}{ring}", f"CM{ring}"))
            elif kind == "vinyl":
                c1 = at + 1.47 * u
                add(f"CA{ring}", "C", c1)
                add(f"CB{ring}", "C", c1 + 1.34 * turn(u, 60.0))
                bonds += [(f"{slot}{ring}", f"CA{ring}"), (f"CA{ring}", f"CB{ring}")]
            else:
                # The propionate leaves the plane, ring A's to one face and
                # ring D's to the other: a zigzag in the plane of u and
                # the normal.
                z = np.array([0.0, 0.0, 1.0 if ring == "A" else -1.0])
                c1 = at + 1.51 * u
                c2 = c1 + 1.53 * (math.cos(math.radians(70.5)) * u
                                  + math.sin(math.radians(70.5)) * z)
                c3 = c2 + 1.52 * u
                add(f"CA{ring}", "C", c1)
                add(f"CB{ring}", "C", c2)
                add(f"CG{ring}", "C", c3)
                add(f"O1{ring}", "O", c3 + 1.25 * (0.5 * u + math.sqrt(0.75) * z))
                add(f"O2{ring}", "O", c3 + 1.25 * (0.5 * u - math.sqrt(0.75) * z))
                bonds += [(f"{slot}{ring}", f"CA{ring}"), (f"CA{ring}", f"CB{ring}"),
                          (f"CB{ring}", f"CG{ring}"), (f"CG{ring}", f"O1{ring}"),
                          (f"CG{ring}", f"O2{ring}")]
        rot = rot90 @ rot
    # Ring k's meso carbon joins the next ring's C1.
    for k, ring in enumerate("ABCD"):
        bonds.append((meso_names[k], f"C1{'ABCD'[(k + 1) % 4]}"))
    return names, elements, np.array(pts), bonds




class _NoRoom(RuntimeError):
    """A part of the structure found no place that fits."""


def _graph_distances(names, bonds, limit=4):
    """[n, n] bond counts between `names` over `bonds` (by name), capped at
    `limit`."""
    index = {n: i for i, n in enumerate(names)}
    adj = [[] for _ in names]
    for a, b in bonds:
        if a in index and b in index:
            adj[index[a]].append(index[b])
            adj[index[b]].append(index[a])
    out = np.full((len(names), len(names)), limit, np.int64)
    for s in range(len(names)):
        out[s, s] = 0
        frontier = [s]
        for d in range(1, limit):
            nxt = [b for a in frontier for b in adj[a] if out[s, b] > d]
            for b in nxt:
                out[s, b] = d
            frontier = nxt
    return out


class _Structure:
    """The atoms placed so far: positions, covalent radii and bonds, listed
    by CELL-sized cells of a grid of GRID cells a side centred on the
    origin (at most PER_CELL atoms a cell)."""

    def __init__(self):
        self.pos = np.zeros((4096, 3))
        self.cov = np.zeros(4096)
        self.cell = np.zeros((4096, 3), np.int64)
        self.n = 0
        self.elem = []
        self.adj = []
        self.table = np.full((GRID, GRID, GRID, PER_CELL), -1, np.int64)
        self.count = np.zeros((GRID, GRID, GRID), np.int64)

    @staticmethod
    def _cells(p):
        k = np.floor(np.asarray(p) * (1.0 / CELL)).astype(np.int64) + GRID // 2
        if k.min() < 1 or k.max() > GRID - 2:
            raise RuntimeError("the structure left the generator's grid")
        return k

    def add(self, p, e) -> int:
        if self.n == self.pos.shape[0]:
            self.pos = np.concatenate([self.pos, np.zeros_like(self.pos)])
            self.cov = np.concatenate([self.cov, np.zeros_like(self.cov)])
            self.cell = np.concatenate([self.cell, np.zeros_like(self.cell)])
        i = self.n
        k = self._cells(p)
        x, y, z = k
        if self.count[x, y, z] == PER_CELL:
            raise RuntimeError("a generator cell is full")
        self.table[x, y, z, self.count[x, y, z]] = i
        self.count[x, y, z] += 1
        self.pos[i] = p
        self.cov[i] = MOL.covalent_radius(e)
        self.cell[i] = k
        self.elem.append(e)
        self.adj.append([])
        self.n += 1
        return i

    def bond(self, i, j) -> None:
        self.adj[i].append(j)
        self.adj[j].append(i)

    def truncate(self, n) -> None:
        """Remove the atoms from n on (the newest, so each is its cell's
        last)."""
        for i in range(self.n - 1, n - 1, -1):
            x, y, z = self.cell[i]
            self.count[x, y, z] -= 1
            self.table[x, y, z, self.count[x, y, z]] = -1
        del self.elem[n:], self.adj[n:]
        for a in self.adj:
            a[:] = [j for j in a if j < n]
        self.n = n

    def lift(self, i) -> None:
        """Take atom i out of the grid; it keeps its id and bonds."""
        x, y, z = self.cell[i]
        c = self.count[x, y, z]
        row = self.table[x, y, z]
        k = int(np.flatnonzero(row[:c] == i)[0])
        row[k], row[c - 1] = row[c - 1], -1
        self.count[x, y, z] = c - 1

    def put(self, i, p) -> None:
        """Put a lifted atom i back into the grid at p."""
        k = self._cells(p)
        x, y, z = k
        if self.count[x, y, z] == PER_CELL:
            raise RuntimeError("a generator cell is full")
        self.table[x, y, z, self.count[x, y, z]] = i
        self.count[x, y, z] += 1
        self.pos[i] = p
        self.cell[i] = k

    def near(self, pts) -> np.ndarray:
        """The atoms in the cells around points pts [m, 3]."""
        k = self._cells(pts).reshape(-1, 3)
        lo = k.min(axis=0) - 1
        hi = k.max(axis=0) + 2
        ids = self.table[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].reshape(-1)
        return ids[ids >= 0]

    def within(self, start, depth) -> dict:
        """{atom: bonds from `start`} up to `depth` bonds."""
        seen = {start: 0}
        frontier = [start]
        for d in range(1, depth + 1):
            frontier = [b for a in frontier for b in self.adj[a] if b not in seen]
            for b in frontier:
                seen[b] = d
        return seen


def _clashes(st, pts, cov, local_d, ext_d):
    """The atoms of the structure that new atoms (positions pts [m, 3],
    covalent radii cov [m]) come too close to, as ids; None where the new
    atoms clash among themselves. Among themselves bond counts are
    local_d [m, m], against the structure ext_d (atom ids, [m, ids] bond
    counts; atoms not listed are more than three bonds away). A bonded
    pair is not tested; a pair two or three bonds apart stays outside the
    inference cutoff plus MARGIN; any other pair also keeps CONTACT_FLOOR."""
    cut = cov[:, None] + cov[None, :] + MOL.BOND_TOLERANCE + MARGIN
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    need = np.where(local_d <= 3, cut, np.maximum(CONTACT_FLOOR, cut))
    if ((d < need) & (local_d >= 2)).any():
        return None
    nb = st.near(pts)
    if nb.size == 0:
        return nb
    d = np.linalg.norm(pts[:, None] - st.pos[nb][None], axis=-1)
    cut = cov[:, None] + st.cov[nb][None] + MOL.BOND_TOLERANCE + MARGIN
    need = np.maximum(CONTACT_FLOOR, cut)
    close = d < need
    if not close.any() or not ext_d:
        return nb[close.any(axis=0)]
    # Only pairs within three bonds may come closer than the floor.
    ext_ids, ext_counts = ext_d
    pos_in = np.searchsorted(ext_ids, nb)
    hit = (pos_in < ext_ids.size) & (ext_ids[np.minimum(pos_in, ext_ids.size - 1)] == nb)
    bonds = np.full(d.shape, 4, np.int64)
    bonds[:, hit] = ext_counts[:, pos_in[hit]]
    need = np.where(bonds <= 3, cut, need)
    return nb[((d < need) & (bonds >= 2)).any(axis=0)]


def _fits(st, pts, cov, local_d, ext_d) -> bool:
    """Whether new atoms clash with nothing (_clashes)."""
    hits = _clashes(st, pts, cov, local_d, ext_d)
    return hits is not None and hits.size == 0


def _quat_matrix(q):
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _side_distances(res):
    """(names and elements of the side chain beyond CB, [k, k] bond counts
    among them, and {anchor: [k] bond counts from it} for the anchors N,
    CA, C and CB, which stand with the backbone) of a residue type,
    capped at 4, cached."""
    if res not in _SIDE_CACHE:
        atoms = {"N": np.zeros(3), "CA": np.array([1.458, 0.0, 0.0]),
                 "C": np.array([2.0, 1.4, 0.0])}
        order = [(n, e) for n, e in _side_chain(res, atoms, [180.0] * 4) if n != "CB"]
        names = [n for n, _ in order]
        anchors = ("N", "CA", "C") + (("CB",) if res != "GLY" else ())
        d = _graph_distances(names + list(anchors), residue_bonds(res))
        k = len(names)
        _SIDE_CACHE[res] = (names, [e for _, e in order], d[:k, :k],
                            {a: d[:k, k + j] for j, a in enumerate(anchors)})
    return _SIDE_CACHE[res]


_SIDE_CACHE = {}


def _ideal_helix(n):
    """Backbones {N, CA, C, O} of an ideal alpha helix of n residues
    (phi -63, psi -42, trans peptides), its axis along +z through the
    origin, its middle at z = 0."""
    phi, psi = HELIX_PHI_PSI
    out = [{"N": np.zeros(3), "CA": np.array([1.458, 0.0, 0.0])}]
    out[0]["C"] = out[0]["CA"] + 1.525 * np.array(
        [math.cos(math.radians(68.8)), math.sin(math.radians(68.8)), 0.0])
    for _ in range(1, n):
        p = out[-1]
        nn = _nerf(p["N"], p["CA"], p["C"], 1.329, 116.2, psi)
        ca = _nerf(p["CA"], p["C"], nn, 1.458, 121.7, 180.0)
        out.append({"N": nn, "CA": ca, "C": _nerf(p["C"], nn, ca, 1.525, 111.2, phi)})
    for r in out:
        r["O"] = _nerf(r["N"], r["CA"], r["C"], 1.231, 120.5, psi + 180.0)
    # The axis: the CA positions' principal direction.
    ca = np.array([r["CA"] for r in out])
    mid = ca.mean(axis=0)
    _, _, vt = np.linalg.svd(ca - mid)
    z = vt[0] if vt[0] @ (ca[-1] - ca[0]) > 0 else -vt[0]
    x = np.cross(z, [0.0, 0.0, 1.0] if abs(z[2]) < 0.9 else [1.0, 0.0, 0.0])
    x /= np.linalg.norm(x)
    frame = np.stack([x, np.cross(z, x), z])
    return [{k: frame @ (v - mid) for k, v in r.items()} for r in out]


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1.0 - math.cos(angle)) * (k @ k)


def _place_rod(st, rng, residues, frame, spot, direction, last):
    """One helix's backbone: the residues' N, CA, C, O and CB (but a
    glycine's) placed at `spot` along `direction` (turned at random about
    its axis and shifted along it); with `last` the final residue gets no
    O (its carboxylate comes later). Returns [{name: atom}] or None
    (nothing placed) where the helix does not fit."""
    start = st.n
    helix = _ideal_helix(len(residues))
    spin = _rotation([0.0, 0.0, 1.0], rng.uniform(0.0, 2.0 * math.pi))
    flip = np.diag([1.0, 1.0, 1.0]) if direction > 0 else np.diag([1.0, -1.0, -1.0])
    shift = spot + frame[2] * rng.uniform(-ROD_SHIFT, ROD_SHIFT)
    rot = frame.T @ flip @ spin
    placed = []
    # Each residue's atoms keep the floor against the structure, the
    # helix's earlier residues included.
    for k, (res, bb) in enumerate(zip(residues, helix)):
        bb = dict(bb)
        if last and k == len(helix) - 1:
            del bb["O"]
        if res != "GLY":
            bb["CB"] = _nerf(bb["C"], bb["N"], bb["CA"], 1.530, 110.5, -122.6)
        names = [n for n in _BB_NAMES if n in bb]
        rows = [_BB_NAMES.index(n) for n in names]
        elems = [_BB_ELEMS[i] for i in rows]
        pts = np.array([rot @ bb[n] + shift for n in names])
        ext = None
        if placed:
            near = st.within(placed[-1]["C"], 3)
            ext_ids = np.array(sorted(near), np.int64)
            ext = (ext_ids, np.minimum(_BB_FROM_PREV_C[rows, None]
                                       + np.array([near[j] for j in ext_ids])[None], 4))
        if not _fits(st, pts, _BB_COV[rows], _BB_LOCAL[np.ix_(rows, rows)], ext):
            st.truncate(start)
            return None
        ids = {n: st.add(p, e) for n, e, p in zip(names, elems, pts)}
        st.bond(ids["N"], ids["CA"])
        st.bond(ids["CA"], ids["C"])
        for n, to in (("O", "C"), ("CB", "CA")):
            if n in ids:
                st.bond(ids[to], ids[n])
        if placed:
            st.bond(placed[-1]["C"], ids["N"])
        placed.append(ids)
    return placed


_BB_NAMES = ["N", "CA", "C", "O", "CB"]
_BB_ELEMS = ["N", "C", "C", "O", "C"]
_BB_COV = np.array([MOL.covalent_radius(e) for e in _BB_ELEMS])
_BB_LOCAL = np.array([[0, 1, 2, 3, 2], [1, 0, 1, 2, 1], [2, 1, 0, 1, 2], [3, 2, 1, 0, 3],
                      [2, 1, 2, 3, 0]])
# Bonds from the previous residue's C to N, CA, C, O and CB.
_BB_FROM_PREV_C = np.array([1, 2, 3, 4, 3])


def _side_chain_draw(st, rng, res, ids, owner=None, first=None, lifted=None):
    """Turn the side chain beyond CB of `res` through rotamer draws (the
    positions `first`, then the wells, then any angle where no well
    drew a place to take): (positions, no residues) of the first draw
    that fits among the atoms that stand.
    Else, given owner {atom: residue} of the side chains that may be
    lifted and lifted [residues] (the times each was), (positions, the
    residues) of the draw that only those block, the fewest and least
    lifted; else None."""
    names, elems, local, from_bb = _side_distances(res)
    if not names:
        return np.zeros((0, 3)), set()
    cov = np.array([MOL.covalent_radius(e) for e in elems])
    # Bond counts from each side-chain atom to the atoms near its anchors.
    near = {}
    for anchor, counts_from in from_bb.items():
        for j, d in st.within(ids[anchor], 3).items():
            counts = counts_from + d
            near[j] = counts if j not in near else np.minimum(near[j], counts)
    ext_ids = np.array(sorted(near), np.int64)
    ext = (ext_ids, np.minimum(np.stack([near[j] for j in ext_ids], axis=1), 4))
    atoms = {n: st.pos[ids[n]] for n in ("N", "CA", "C")}
    best = None
    for k in range(-1, 2 * ROTAMER_TRIES):
        if k == ROTAMER_TRIES and best is not None:
            break
        if k < 0:
            if first is None:
                continue
            pts = first
        else:
            chis = list(rng.choice(ROTAMERS, 4) + rng.normal(0.0, 10.0, 4)
                        if k < ROTAMER_TRIES else rng.uniform(-180.0, 180.0, 4))
            _side_chain(res, atoms, chis)
            pts = np.array([atoms[n] for n in names])
        hits = _clashes(st, pts, cov, local, ext)
        if hits is None:
            continue
        if hits.size == 0:
            return pts, set()
        if owner is not None and all(int(a) in owner for a in hits):
            blockers = {owner[int(a)] for a in hits}
            cost = sum(1 + lifted[j] for j in blockers)
            if best is None or cost < best[0]:
                best = (cost, pts, blockers)
    return None if best is None else best[1:]


def _put_side_chain(st, res, ids, pts) -> None:
    """The side chain beyond CB at pts: new atoms with their bonds, or its
    lifted atoms put back."""
    names, elems, _, _ = _side_distances(res)
    if names and names[0] in ids:
        for n, p in zip(names, pts):
            st.put(ids[n], p)
        return
    for n, e, p in zip(names, elems, pts):
        ids[n] = st.add(p, e)
    for a, b in residue_bonds(res):
        if (a in names or b in names) and a in ids and b in ids:
            st.bond(ids[a], ids[b])


def _feasible(st, rng, residues, found) -> bool:
    """Whether each residue's side chain beyond CB finds a place among
    the atoms that stand (each tried alone); the places go into found
    {CA atom: positions}."""
    for res, ids in residues:
        draw = _side_chain_draw(st, rng, res, ids, first=found.get(ids["CA"]))
        if draw is None:
            return False
        found[ids["CA"]] = draw[0]
    return True


def _pack_side_chains(st, rng, residues, found) -> None:
    """Every side chain beyond CB, once every backbone stands: the largest
    first (a size's in a seeded order), each first tried where found
    {CA atom: positions} put it among the backbones. One that finds no
    place takes the draw that the fewest placed side chains block, and
    those are lifted and queue again. After REPACK_ROUNDS lifts a residue
    in all, every side chain is lifted and the packing starts again in
    another order, PACK_TRIES times in all."""
    sizes = np.array([len(_side_distances(res)[0]) for res, _ in residues])
    sides = [[] for _ in residues]
    for _ in range(PACK_TRIES):
        queue = list(np.lexsort((rng.random(len(residues)), -sizes)))
        owner = {}
        lifted = np.zeros(len(residues), np.int64)
        placed = np.zeros(len(residues), bool)
        while queue and lifted.sum() <= REPACK_ROUNDS * len(residues):
            i = int(queue.pop(0))
            res, ids = residues[i]
            draw = _side_chain_draw(st, rng, res, ids, owner, found.get(ids["CA"]), lifted)
            if draw is None:
                raise _NoRoom("no room for a side chain")
            pts, blockers = draw
            for j in blockers:
                for a in sides[j]:
                    st.lift(a)
                lifted[j] += 1
                placed[j] = False
                queue.append(j)
            _put_side_chain(st, res, ids, pts)
            sides[i] = [ids[n] for n in _side_distances(res)[0]]
            for a in sides[i]:
                owner[a] = i
            placed[i] = True
        if not queue:
            return
        for i in np.flatnonzero(placed):
            for a in sides[i]:
                st.lift(a)
    raise _NoRoom("no room for the side chains")


def _carboxylate(st, rng, res, ids):
    """The chain's last residue: O turned with OXT to where both fit."""
    c = ids["C"]
    near = st.within(c, 2)
    p = {k: st.pos[v] for k, v in ids.items()}
    cov = np.array([MOL.covalent_radius("O")] * 2)
    local = np.array([[0, 2], [2, 0]])
    ids_near = np.array(sorted(near), np.int64)
    counts = np.minimum(np.array([near[j] for j in ids_near]) + 1, 4)
    for _ in range(256):
        psi = rng.uniform(-180.0, 180.0)
        pts = np.array([_nerf(p["N"], p["CA"], p["C"], 1.249, 118.0, psi + 180.0),
                        _nerf(p["N"], p["CA"], p["C"], 1.249, 118.0, psi)])
        if _fits(st, pts, cov, local, (ids_near, np.stack([counts, counts]))):
            break
    else:
        raise _NoRoom("no room for the terminal carboxylate")
    for name, q in zip(("O", "OXT"), pts):
        ids[name] = st.add(q, "O")
        st.bond(c, ids[name])


def _place_hem(st, angle, spot, frame):
    """A HEM with Fe at `spot`, its plane holding the subunit's helix axis
    and pointing out from the axis at `angle` (its ring A propionate
    outward); returns ({name: atom}, bonds)."""
    names, elems, local_pts, bonds = hem_template()
    cov = np.array([MOL.covalent_radius(e) for e in elems])
    local = _graph_distances(names, bonds)
    # The porphyrin's plane is local xy: x along frame[2], y outward.
    turn = _rotation(frame[2], angle)
    rot = turn @ np.stack([frame[2], frame[0], frame[1]]).T
    pts = local_pts @ rot.T + spot
    if not _fits(st, pts, cov, local, None):
        raise _NoRoom("no room for a HEM")
    ids = {n: st.add(q, e) for n, e, q in zip(names, elems, pts)}
    for a, b in bonds:
        st.bond(ids[a], ids[b])
    return ids, bonds


def _subunit(st, rng, sequence, config, frame):
    """One chain as a bundle of alpha helices of about helix_length
    residues along frame[2] in two rows of a hexagonal lattice of
    rod_spacing along frame[0] (a globin's two layers), antiparallel
    neighbours, the spots nearest the rows' middle first; the HEM caps
    the first row's end, its plane across both rows. Each helix stands
    where every side chain near it keeps a place among the backbones;
    then the side chains are packed (_pack_side_chains). Returns
    ([(residue, {name: atom})], hem or None)."""
    spacing = float(config["rod_spacing"])
    length = int(config["helix_length"])
    rods = max(1, round(len(sequence) / length))
    cuts = np.linspace(0, len(sequence), rods + 1).round().astype(int)
    # A proline's ring meets the turn before it inside a helix: each one
    # takes the first place of a helix (where the sequence has more
    # prolines than helices, the helix's first free places).
    sequence = list(sequence)
    firsts = [c + j for j in range(length) for c in cuts[:-1] if c + j < len(sequence)]
    pro = [i for i, r in enumerate(sequence) if r == "PRO"]
    others = [i for i, r in enumerate(sequence) if r != "PRO"]
    slots = firsts[:len(pro)]
    rest = [i for i in range(len(sequence)) if i not in set(slots)]
    arranged = [None] * len(sequence)
    for slot, i in zip(slots, pro):
        arranged[slot] = sequence[i]
    for slot, i in zip(rest, others):
        arranged[slot] = sequence[i]
    sequence = arranged
    # The spots nearest the rows' middle first: a helix that finds no room
    # takes the next spot out. The HEM takes the spot before the first
    # row's helices.
    spots = [(spacing * (i + 0.5 * j), spacing * math.sqrt(0.75) * j)
             for j in (0, 1) for i in range(-rods - 1, rods + 1)]
    mid = (0.25 * spacing, spacing * math.sqrt(0.75) * 0.5)
    order = sorted(spots, key=lambda p: (round(math.dist(p, mid), 3), p))
    hem_spot = (min(x for x, y in order[:rods] if y == 0.0) - spacing, 0.0)
    order.remove(hem_spot)
    hem = None
    if config["hem"]:
        hem = _place_hem(st, math.pi / 2.0 + math.pi * rng.integers(2),
                         hem_spot[0] * frame[0], frame)
    residues, found = [], {}
    for k in range(rods):
        seg = sequence[cuts[k]:cuts[k + 1]]
        placed = None
        while placed is None and order:
            x, y = order.pop(0)
            spot = x * frame[0] + y * frame[1]
            for _ in range(ROD_TRIES):
                start = st.n
                placed = _place_rod(st, rng, seg, frame, spot, 1 if k % 2 == 0 else -1,
                                    k == rods - 1)
                if placed is None:
                    continue
                # Every side chain near the helix keeps a place among the
                # backbones.
                cb = np.array([st.pos[ids.get("CB", ids["CA"])] for _, ids in residues])
                rel = cb - spot if residues else np.zeros((0, 3))
                off_axis = np.linalg.norm(rel - np.outer(rel @ frame[2], frame[2]), axis=1)
                near = [residues[i] for i in np.flatnonzero(off_axis < FEASIBLE_REACH)]
                if _feasible(st, rng, list(zip(seg, placed)) + near, found):
                    break
                st.truncate(start)
                for atom in [a for a in found if a >= start]:
                    del found[atom]
                placed = None
        if placed is None:
            raise _NoRoom("no room for a helix")
        residues += list(zip(seg, placed))
    _pack_side_chains(st, rng, residues, found)
    _carboxylate(st, rng, *residues[-1])
    return residues, hem


def build_structure(config: dict, seed: int) -> dict:
    """The structure drawn from the seed: {"residues": [(chain, seq no,
    residue, {name: atom})], "hems": [(chain, seq no, {name: atom},
    bonds by name)], "positions" f64[N, 3], "elements" [N], "peptides"
    [(C, N)]}. Each subunit is grown alone about the origin (a new draw
    where it finds no room), then the subunits are docked (_dock)."""
    rng = np.random.default_rng([seed % 2**64, 7])
    # The assembly's frame: every helix runs along its third axis.
    axes = _quat_matrix(rng.normal(size=4))
    parts = []
    for corner, (chain, kind) in zip(CORNERS, config["chains"]):
        counts = config["compositions"][kind]
        sequence = [r for r, c in sorted(counts.items()) for _ in range(int(c))]
        sequence = [sequence[i] for i in rng.permutation(len(sequence))]
        # Subunit k is subunit 0 turned by the half-turn about the
        # assembly's axis that takes corner 0 to corner k (a D2 tetramer,
        # as haemoglobin's alpha2 beta2).
        frame = np.diag(corner * corner.prod()) @ axes
        for _ in range(SUBUNIT_TRIES):
            st = _Structure()
            try:
                grown, hem = _subunit(st, rng, sequence, config, frame)
                break
            except _NoRoom:
                continue
        else:
            raise RuntimeError(f"no room for subunit {chain}")
        parts.append((chain, len(sequence), st, grown, hem))
    offsets = _dock([(st.pos[:st.n], st.cov[:st.n]) for _, _, st, _, _ in parts], axes,
                    config["extent"])
    residues, hems, pos, elements, adj = [], [], [], [], []
    for (chain, length, st, grown, hem), offset in zip(parts, offsets):
        base = len(elements)
        pos.append(st.pos[:st.n] + offset)
        elements += st.elem
        adj += [[j + base for j in a] for a in st.adj]
        for seq, (res, ids) in enumerate(grown, 1):
            residues.append((chain, seq, res, {n: i + base for n, i in ids.items()}))
        if hem is not None:
            ids, bonds = hem
            hems.append((chain, length + 1, {n: i + base for n, i in ids.items()}, bonds))
    # The peptide bonds: within a helix, not across the chain's breaks.
    peptides = [(a[3]["C"], b[3]["N"]) for a, b in zip(residues, residues[1:])
                if a[0] == b[0] and a[3]["C"] in adj[b[3]["N"]]]
    return {"residues": residues, "hems": hems, "positions": np.concatenate(pos),
            "elements": elements, "peptides": peptides}


def _apart(a, b) -> bool:
    """Whether no atom of part a = (positions [n, 3], covalent radii [n])
    comes within CONTACT_FLOOR, or the inference cutoff plus MARGIN where
    that is larger, of part b's (atoms of two parts are never bonded)."""
    (pa, ca), (pb, cb) = a, b
    reach = max(CONTACT_FLOOR, ca.max() + cb.max() + MOL.BOND_TOLERANCE + MARGIN)
    lo = np.maximum(pa.min(axis=0), pb.min(axis=0)) - reach
    hi = np.minimum(pa.max(axis=0), pb.max(axis=0)) + reach
    ina = ((pa > lo) & (pa < hi)).all(axis=1)
    inb = ((pb > lo) & (pb < hi)).all(axis=1)
    pa, ca, pb, cb = pa[ina], ca[ina], pb[inb], cb[inb]
    for s in range(0, pa.shape[0], 256):
        d = np.linalg.norm(pa[s:s + 256, None] - pb[None], axis=-1)
        need = np.maximum(CONTACT_FLOOR,
                          ca[s:s + 256, None] + cb[None] + MOL.BOND_TOLERANCE + MARGIN)
        if (d < need).any():
            return False
    return True


# The subunits' corners: the tetrahedron's, each axis scaled apart.
CORNERS = np.array([(1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)], np.float64)


def _dock(parts, axes, extent):
    """Offsets f64[k, 3] that pack the parts [(positions about the
    origin, covalent radii)] at the corners of a tetrahedron of
    half-sides (a, b, c) along the assembly's axes. From apart, each
    half-side in turn shrinks, by bisection to DOCK_TOL, to the least
    that keeps every pair of parts apart (_apart), twice over; of the six
    orders of the axes, the packing whose box comes nearest `extent` (the
    entry's)."""
    corners = CORNERS[:len(parts)]
    local = [(p @ axes.T, c) for p, c in parts]
    target = np.log(np.sort(np.asarray(extent, np.float64)))

    def clear(abc):
        m = [(p + corner * abc, c) for (p, c), corner in zip(local, corners)]
        return all(_apart(m[i], m[j]) for i in range(len(m)) for j in range(i + 1, len(m)))

    best = None
    for order in itertools.permutations(range(3)):
        abc = np.full(3, max(float(np.abs(p).max()) for p, _ in local) + CONTACT_FLOOR)
        for axis in order + order:
            lo, hi = 0.0, abc[axis]
            while hi - lo > DOCK_TOL:
                trial = abc.copy()
                trial[axis] = 0.5 * (lo + hi)
                lo, hi = (lo, trial[axis]) if clear(trial) else (trial[axis], hi)
            abc[axis] = hi
        pts = np.concatenate([p + corner * abc for (p, _), corner in zip(local, corners)])
        miss = float(np.sum((np.log(np.sort(pts.max(axis=0) - pts.min(axis=0))) - target) ** 2))
        if best is None or miss < best[0]:
            best = (miss, abc)
    return (corners * best[1]) @ axes


def _canonical(res, ids):
    """The residue's atoms in the PDB's order: N, CA, C, O, the side chain
    as placed, OXT."""
    first = [n for n in ("N", "CA", "C", "O") if n in ids]
    rest = [n for n in ids if n not in first and n != "OXT"]
    return first + rest + (["OXT"] if "OXT" in ids else [])


def _atom_line(record, serial, name, res, chain, seq, p, element):
    pad = f" {name:<3}" if len(name) < 4 and len(element) == 1 else f"{name:<4}"
    return (f"{record}{serial:>5} {pad} {res:>3} {chain}{seq:>4}    "
            f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}{1.0:6.2f}{20.0:6.2f}"
            f"          {element.upper():>2}")


def generate(config: dict, seed: int) -> dict:
    """The structure drawn from the seed as PDB text and arrays:
    {"pdb": text, "positions": f32[N, 3] as the text gives them,
    "elements": [N], "is_het": bool[N], "conect": i32[C, 2] (the CONECT
    pairs, i < j), "bonds": i32[B, 2] (every covalent bond, i < j),
    "chains": [chain id a residue], "res_names": [residue name a
    residue]} in the text's atom order."""
    s = build_structure(config, seed)
    pos, elems = s["positions"], s["elements"]
    lines, order, het, conect, bonds = [], [], [], [], []
    serial_of = {}
    chains, res_names = [], []
    serial = 1

    def emit(record, atom, name, res, chain, seq):
        nonlocal serial
        lines.append(_atom_line(record, serial, name, res, chain, seq, pos[atom],
                                elems[atom]))
        serial_of[atom] = serial
        order.append(atom)
        het.append(record == "HETATM")
        serial += 1

    by_chain = {}
    for chain, seq, res, ids in s["residues"]:
        by_chain.setdefault(chain, []).append((seq, res, ids))
    for chain, _ in config["chains"]:
        residues = by_chain[chain]
        for seq, res, ids in residues:
            chains.append(chain)
            res_names.append(res)
            for name in _canonical(res, ids):
                emit("ATOM  ", ids[name], name, res, chain, seq)
        last_seq, last_res, _ = residues[-1]
        lines.append(f"TER   {serial:>5}      {last_res:>3} {chain}{last_seq:>4}")
        serial += 1
    for chain, seq, ids, hem_bonds in s["hems"]:
        for name, atom in ids.items():
            emit("HETATM", atom, name, "HEM", chain, seq)
    # CONECT records of the HEM groups, in both directions, four partners
    # a record.
    partners = {}
    for _, _, ids, hem_bonds in s["hems"]:
        for a, b in hem_bonds:
            partners.setdefault(ids[a], []).append(ids[b])
            partners.setdefault(ids[b], []).append(ids[a])
    for atom in sorted(partners, key=lambda a: serial_of[a]):
        others = sorted(partners[atom], key=lambda a: serial_of[a])
        for k in range(0, len(others), 4):
            lines.append(f"CONECT{serial_of[atom]:>5}"
                         + "".join(f"{serial_of[o]:>5}" for o in others[k:k + 4]))
    lines.append("END")
    text = "\n".join(lines) + "\n"

    index = {atom: i for i, atom in enumerate(order)}
    for _, _, ids, hem_bonds in s["hems"]:
        for a, b in hem_bonds:
            conect.append(sorted((index[ids[a]], index[ids[b]])))
    for chain, seq, res, ids in s["residues"]:
        for a, b in residue_bonds(res):
            if a in ids and b in ids:
                bonds.append(sorted((index[ids[a]], index[ids[b]])))
        if "OXT" in ids:
            bonds.append(sorted((index[ids["C"]], index[ids["OXT"]])))
    for c, n in s["peptides"]:
        bonds.append(sorted((index[c], index[n])))
    bonds += conect
    # The coordinates as the text gives them (%8.3f, read back as float32).
    text_pos = np.array([[float(f"{v:8.3f}") for v in pos[a]] for a in order], np.float32)
    return {"pdb": text, "positions": text_pos, "elements": [elems[a] for a in order],
            "is_het": np.array(het, bool),
            "conect": np.unique(np.array(conect, np.int32).reshape(-1, 2), axis=0),
            "bonds": np.unique(np.array(bonds, np.int32).reshape(-1, 2), axis=0),
            "chains": chains, "res_names": res_names}


def program_scene(geo: dict, config: dict, device):
    """The program's scene: its parse of the text through
    load_molecule_scene with the configuration's display keys; no
    volume."""
    from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
    from webgl_raytracer_tpu_torch.models import parse_auto_detect

    mol = parse_auto_detect(geo["pdb"], "protein.pdb")
    loaded = load_molecule_scene(
        mol, display_style=config["display_style"], atom_scale=float(config["atom_scale"]),
        bond_radius=float(config["bond_radius"]), show_surface=bool(config["show_surface"]),
        probe_radius=float(config["probe_radius"]),
        surface_resolution=float(config["surface_resolution"]),
        surface_atom_mode=config["surface_atom_mode"], device=device)
    return loaded.scene, None


def bounds(geo: dict):
    """The atoms' box grown by the largest van der Waals radius, which
    holds the SES, as float32 (lo, hi)."""
    pos = np.asarray(geo["positions"], np.float32)
    grow = np.float32(max(MOL.VDW.get(e, MOL.VDW_DEFAULT) for e in geo["elements"]))
    return pos.min(axis=0) - grow, pos.max(axis=0) + grow


def reference_scene(geo: dict, config: dict, sky, device, dtype):
    return TR.Scene(MOL.scene_geometry(geo, config, device), sky, device, dtype)
