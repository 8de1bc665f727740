"""Molecule parsing and conversion to renderable primitives (host numpy).

The port's own copy of webgl_raytracer_tpu/models/molecular.py, which
follows the reference viewer's molecular.js: fixed-column PDB parsing
with HELIX/SHEET secondary-structure records and CONECT bonds, SDF/MOL
V2000 parsing, distance-based bond inference (covalent radii + 0.45 A over
a 2.5 A spatial hash), ball-and-stick geometry, HETATM splitting, format
auto-detection and the six bundled molecules (models/molecules/*.sdf,
copies of the JAX package's assets). Everything is parsed straight into
SoA numpy arrays. The RCSB download (the JAX package's fetch_pdb) is not
part of the port: it needs the network; parse a local file instead.
Line references (:N) are to molecular.js.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils import telemetry
from .elements import (BOND_COLOR, BOND_RADIUS, ELEMENT_RADII,
                       covalent_radii_array, element_colors_array,
                       element_radii_array)

MOLECULE_DIR = Path(__file__).resolve().parent / "molecules"
BUILTIN_MOLECULE_NAMES = ("caffeine", "aspirin", "benzene", "ethanol",
                          "ibuprofen", "glucose")

# Bond-inference constants (reference: molecular.js:266-271).
BOND_TOLERANCE = 0.45   # Angstroms added to covalent radii sum
BOND_MIN_DIST = 0.4     # below this, treat as overlapping duplicates
BOND_CELL_SIZE = 2.5    # spatial-hash cell, larger than max bond length


@dataclass
class SecondaryRange:
    """One HELIX or SHEET record: a residue range on a chain."""
    chain_id: str
    start_seq: int
    start_icode: str
    end_seq: int
    end_icode: str
    end_chain_id: str


@dataclass
class MolData:
    """Parsed molecule in SoA form.

    positions: f32[N,3]; bonds: i32[B,2] (indices into atoms, i<j).
    Per-atom metadata kept as parallel arrays/lists for the cartoon and
    surface generators.
    """
    positions: np.ndarray
    elements: list[str]
    serials: np.ndarray          # i32[N]
    names: list[str]
    is_het: np.ndarray           # bool[N]
    bonds: np.ndarray            # i32[B,2]
    alt_locs: list[str] = field(default_factory=list)
    res_names: list[str] = field(default_factory=list)
    chain_ids: list[str] = field(default_factory=list)
    res_seqs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    res_seq_valid: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    i_codes: list[str] = field(default_factory=list)
    occupancies: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    helices: list[SecondaryRange] = field(default_factory=list)
    sheets: list[SecondaryRange] = field(default_factory=list)

    @property
    def num_atoms(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_bonds(self) -> int:
        return int(self.bonds.shape[0])


@dataclass
class Geometry:
    """Renderable primitives in SoA form (the scene-compile input)."""
    sphere_centers: np.ndarray   # f32[N,3]
    sphere_radii: np.ndarray     # f32[N]
    sphere_colors: np.ndarray    # f32[N,3]
    cyl_p1: np.ndarray           # f32[M,3]
    cyl_p2: np.ndarray           # f32[M,3]
    cyl_radii: np.ndarray        # f32[M]
    cyl_colors: np.ndarray       # f32[M,3]

    @property
    def num_spheres(self) -> int:
        return int(self.sphere_centers.shape[0])

    @property
    def num_cylinders(self) -> int:
        return int(self.cyl_p1.shape[0])


def empty_geometry() -> Geometry:
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return Geometry(z3.copy(), z1.copy(), z3.copy(), z3.copy(), z3.copy(), z1.copy(), z3.copy())


def _normalize_element(raw: str, name_field: str = "") -> str:
    """Resolve an element symbol from the PDB element column or atom name.

    The reference uppercases and then falls back to the first letter when the
    two-letter uppercase key misses its radius table (molecular.js:131-143),
    which misidentifies e.g. FE. We instead title-case two-letter symbols
    ("CL" -> "Cl") before falling back, which keeps one-letter behavior
    identical and fixes two-letter heteroatoms.

    When the element column is empty we use the PDB name-column alignment
    convention: a two-letter element fills columns 13-14 ("FE  " = iron),
    while one-letter elements are right-shifted (" CA " = alpha carbon, not
    calcium). `name_field` must therefore be the *raw, unstripped* 4-char
    name column.
    """
    element = raw.strip()
    if not element and name_field:
        two = name_field[:2]
        if len(two) == 2 and two[0].isalpha() and two[1].isalpha():
            element = two  # aligned two-letter symbol (or 4-char H names)
        else:
            element = two.strip().lstrip("0123456789")[:1]
    element = element.strip().upper()
    if len(element) == 2:
        title = element[0] + element[1].lower()
        if title in ELEMENT_RADII:
            return title
        return element[0]
    return element


def _parse_int(s: str) -> int | None:
    s = s.strip()
    if not s:
        return None
    try:
        return int(s)
    except ValueError:
        return None


def _parse_secondary(line: str, kind: str) -> SecondaryRange | None:
    """Parse one HELIX/SHEET record (PDB fixed columns; molecular.js:73-114)."""
    if kind == "HELIX":
        chain_id = line[19:20].strip() or " "
        start_seq = _parse_int(line[21:25])
        start_icode = line[25:26].strip()
        end_chain = line[31:32].strip() or " "
        end_seq = _parse_int(line[33:37])
        end_icode = line[37:38].strip()
    else:  # SHEET
        chain_id = line[21:22].strip() or " "
        start_seq = _parse_int(line[22:26])
        start_icode = line[26:27].strip()
        end_chain = line[32:33].strip() or " "
        end_seq = _parse_int(line[33:37])
        end_icode = line[37:38].strip()
    if start_seq is None or end_seq is None:
        return None
    return SecondaryRange(chain_id, start_seq, start_icode, end_seq, end_icode, end_chain)


@telemetry.spanned("scene.molecule")
def parse_pdb(text: str) -> MolData:
    """Parse PDB text: ATOM/HETATM, CONECT, HELIX, SHEET records.

    Column layout per the PDB v3.3 spec, matching molecular.js:60-185.
    Falls back to distance-based bond inference when no CONECT records exist.
    With the recorder on, a parse is the host span scene.molecule.
    """
    positions: list[tuple[float, float, float]] = []
    elements: list[str] = []
    serials: list[int] = []
    names: list[str] = []
    is_het: list[bool] = []
    alt_locs: list[str] = []
    res_names: list[str] = []
    chain_ids: list[str] = []
    res_seqs: list[int] = []
    res_seq_valid: list[bool] = []
    i_codes: list[str] = []
    occupancies: list[float] = []
    bonds: list[tuple[int, int]] = []
    helices: list[SecondaryRange] = []
    sheets: list[SecondaryRange] = []
    serial_to_index: dict[int, int] = {}

    for line_no, line in enumerate(text.split("\n"), 1):
        record = line[0:6].strip()
        if record == "HELIX":
            rng = _parse_secondary(line, "HELIX")
            if rng is not None:
                helices.append(rng)
        elif record == "SHEET":
            rng = _parse_secondary(line, "SHEET")
            if rng is not None:
                sheets.append(rng)
        elif record in ("ATOM", "HETATM"):
            serial = _parse_int(line[6:11]) or 0
            name = line[12:16].strip()
            try:
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
            except ValueError as exc:
                raise ValueError(
                    f"PDB line {line_no}: malformed coordinate columns "
                    f"30-54 ({line[30:54]!r}) — fixed-column ATOM records "
                    f"require coordinates within -999.999..9999.999"
                ) from exc
            occ_raw = line[54:60].strip()
            res_seq = _parse_int(line[22:26])

            serial_to_index[serial] = len(positions)
            positions.append((x, y, z))
            elements.append(_normalize_element(line[76:78], line[12:16]))
            serials.append(serial)
            names.append(name)
            is_het.append(record == "HETATM")
            alt_locs.append(line[16:17].strip())
            res_names.append(line[17:20].strip())
            chain_ids.append(line[21:22].strip() or " ")
            res_seqs.append(res_seq if res_seq is not None else 0)
            res_seq_valid.append(res_seq is not None)
            i_codes.append(line[26:27].strip())
            occupancies.append(float(occ_raw) if occ_raw else np.nan)
        elif record == "CONECT":
            serial = _parse_int(line[6:11])
            if serial is None or serial not in serial_to_index:
                continue
            from_index = serial_to_index[serial]
            for col in range(11, 31, 5):
                bonded = _parse_int(line[col:col + 5])
                if bonded is None:
                    continue
                to_index = serial_to_index.get(bonded)
                if to_index is not None and from_index < to_index:
                    bonds.append((from_index, to_index))

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    bond_arr = np.asarray(bonds, np.int32).reshape(-1, 2)
    if bond_arr.shape[0] == 0 and pos.shape[0] > 1:
        bond_arr = infer_bonds(pos, elements)

    return MolData(
        positions=pos,
        elements=elements,
        serials=np.asarray(serials, np.int32),
        names=names,
        is_het=np.asarray(is_het, bool),
        bonds=bond_arr,
        alt_locs=alt_locs,
        res_names=res_names,
        chain_ids=chain_ids,
        res_seqs=np.asarray(res_seqs, np.int32),
        res_seq_valid=np.asarray(res_seq_valid, bool),
        i_codes=i_codes,
        occupancies=np.asarray(occupancies, np.float32),
        helices=helices,
        sheets=sheets,
    )


@telemetry.spanned("scene.molecule")
def parse_sdf(text: str) -> MolData:
    """Parse an SDF/MOL V2000 block (counts line, atom block, bond block).

    Matches molecular.js:192-251.
    """
    lines = text.split("\n")
    if len(lines) < 4:
        raise ValueError("Invalid SDF file: too few lines")

    counts = lines[3]
    try:
        atom_count = int(counts[0:3].strip())
        bond_count = int(counts[3:6].strip())
    except (ValueError, IndexError) as exc:
        raise ValueError("Invalid SDF file: cannot parse atom/bond counts") from exc

    positions: list[tuple[float, float, float]] = []
    elements: list[str] = []
    names: list[str] = []
    for i in range(atom_count):
        idx = 4 + i
        if idx >= len(lines) or not lines[idx]:
            continue
        line = lines[idx]
        x = float(line[0:10])
        y = float(line[10:20])
        z = float(line[20:30])
        raw = line[31:34].strip().upper()
        element = raw[0] + raw[1].lower() if len(raw) == 2 else raw
        positions.append((x, y, z))
        elements.append(element)
        names.append(f"{element}{i + 1}")

    bonds: list[tuple[int, int]] = []
    for i in range(bond_count):
        idx = 4 + atom_count + i
        if idx >= len(lines) or not lines[idx]:
            continue
        line = lines[idx]
        a1 = int(line[0:3].strip()) - 1
        a2 = int(line[3:6].strip()) - 1
        if 0 <= a1 < atom_count and 0 <= a2 < atom_count:
            bonds.append((a1, a2))

    n = len(positions)
    return MolData(
        positions=np.asarray(positions, np.float32).reshape(-1, 3),
        elements=elements,
        serials=np.arange(1, n + 1, dtype=np.int32),
        names=names,
        is_het=np.zeros(n, bool),
        bonds=np.asarray(bonds, np.int32).reshape(-1, 2),
        alt_locs=[""] * n,
        res_names=[""] * n,
        chain_ids=[" "] * n,
        res_seqs=np.zeros(n, np.int32),
        res_seq_valid=np.zeros(n, bool),
        i_codes=[""] * n,
        occupancies=np.full(n, np.nan, np.float32),
    )


def infer_bonds(positions: np.ndarray, elements: list[str]) -> np.ndarray:
    """Distance-based bond inference (vectorized spatial hash).

    Bond when  BOND_MIN_DIST <= |p_i - p_j| <= r_cov(i) + r_cov(j) + 0.45 A,
    using 2.5 A hash cells and 27-cell neighborhoods (molecular.js:265-325) —
    but evaluated as numpy block operations per cell pair instead of a scalar
    double loop.
    """
    n = positions.shape[0]
    if n < 2:
        return np.zeros((0, 2), np.int32)
    radii = covalent_radii_array(elements).astype(np.float64)
    pos = positions.astype(np.float64)

    cell_idx = np.floor(pos / BOND_CELL_SIZE).astype(np.int64)
    cells: dict[tuple[int, int, int], np.ndarray] = {}
    # Group atom indices by cell.
    order = np.lexsort((cell_idx[:, 2], cell_idx[:, 1], cell_idx[:, 0]))
    sorted_cells = cell_idx[order]
    boundaries = np.nonzero(np.any(np.diff(sorted_cells, axis=0) != 0, axis=1))[0] + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [n]))
    for s, e in zip(starts, ends):
        key = tuple(int(v) for v in sorted_cells[s])
        cells[key] = order[s:e]

    out: list[np.ndarray] = []
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    # Only visit each unordered cell pair once: self cell plus the 13 offsets
    # that are lexicographically positive.
    half = [o for o in offsets if o > (0, 0, 0)]

    def _pairs(ai: np.ndarray, aj: np.ndarray, same_cell: bool) -> None:
        pi = pos[ai]
        pj = pos[aj]
        d = np.linalg.norm(pi[:, None, :] - pj[None, :, :], axis=-1)
        max_d = radii[ai][:, None] + radii[aj][None, :] + BOND_TOLERANCE
        mask = (d >= BOND_MIN_DIST) & (d <= max_d)
        if same_cell:
            mask &= ai[:, None] < aj[None, :]
        ii, jj = np.nonzero(mask)
        if ii.size:
            a = ai[ii]
            b = aj[jj]
            lo = np.minimum(a, b)
            hi = np.maximum(a, b)
            out.append(np.stack([lo, hi], axis=1))

    for key, atoms_a in cells.items():
        _pairs(atoms_a, atoms_a, same_cell=True)
        for off in half:
            nb = (key[0] + off[0], key[1] + off[1], key[2] + off[2])
            atoms_b = cells.get(nb)
            if atoms_b is not None:
                _pairs(atoms_a, atoms_b, same_cell=False)

    if not out:
        return np.zeros((0, 2), np.int32)
    pairs = np.concatenate(out, axis=0)
    pairs = np.unique(pairs, axis=0)
    return pairs.astype(np.int32)


def molecule_to_geometry(
    mol: MolData,
    radius_scale: float = 0.4,
    bond_radius: float = BOND_RADIUS,
    bond_color: tuple[float, float, float] = BOND_COLOR,
    show_bonds: bool = True,
) -> Geometry:
    """Atoms -> colored spheres, bonds -> cylinders (molecular.js:333-371)."""
    n = mol.num_atoms
    if n == 0:
        return empty_geometry()
    centers = mol.positions.astype(np.float32)
    radii = element_radii_array(mol.elements) * np.float32(radius_scale)
    colors = element_colors_array(mol.elements)

    if show_bonds and bond_radius > 0 and mol.num_bonds > 0:
        p1 = centers[mol.bonds[:, 0]]
        p2 = centers[mol.bonds[:, 1]]
        m = p1.shape[0]
        cyl_r = np.full(m, bond_radius, np.float32)
        cyl_c = np.tile(np.asarray(bond_color, np.float32), (m, 1))
    else:
        p1 = np.zeros((0, 3), np.float32)
        p2 = np.zeros((0, 3), np.float32)
        cyl_r = np.zeros((0,), np.float32)
        cyl_c = np.zeros((0, 3), np.float32)

    return Geometry(centers, radii, colors, p1, p2, cyl_r, cyl_c)


def split_by_hetatm(mol: MolData) -> tuple[MolData, MolData]:
    """Split into (standard, hetero) molecules; bonds crossing the split are
    dropped (molecular.js:373-405)."""
    het = mol.is_het
    idx_std = np.nonzero(~het)[0]
    idx_het = np.nonzero(het)[0]
    remap = np.full(mol.num_atoms, -1, np.int64)
    remap[idx_std] = np.arange(idx_std.size)
    remap_het = np.full(mol.num_atoms, -1, np.int64)
    remap_het[idx_het] = np.arange(idx_het.size)

    def _subset(indices: np.ndarray, remap_arr: np.ndarray, want_het: bool) -> MolData:
        sel = indices
        if mol.num_bonds:
            b = mol.bonds
            keep = (het[b[:, 0]] == want_het) & (het[b[:, 1]] == want_het)
            bonds = remap_arr[b[keep]].astype(np.int32)
        else:
            bonds = np.zeros((0, 2), np.int32)
        return MolData(
            positions=mol.positions[sel],
            elements=[mol.elements[i] for i in sel],
            serials=mol.serials[sel],
            names=[mol.names[i] for i in sel],
            is_het=mol.is_het[sel],
            bonds=bonds,
            alt_locs=[mol.alt_locs[i] for i in sel] if mol.alt_locs else [],
            res_names=[mol.res_names[i] for i in sel] if mol.res_names else [],
            chain_ids=[mol.chain_ids[i] for i in sel] if mol.chain_ids else [],
            res_seqs=mol.res_seqs[sel] if mol.res_seqs.size else mol.res_seqs,
            res_seq_valid=mol.res_seq_valid[sel] if mol.res_seq_valid.size else mol.res_seq_valid,
            i_codes=[mol.i_codes[i] for i in sel] if mol.i_codes else [],
            occupancies=mol.occupancies[sel] if mol.occupancies.size else mol.occupancies,
            helices=mol.helices,
            sheets=mol.sheets,
        )

    return _subset(idx_std, remap, False), _subset(idx_het, remap_het, True)


def parse_auto_detect(text: str, filename: str = "") -> MolData:
    """Detect PDB vs SDF from extension or content (molecular.js:428-443)."""
    ext = filename.lower().rsplit(".", 1)[-1] if "." in filename else ""
    if ext == "pdb" or "ATOM  " in text or "HETATM" in text:
        return parse_pdb(text)
    if ext in ("sdf", "mol") or "V2000" in text or "V3000" in text:
        return parse_sdf(text)
    try:
        return parse_pdb(text)
    except ValueError:
        return parse_sdf(text)


def get_builtin_molecule(name: str) -> MolData:
    """One of the bundled small molecules."""
    key = name.lower()
    if key not in BUILTIN_MOLECULE_NAMES:
        raise ValueError(f"Unknown molecule: {name}. Available: "
                         f"{', '.join(BUILTIN_MOLECULE_NAMES)}")
    return parse_sdf((MOLECULE_DIR / f"{key}.sdf").read_text(encoding="utf-8"))
