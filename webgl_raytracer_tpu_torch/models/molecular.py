"""The bundled molecules and their ball-and-stick geometry (host numpy).

The port's own copy of what it uses from webgl_raytracer_tpu/models/
molecular.py: the `Geometry` SoA record the scene compile reads, the SDF
(V2000) parser, the six bundled molecules (models/molecules/*.sdf, copies
of the JAX package's assets) and `molecule_to_geometry`. PDB parsing, bond
inference and the cartoon and surface generators come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .elements import (BOND_COLOR, BOND_RADIUS, element_colors_array,
                       element_radii_array)

MOLECULE_DIR = Path(__file__).resolve().parent / "molecules"
BUILTIN_MOLECULE_NAMES = ("caffeine", "aspirin", "benzene", "ethanol",
                          "ibuprofen", "glucose")


@dataclass
class MolData:
    """A parsed molecule: positions f32[N,3], element symbols, bonds
    i32[B,2] (atom indices)."""
    positions: np.ndarray
    elements: list[str]
    bonds: np.ndarray

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
    return Geometry(z3.copy(), z1.copy(), z3.copy(), z3.copy(), z3.copy(),
                    z1.copy(), z3.copy())


def parse_sdf(text: str) -> MolData:
    """Parse an SDF/MOL V2000 block: counts line, atom block, bond block."""
    lines = text.split("\n")
    if len(lines) < 4:
        raise ValueError("Invalid SDF file: too few lines")
    counts = lines[3]
    try:
        atom_count = int(counts[0:3].strip())
        bond_count = int(counts[3:6].strip())
    except (ValueError, IndexError) as exc:
        raise ValueError("Invalid SDF file: cannot parse atom/bond counts") from exc

    positions, elements = [], []
    for i in range(atom_count):
        idx = 4 + i
        if idx >= len(lines) or not lines[idx]:
            continue
        line = lines[idx]
        raw = line[31:34].strip().upper()
        positions.append((float(line[0:10]), float(line[10:20]), float(line[20:30])))
        elements.append(raw[0] + raw[1].lower() if len(raw) == 2 else raw)

    bonds = []
    for i in range(bond_count):
        idx = 4 + atom_count + i
        if idx >= len(lines) or not lines[idx]:
            continue
        line = lines[idx]
        a1 = int(line[0:3].strip()) - 1
        a2 = int(line[3:6].strip()) - 1
        if 0 <= a1 < atom_count and 0 <= a2 < atom_count:
            bonds.append((a1, a2))
    return MolData(positions=np.asarray(positions, np.float32).reshape(-1, 3),
                   elements=elements,
                   bonds=np.asarray(bonds, np.int32).reshape(-1, 2))


def get_builtin_molecule(name: str) -> MolData:
    """One of the bundled small molecules."""
    key = name.lower()
    if key not in BUILTIN_MOLECULE_NAMES:
        raise ValueError(f"Unknown molecule: {name}. Available: "
                         f"{', '.join(BUILTIN_MOLECULE_NAMES)}")
    return parse_sdf((MOLECULE_DIR / f"{key}.sdf").read_text(encoding="utf-8"))


def molecule_to_geometry(mol: MolData, radius_scale: float = 0.4,
                         bond_radius: float = BOND_RADIUS,
                         bond_color: tuple[float, float, float] = BOND_COLOR,
                         show_bonds: bool = True) -> Geometry:
    """Atoms -> coloured spheres, bonds -> cylinders (ball and stick)."""
    if mol.num_atoms == 0:
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
