"""Element tables: CPK colours, van der Waals radii, covalent radii (for
distance-based bond inference) and the bond defaults of the ball-and-stick
style.

The port's own copy of webgl_raytracer_tpu/models/elements.py; the values
are the same published ones (Jmol CPK colours, Bondi van der Waals radii,
Cordero covalent radii).
"""

from __future__ import annotations

import numpy as np

ELEMENT_COLORS: dict[str, tuple[float, float, float]] = {
    "H":  (1.000, 1.000, 1.000),
    "C":  (0.565, 0.565, 0.565),
    "N":  (0.188, 0.314, 0.973),
    "O":  (1.000, 0.051, 0.051),
    "F":  (0.565, 0.878, 0.314),
    "Cl": (0.122, 0.941, 0.122),
    "Br": (0.651, 0.161, 0.161),
    "I":  (0.580, 0.000, 0.580),
    "S":  (1.000, 0.784, 0.196),
    "P":  (1.000, 0.502, 0.000),
    "Fe": (0.878, 0.400, 0.200),
    "Zn": (0.490, 0.502, 0.690),
    "Cu": (0.784, 0.502, 0.200),
    "Mg": (0.541, 1.000, 0.000),
    "Ca": (0.239, 1.000, 0.000),
    "Na": (0.671, 0.361, 0.949),
    "K":  (0.561, 0.251, 0.831),
}
DEFAULT_COLOR: tuple[float, float, float] = (0.800, 0.400, 0.800)

ELEMENT_RADII: dict[str, float] = {
    "H": 1.20, "C": 1.70, "N": 1.55, "O": 1.52, "F": 1.47,
    "Cl": 1.75, "Br": 1.85, "I": 1.98, "S": 1.80, "P": 1.80,
    "Fe": 1.80, "Zn": 1.39, "Cu": 1.40, "Mg": 1.73, "Ca": 2.31,
    "Na": 2.27, "K": 2.75,
}
DEFAULT_RADIUS: float = 1.70

COVALENT_RADII: dict[str, float] = {
    "H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66, "S": 1.05, "P": 1.07,
    "F": 0.57, "Cl": 1.02, "Br": 1.20, "I": 1.39, "Fe": 1.32, "Zn": 1.22,
    "Ca": 1.76, "Mg": 1.41, "Na": 1.66, "K": 2.03,
}
DEFAULT_COVALENT_RADIUS: float = 0.80

BOND_RADIUS: float = 0.15
BOND_COLOR: tuple[float, float, float] = (0.9, 0.9, 0.9)


def element_colors_array(elements: list[str]) -> np.ndarray:
    """Colour lookup -> f32[N,3]."""
    return np.array([ELEMENT_COLORS.get(e, DEFAULT_COLOR) for e in elements],
                    dtype=np.float32).reshape(-1, 3)


def element_radii_array(elements: list[str]) -> np.ndarray:
    """Van der Waals radius lookup -> f32[N]."""
    return np.array([ELEMENT_RADII.get(e, DEFAULT_RADIUS) for e in elements],
                    dtype=np.float32)


def covalent_radii_array(elements: list[str]) -> np.ndarray:
    """Covalent radius lookup -> f32[N]."""
    return np.array([COVALENT_RADII.get(e, DEFAULT_COVALENT_RADIUS) for e in elements],
                    dtype=np.float32)
