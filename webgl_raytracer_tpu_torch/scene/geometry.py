"""Scene geometry sources: the benchmark's random-sphere scenes and the
bundled molecules (the port's models/ package)."""

from __future__ import annotations

import numpy as np

from ..models import Geometry, get_builtin_molecule, molecule_to_geometry


def random_sphere_geometry(count: int, seed: int = 12345) -> Geometry:
    """`count` random spheres in a cube of side 2*count**(1/3), radii in
    [0.15, 0.4) — bench.py's scaling scenes (seed 12345 there)."""
    rng = np.random.default_rng(seed)
    cube = count ** (1 / 3) * 2
    centers = ((rng.random((count, 3)) - 0.5) * cube).astype(np.float32)
    radii = (0.15 + rng.random(count) * 0.25).astype(np.float32)
    colors = rng.random((count, 3)).astype(np.float32)
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return Geometry(centers, radii, colors, z3, z3, z1, z3)


def molecule_geometry(name: str) -> Geometry:
    """Ball-and-stick geometry of a bundled molecule (e.g. "caffeine")."""
    return molecule_to_geometry(get_builtin_molecule(name))
