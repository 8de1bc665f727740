"""Triangle mesh container + merge (the reference viewer's
scene_controller.js:9-42); the port's own copy of
webgl_raytracer_tpu/models/mesh.py."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TriangleMesh:
    """Indexed triangle mesh with per-vertex normals and per-triangle colors.

    positions: f32[V,3]; normals: f32[V,3]; indices: u32[T,3];
    tri_colors: f32[T,3]; tri_flags: f32[T] (1.0 marks SES-surface
    triangles for the surface-glass material mode).
    """
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint32))
    tri_colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    tri_flags: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.float32))

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])

    def tri_verts(self) -> np.ndarray:
        """De-indexed triangle soup f32[T,3,3] (the scene-compile input)."""
        return self.positions[self.indices.reshape(-1)].reshape(-1, 3, 3)

    def tri_vertex_normals(self) -> np.ndarray:
        """Per-corner vertex normals f32[T,3,3]."""
        return self.normals[self.indices.reshape(-1)].reshape(-1, 3, 3)

    def has_surface_flags(self) -> bool:
        return bool(self.tri_flags.size) and bool((self.tri_flags > 0.5).any())


class MeshBuilder:
    """Append-only builder used by the geometry emitters."""

    def __init__(self):
        self.positions: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self.indices: list[np.ndarray] = []
        self.tri_colors: list[np.ndarray] = []
        self._vertex_count = 0

    @property
    def vertex_count(self) -> int:
        return self._vertex_count

    def add_vertices(self, positions: np.ndarray, normals: np.ndarray) -> int:
        """Returns the base index of the appended block."""
        base = self._vertex_count
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        self.positions.append(positions)
        self.normals.append(np.asarray(normals, np.float32).reshape(-1, 3))
        self._vertex_count += positions.shape[0]
        return base

    def add_triangles(self, indices: np.ndarray, color) -> None:
        indices = np.asarray(indices, np.uint32).reshape(-1, 3)
        self.indices.append(indices)
        self.tri_colors.append(
            np.tile(np.asarray(color, np.float32), (indices.shape[0], 1))
        )

    def build(self) -> TriangleMesh:
        if not self.positions:
            return TriangleMesh()
        indices = (np.concatenate(self.indices) if self.indices
                   else np.zeros((0, 3), np.uint32))
        return TriangleMesh(
            positions=np.concatenate(self.positions),
            normals=np.concatenate(self.normals),
            indices=indices,
            tri_colors=(np.concatenate(self.tri_colors) if self.tri_colors
                        else np.zeros((0, 3), np.float32)),
            tri_flags=np.zeros(indices.shape[0], np.float32),
        )


def merge_meshes(a: TriangleMesh | None, b: TriangleMesh | None) -> TriangleMesh:
    """Concatenate two meshes with index offsetting; flags padded
    (scene_controller.js mergeTriangleMeshes)."""
    if a is None or a.num_vertices == 0:
        return b if b is not None else TriangleMesh()
    if b is None or b.num_vertices == 0:
        return a

    def flags_of(m: TriangleMesh) -> np.ndarray:
        if m.tri_flags.shape[0] == m.num_triangles:
            return m.tri_flags
        return np.zeros(m.num_triangles, np.float32)

    return TriangleMesh(
        positions=np.concatenate([a.positions, b.positions]),
        normals=np.concatenate([a.normals, b.normals]),
        indices=np.concatenate([a.indices, b.indices + np.uint32(a.num_vertices)]),
        tri_colors=np.concatenate([a.tri_colors, b.tri_colors]),
        tri_flags=np.concatenate([flags_of(a), flags_of(b)]),
    )
