"""Unified binned-SAH BVH over triangles + spheres + cylinders (host numpy).

Counterpart of webgl_raytracer_tpu/scene/bvh.py: 8 SAH bins, per-type
primitive bounds (cylinder AABB from its axis plus 1e-3 padding), a 3-axis
SAH sweep, a median-split fallback when a split leaves a side empty, and a
preorder flat layout. The native C++ builder is the port's own copy of
the JAX package's (csrc/bvh_builder.cpp, built by scene/native.py); the
numpy builder below is the same fallback, so both packages produce
identical prim_order / node tables from identical inputs.
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass

import numpy as np

from .native import load_bvh_builder

PRIM_TRIANGLE = 0
PRIM_SPHERE = 1
PRIM_CYLINDER = 2

BIN_COUNT = 8
DEFAULT_MAX_LEAF = 4
DEFAULT_MAX_DEPTH = 32


@dataclass
class BVH:
    """Built BVH with flat arrays.

    node_bmin/node_bmax: f32[Nn,3]
    node_meta: i32[Nn,3] — (leftFirst, primCount, rightChild).
        leaf:  (offset into prim_encoded, count, -1)
        inner: (left child node index, 0, right child node index)
    prim_encoded: i32[Np] — (type << 30) | local index, in leaf order.
    prim_order:   i64[Np] — global primitive id (tri, sph, cyl order).
    """

    node_bmin: np.ndarray
    node_bmax: np.ndarray
    node_meta: np.ndarray
    prim_encoded: np.ndarray
    prim_order: np.ndarray
    tri_count: int
    sphere_count: int
    cylinder_count: int

    @property
    def node_count(self) -> int:
        return int(self.node_bmin.shape[0])

    @property
    def prim_count(self) -> int:
        return int(self.prim_encoded.shape[0])


def primitive_bounds(tri_verts, sphere_centers, sphere_radii, cyl_p1, cyl_p2,
                     cyl_radii):
    """Per-primitive AABBs + centroids, ordered triangles, spheres,
    cylinders: (bmin f32[N,3], bmax f32[N,3], centroid f32[N,3])."""
    parts_min, parts_max, parts_c = [], [], []

    if tri_verts.size:
        v = tri_verts.reshape(-1, 3, 3).astype(np.float64)
        parts_min.append(v.min(axis=1))
        parts_max.append(v.max(axis=1))
        parts_c.append(v.mean(axis=1))

    if sphere_centers.size:
        c = sphere_centers.astype(np.float64)
        r = sphere_radii.astype(np.float64)[:, None]
        parts_min.append(c - r)
        parts_max.append(c + r)
        parts_c.append(c)

    if cyl_p1.size:
        p1 = cyl_p1.astype(np.float64)
        p2 = cyl_p2.astype(np.float64)
        r = cyl_radii.astype(np.float64)[:, None]
        d = p2 - p1
        h = np.linalg.norm(d, axis=1, keepdims=True)
        axis = np.where(h > 0, d / np.where(h > 0, h, 1.0),
                        np.array([0.0, 1.0, 0.0]))
        extent = r * np.sqrt(np.clip(1.0 - axis * axis, 0.0, 1.0))
        pad = 0.001
        parts_min.append(np.minimum(p1, p2) - extent - pad)
        parts_max.append(np.maximum(p1, p2) + extent + pad)
        parts_c.append(0.5 * (p1 + p2))

    if not parts_min:
        z = np.zeros((0, 3), np.float32)
        return z, z.copy(), z.copy()

    bmin = np.concatenate(parts_min).astype(np.float32)
    bmax = np.concatenate(parts_max).astype(np.float32)
    cent = np.concatenate(parts_c).astype(np.float32)
    return bmin, bmax, cent


def _sah_split(idx, bmin, bmax, cent):
    """One binned-SAH split attempt over all 3 axes: (left, right) index
    arrays, or None when the centroids are degenerate. Falls back to a
    median split when the chosen plane leaves a side empty."""
    c = cent[idx]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)

    best_cost = np.inf
    best_axis = -1
    best_bin = -1

    pb_min = bmin[idx]
    pb_max = bmax[idx]

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

    for axis in range(3):
        span = cmax[axis] - cmin[axis]
        if span <= 0:
            continue
        scale = BIN_COUNT / span
        bins = np.clip(((c[:, axis] - cmin[axis]) * scale).astype(np.int64),
                       0, BIN_COUNT - 1)

        counts = np.bincount(bins, minlength=BIN_COUNT)
        bb_min = np.full((BIN_COUNT, 3), np.inf, np.float64)
        bb_max = np.full((BIN_COUNT, 3), -np.inf, np.float64)
        np.minimum.at(bb_min, bins, pb_min)
        np.maximum.at(bb_max, bins, pb_max)

        lmin = np.minimum.accumulate(bb_min, axis=0)
        lmax = np.maximum.accumulate(bb_max, axis=0)
        rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = np.cumsum(counts[::-1])[::-1]

        lc = lcount[:-1]
        rc = rcount[1:]
        cost = area(lmin[:-1], lmax[:-1]) * lc + area(rmin[1:], rmax[1:]) * rc
        cost = np.where((lc == 0) | (rc == 0), np.inf, cost)
        i = int(np.argmin(cost))
        if cost[i] < best_cost:
            best_cost = cost[i]
            best_axis = axis
            best_bin = i

    if best_axis == -1:
        return None

    split_pos = cmin[best_axis] + ((best_bin + 1) / BIN_COUNT) * (
        cmax[best_axis] - cmin[best_axis])
    go_left = c[:, best_axis] < split_pos
    left = idx[go_left]
    right = idx[~go_left]
    if left.size == 0 or right.size == 0:
        half = idx.size // 2
        left, right = idx[:half], idx[half:]
    return left, right


def _build_native(bmin, bmax, cent, n, max_leaf_size, max_depth):
    """Build with the shared C++ builder; None when it is unavailable."""
    lib = load_bvh_builder()
    if lib is None:
        return None
    cap = 2 * n
    bmin32 = np.ascontiguousarray(bmin, np.float32)
    bmax32 = np.ascontiguousarray(bmax, np.float32)
    cent32 = np.ascontiguousarray(cent, np.float32)
    node_bmin = np.empty((cap, 3), np.float32)
    node_bmax = np.empty((cap, 3), np.float32)
    node_meta = np.empty((cap, 3), np.int32)
    prim_order = np.empty(n, np.int64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    count = lib.wrt_build_bvh(
        ptr(bmin32, ctypes.c_float), ptr(bmax32, ctypes.c_float),
        ptr(cent32, ctypes.c_float), n, max_leaf_size, max_depth,
        ptr(node_bmin, ctypes.c_float), ptr(node_bmax, ctypes.c_float),
        ptr(node_meta, ctypes.c_int), ptr(prim_order, ctypes.c_longlong),
    )
    if count <= 0:
        return None
    return (node_bmin[:count].copy(), node_bmax[:count].copy(),
            node_meta[:count].copy(), prim_order)


def build_bvh(tri_verts=None, sphere_centers=None, sphere_radii=None,
              cyl_p1=None, cyl_p2=None, cyl_radii=None,
              max_leaf_size: int = DEFAULT_MAX_LEAF,
              max_depth: int = DEFAULT_MAX_DEPTH,
              backend: str = "auto") -> BVH:
    """Build the unified BVH and flatten it in preorder (root = 0)."""
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    tri_verts = z3.reshape(0, 3) if tri_verts is None else np.asarray(tri_verts, np.float32)
    sphere_centers = z3 if sphere_centers is None else np.asarray(sphere_centers, np.float32)
    sphere_radii = z1 if sphere_radii is None else np.asarray(sphere_radii, np.float32)
    cyl_p1 = z3 if cyl_p1 is None else np.asarray(cyl_p1, np.float32)
    cyl_p2 = z3 if cyl_p2 is None else np.asarray(cyl_p2, np.float32)
    cyl_radii = z1 if cyl_radii is None else np.asarray(cyl_radii, np.float32)

    tri_count = int(tri_verts.reshape(-1, 3, 3).shape[0]) if tri_verts.size else 0
    sphere_count = int(sphere_centers.shape[0])
    cylinder_count = int(cyl_p1.shape[0])
    n = tri_count + sphere_count + cylinder_count

    if n == 0:
        return BVH(
            node_bmin=np.zeros((1, 3), np.float32),
            node_bmax=np.zeros((1, 3), np.float32),
            node_meta=np.array([[0, 0, -1]], np.int32),
            prim_encoded=np.zeros(0, np.int32),
            prim_order=np.zeros(0, np.int64),
            tri_count=0, sphere_count=0, cylinder_count=0,
        )

    bmin, bmax, cent = primitive_bounds(
        tri_verts, sphere_centers, sphere_radii, cyl_p1, cyl_p2, cyl_radii)
    bmin64 = bmin.astype(np.float64)
    bmax64 = bmax.astype(np.float64)

    types = np.concatenate([
        np.full(tri_count, PRIM_TRIANGLE, np.int64),
        np.full(sphere_count, PRIM_SPHERE, np.int64),
        np.full(cylinder_count, PRIM_CYLINDER, np.int64),
    ])
    locals_ = np.concatenate([
        np.arange(tri_count, dtype=np.int64),
        np.arange(sphere_count, dtype=np.int64),
        np.arange(cylinder_count, dtype=np.int64),
    ])
    encoded_all = ((types << 30) | (locals_ & 0x3FFFFFFF)).astype(np.int64)

    if backend in ("auto", "native"):
        native = _build_native(bmin, bmax, cent, n, max_leaf_size, max_depth)
        if native is not None:
            node_bmin_n, node_bmax_n, node_meta_n, prim_order = native
            return BVH(
                node_bmin=node_bmin_n, node_bmax=node_bmax_n,
                node_meta=node_meta_n,
                prim_encoded=encoded_all[prim_order].astype(np.int32),
                prim_order=prim_order,
                tri_count=tri_count, sphere_count=sphere_count,
                cylinder_count=cylinder_count,
            )
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable (no compiler?)")

    nodes_bmin: list[np.ndarray] = []
    nodes_bmax: list[np.ndarray] = []
    nodes_meta: list[list[int]] = []
    leaf_prims: list[np.ndarray] = []
    leaf_offset = 0
    sys.setrecursionlimit(10000)
    cent64 = cent.astype(np.float64)

    def emit_node(idx: np.ndarray, depth: int) -> int:
        nonlocal leaf_offset
        node_id = len(nodes_meta)
        nodes_bmin.append(bmin64[idx].min(axis=0))
        nodes_bmax.append(bmax64[idx].max(axis=0))
        nodes_meta.append([0, 0, -1])

        split = None
        if idx.size > max_leaf_size and depth < max_depth:
            split = _sah_split(idx, bmin64, bmax64, cent64)
        if split is None:
            nodes_meta[node_id][0] = leaf_offset
            nodes_meta[node_id][1] = int(idx.size)
            leaf_prims.append(idx)
            leaf_offset += int(idx.size)
            return node_id

        left_idx, right_idx = split
        left_child = emit_node(left_idx, depth + 1)
        right_child = emit_node(right_idx, depth + 1)
        nodes_meta[node_id][0] = left_child
        nodes_meta[node_id][2] = right_child
        return node_id

    emit_node(np.arange(n, dtype=np.int64), 0)

    prim_order = np.concatenate(leaf_prims) if leaf_prims else np.zeros(0, np.int64)
    return BVH(
        node_bmin=np.asarray(nodes_bmin, np.float32),
        node_bmax=np.asarray(nodes_bmax, np.float32),
        node_meta=np.asarray(nodes_meta, np.int32),
        prim_encoded=encoded_all[prim_order].astype(np.int32),
        prim_order=prim_order,
        tri_count=tri_count, sphere_count=sphere_count,
        cylinder_count=cylinder_count,
    )
