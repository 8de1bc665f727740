"""Scene compile: geometry -> the cluster SoA tensors the tracer sweeps.

Counterpart of webgl_raytracer_tpu/scene/compile.py, restricted to what
the cluster tracer and shading read. Primitives are grouped into
type-homogeneous clusters (SAH leaves of up to `cluster_size` prims, one
cluster set per primitive type, concatenated), each padded with type -1
rows. A cluster row is

    [a.xyz, radius | b.xyz, local index | c.xyz, type]

    triangle: v0 | v1 | v2;  sphere: center, radius;  cylinder: p1, radius | p2.

Beside the rows, `cluster_attr` f32[K,C,16] holds each slot's shading
attributes (build_attr_soa): colour rgb (0-2), the triangle's vertex
normals n0/n1/n2 (3-11) and its flag (12). The attrs kernel
(ops/trace.trace_closest_attrs) returns the winner's row of it.

Picking and the hover overlay (scene/pick.py, scene/overlay.py) read
`SceneBuffers.pick_tables`: host tables in world coordinates, as the JAX
package's SceneBuffers holds them — the unified leaf-4 BVH
(node_bmin/bmax/meta), the leaf-ordered primitive table (prim_a/b/c,
prim_type, prim_local, prim_color) and the per-type tables (tri_verts,
sphere_centers/radii, cyl_p1/p2/radii). compile_scene does not build
them: the first pick, hover or read of the tables builds them once, for
the scene and every .to() copy of it. They stay numpy arrays on the host
whatever the scene's device. The stack tracer (ops/traversal.py) walks
the BVH and the primitive table on the scene's device:
`SceneBuffers.walk_tables`, copied from the host tables on the first
stack trace and kept with the scene, as trace_operands is, with the
kernel's packed node table built from them on the device.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, fields
from functools import cache, cached_property, partial
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models import Geometry
from .bvh import DEFAULT_MAX_DEPTH, PRIM_CYLINDER, PRIM_SPHERE, PRIM_TRIANGLE, build_bvh

# Tensor fields of SceneBuffers (the rest are python ints).
TENSOR_FIELDS = ("cluster_prims", "cluster_soa", "cluster_color",
                 "cluster_bmin", "cluster_bmax", "cluster_attr", "tri_normals",
                 "tri_flags")
# PickTables' numpy fields (world coordinates) and their dtypes.
HOST_FIELDS = {"node_bmin": np.float32, "node_bmax": np.float32, "node_meta": np.int32,
               "prim_a": np.float32, "prim_b": np.float32, "prim_c": np.float32,
               "prim_type": np.int32, "prim_local": np.int32, "prim_color": np.float32,
               "tri_verts": np.float32, "sphere_centers": np.float32,
               "sphere_radii": np.float32, "cyl_p1": np.float32, "cyl_p2": np.float32,
               "cyl_radii": np.float32}
COUNT_FIELDS = ("tri_count", "sphere_count", "cylinder_count",
                "num_clusters", "cluster_size")


@dataclass
class PickTables:
    """The BVH and primitive tables of picking and the overlay: host numpy
    arrays in world coordinates."""

    node_bmin: np.ndarray           # f32[Nn,3] unified leaf-4 BVH
    node_bmax: np.ndarray           # f32[Nn,3]
    node_meta: np.ndarray           # i32[Nn,3] (leftFirst, primCount, rightChild)
    prim_a: np.ndarray              # f32[Np,4] leaf-ordered primitive rows
    prim_b: np.ndarray              # f32[Np,4]
    prim_c: np.ndarray              # f32[Np,4]
    prim_type: np.ndarray           # i32[Np]
    prim_local: np.ndarray          # i32[Np] per-type index
    prim_color: np.ndarray          # f32[Np,3] base colour
    tri_verts: np.ndarray           # f32[max(Nt,1),3,3]
    sphere_centers: np.ndarray      # f32[max(Ns,1),3]
    sphere_radii: np.ndarray        # f32[max(Ns,1)]
    cyl_p1: np.ndarray              # f32[max(Nc,1),3]
    cyl_p2: np.ndarray              # f32[max(Nc,1),3]
    cyl_radii: np.ndarray           # f32[max(Nc,1)]

    @property
    def node_count(self) -> int:
        return int(self.node_bmin.shape[0])


# The walk's tables (WalkTables' fields), copied from PickTables.
WALK_FIELDS = ("node_bmin", "node_bmax", "node_meta", "prim_a", "prim_b", "prim_c",
               "prim_type", "prim_local", "prim_color")


@dataclass
class WalkTables:
    """The stack walk's tables on the scene's device, in world
    coordinates: PickTables' BVH and leaf-ordered primitive table."""

    node_bmin: torch.Tensor         # f32[Nn,3]
    node_bmax: torch.Tensor         # f32[Nn,3]
    node_meta: torch.Tensor         # i32[Nn,3] (leftFirst, primCount, rightChild)
    prim_a: torch.Tensor            # f32[Np,4]
    prim_b: torch.Tensor            # f32[Np,4]
    prim_c: torch.Tensor            # f32[Np,4]
    prim_type: torch.Tensor         # i32[Np]
    prim_local: torch.Tensor        # i32[Np]
    prim_color: torch.Tensor        # f32[Np,3]
    nodes: torch.Tensor             # f32[Nn,8] the kernel's nodes (ops/traversal.pack_nodes)


@dataclass
class SceneBuffers:
    """Cluster layout + shading side tables, as tensors on `device`; the
    tables of picking on the host, built on first use."""

    cluster_prims: torch.Tensor     # f32[K,C,12]
    cluster_soa: torch.Tensor       # f32[K,12,C] (SoA transpose)
    cluster_color: torch.Tensor     # f32[K*C,3]
    cluster_bmin: torch.Tensor      # f32[K,3]
    cluster_bmax: torch.Tensor      # f32[K,3]
    cluster_attr: torch.Tensor      # f32[K,C,16] shading attributes per slot
    tri_normals: torch.Tensor       # f32[max(Nt,1),3,3] per-vertex normals
    tri_flags: torch.Tensor         # f32[max(Nt,1)]
    tri_count: int
    sphere_count: int
    cylinder_count: int
    num_clusters: int
    cluster_size: int
    device: torch.device
    # Returns the PickTables, building them on its first call only.
    pick_source: Callable[[], PickTables] = field(repr=False, compare=False)

    def to(self, device) -> "SceneBuffers":
        """The scene with its tensors on `device`; the copy shares the
        host tables (built or not) with this scene."""
        device = torch.device(device)
        moved = {name: getattr(self, name).to(device) for name in TENSOR_FIELDS}
        counts = {name: getattr(self, name) for name in COUNT_FIELDS}
        return SceneBuffers(**moved, **counts, device=device, pick_source=self.pick_source)

    @property
    def pick_tables(self) -> PickTables:
        return self.pick_source()

    @property
    def prim_count(self) -> int:
        return self.tri_count + self.sphere_count + self.cylinder_count

    @cached_property
    def trace_operands(self):
        """Scene-centred kernel operands (ops/trace.scene_operands), built
        once per scene instead of once per trace."""
        from ..ops.trace import scene_operands

        return scene_operands(self)

    @cached_property
    def walk_tables(self) -> WalkTables:
        """The stack walk's tables on this scene's device, copied from the
        host tables once per scene, and the kernel's packed nodes built
        from them there (ops/traversal.py)."""
        from ..ops.traversal import check_links, pack_nodes

        tables = self.pick_tables
        check_links(tables.node_meta)
        rows = {name: torch.tensor(getattr(tables, name), device=self.device)
                for name in WALK_FIELDS}
        return WalkTables(**rows, nodes=pack_nodes(rows["node_bmin"], rows["node_bmax"],
                                                   rows["node_meta"]))


def scene_from_numpy(fields_: dict, device=None) -> SceneBuffers:
    """SceneBuffers from the JAX package's SceneBuffers fields as numpy
    arrays (what its compile_scene returns before device_put) — carries an
    identical scene into the port, the host tables of picking included.
    The fields of a port scene (numpy_fields) carry its tables' source
    instead. Fields this package does not use are ignored. device None
    means cuda:0."""
    if "pick_source" in fields_:
        return _scene(fields_, device, fields_["pick_source"])
    if int(fields_.get("max_depth", DEFAULT_MAX_DEPTH)) != DEFAULT_MAX_DEPTH:
        raise ValueError(f"the port's stack walk takes BVHs of depth at most "
                         f"{DEFAULT_MAX_DEPTH}, not {fields_['max_depth']}")
    tables = PickTables(**{name: np.asarray(fields_[name], dtype)
                           for name, dtype in HOST_FIELDS.items()})
    return _scene(fields_, device, lambda: tables)


def _scene(fields_: dict, device, pick_source) -> SceneBuffers:
    device = resolve_device(device)
    tensors = {name: torch.tensor(np.asarray(fields_[name], np.float32),
                                  device=device)
               for name in TENSOR_FIELDS}
    counts = {name: int(fields_[name]) for name in COUNT_FIELDS}
    return SceneBuffers(**tensors, **counts, device=device, pick_source=pick_source)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] >= n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def compile_scene(geometry: Geometry | None = None, tri_verts=None,
                  tri_normals=None, tri_colors=None, tri_flags=None,
                  cluster_size: int = 128, device=None) -> SceneBuffers:
    """Spheres/cylinders (from Geometry) + an optional triangle mesh ->
    SceneBuffers on `device` (None: cuda:0; raises without a GPU).
    tri_verts f32[Nt,3,3]; tri_normals f32[Nt,3,3] (per-vertex, default
    face normals); tri_colors f32[Nt,3]; tri_flags f32[Nt]."""
    device = resolve_device(device)
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    if geometry is None:
        geometry = Geometry(z3, z1, z3, z3, z3, z1, z3)

    tv = (np.zeros((0, 3, 3), np.float32) if tri_verts is None
          else np.asarray(tri_verts, np.float32).reshape(-1, 3, 3))
    nt = tv.shape[0]
    if tri_normals is None:
        if nt:
            fn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
            norm = np.linalg.norm(fn, axis=1, keepdims=True)
            fn = fn / np.where(norm > 0, norm, 1.0)
            tn = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
        else:
            tn = np.zeros((0, 3, 3), np.float32)
    else:
        tn = np.asarray(tri_normals, np.float32).reshape(-1, 3, 3)
    tc = (np.full((nt, 3), 0.8, np.float32) if tri_colors is None
          else np.asarray(tri_colors, np.float32).reshape(-1, 3))
    tf = (np.zeros(nt, np.float32) if tri_flags is None
          else np.asarray(tri_flags, np.float32).reshape(-1))

    prims, colors, bmin, bmax = _build_clusters(
        geometry, tv, tc, cluster_size, nt, geometry.num_spheres)
    fields_ = dict(
        cluster_prims=prims,
        cluster_soa=np.ascontiguousarray(prims.transpose(0, 2, 1)),
        cluster_color=colors,
        cluster_bmin=bmin,
        cluster_bmax=bmax,
        cluster_attr=build_attr_soa(prims, colors, tn, tf),
        tri_normals=_pad_rows(tn, 1),
        tri_flags=_pad_rows(tf, 1),
        tri_count=nt,
        sphere_count=geometry.num_spheres,
        cylinder_count=geometry.num_cylinders,
        num_clusters=prims.shape[0],
        cluster_size=cluster_size,
    )
    # Built on first use, from copies: the caller may reuse its arrays.
    return _scene(fields_, device,
                  cache(partial(_pick_tables, copy.deepcopy(geometry), tv.copy(),
                                tc.copy())))


def _at_least_one(a: np.ndarray) -> np.ndarray:
    return a if a.shape[0] > 0 else _pad_rows(a, 1)


def _pick_tables(geometry: Geometry, tv: np.ndarray, tc: np.ndarray) -> PickTables:
    """The host tables of picking and the stack walk, as the JAX package's
    compile_scene builds them: the unified leaf-4 BVH over all primitives
    (depth at most DEFAULT_MAX_DEPTH, which ops/traversal.STACK_DEPTH is
    sized for), its leaf-ordered primitive table and the per-type tables
    (at least one row each). tc: the triangles' colours."""
    bvh = build_bvh(tri_verts=tv, sphere_centers=geometry.sphere_centers,
                    sphere_radii=geometry.sphere_radii, cyl_p1=geometry.cyl_p1,
                    cyl_p2=geometry.cyl_p2, cyl_radii=geometry.cyl_radii)
    nt, ns = tv.shape[0], geometry.num_spheres
    n = max(1, bvh.prim_count)
    prim_a = np.zeros((n, 4), np.float32)
    prim_b = np.zeros((n, 4), np.float32)
    prim_c = np.zeros((n, 4), np.float32)
    prim_type = np.zeros(n, np.int32)
    prim_local = np.zeros(n, np.int32)
    prim_color = np.zeros((n, 3), np.float32)
    if bvh.prim_count:
        gid = bvh.prim_order
        ptype = np.where(gid < nt, PRIM_TRIANGLE,
                         np.where(gid < nt + ns, PRIM_SPHERE, PRIM_CYLINDER))
        local = np.where(gid < nt, gid, np.where(gid < nt + ns, gid - nt, gid - nt - ns))
        prim_type[:] = ptype
        prim_local[:] = local
        tri, sph, cyl = (ptype == PRIM_TRIANGLE, ptype == PRIM_SPHERE,
                         ptype == PRIM_CYLINDER)
        prim_a[tri, :3] = tv[local[tri], 0]
        prim_b[tri, :3] = tv[local[tri], 1]
        prim_c[tri, :3] = tv[local[tri], 2]
        prim_a[sph, :3] = geometry.sphere_centers[local[sph]]
        prim_a[sph, 3] = geometry.sphere_radii[local[sph]]
        prim_a[cyl, :3] = geometry.cyl_p1[local[cyl]]
        prim_a[cyl, 3] = geometry.cyl_radii[local[cyl]]
        prim_b[cyl, :3] = geometry.cyl_p2[local[cyl]]
        prim_color[tri] = tc[local[tri]]
        prim_color[sph] = geometry.sphere_colors[local[sph]]
        prim_color[cyl] = geometry.cyl_colors[local[cyl]]
    return PickTables(
        node_bmin=bvh.node_bmin, node_bmax=bvh.node_bmax, node_meta=bvh.node_meta,
        prim_a=prim_a, prim_b=prim_b, prim_c=prim_c, prim_type=prim_type,
        prim_local=prim_local, prim_color=prim_color, tri_verts=_at_least_one(tv),
        sphere_centers=_at_least_one(geometry.sphere_centers),
        sphere_radii=_at_least_one(geometry.sphere_radii),
        cyl_p1=_at_least_one(geometry.cyl_p1), cyl_p2=_at_least_one(geometry.cyl_p2),
        cyl_radii=_at_least_one(geometry.cyl_radii))


ATTR_COLS = 16


def build_attr_soa(cluster_prims, cluster_color, tri_normals, tri_flags):
    """f32[K,C,16] shading attributes aligned with cluster_prims [K,C,12]:
    colour rgb (0-2) from cluster_color [K*C,3]; for triangle slots the
    vertex normals n0, n1, n2 (3-11) and the flag (12) of the triangle the
    slot's local index names. The JAX package's
    pallas_trace.build_attr_soa."""
    k, c = cluster_prims.shape[:2]
    attr = np.zeros((k, c, ATTR_COLS), np.float32)
    attr[:, :, 0:3] = np.asarray(cluster_color).reshape(k, c, 3)
    tn = np.asarray(tri_normals, np.float32)
    if tn.shape[0]:
        kk, cc = np.nonzero(cluster_prims[..., 11] == PRIM_TRIANGLE)
        li = np.clip(cluster_prims[kk, cc, 7].astype(np.int32), 0, tn.shape[0] - 1)
        attr[kk, cc, 3:12] = tn[li].reshape(-1, 9)
        attr[kk, cc, 12] = np.asarray(tri_flags, np.float32)[li]
    return attr


def _pack_type_clusters(bvh, c, ptype_code, fill):
    """Pack one type's SAH leaves as [k, c, 12] cluster rows. `fill` writes
    the type's geometry columns given (prims, k_idx, slot_idx, local,
    colors)."""
    leaf_mask = bvh.node_meta[:, 1] > 0
    leaf_meta = bvh.node_meta[leaf_mask]
    k = int(leaf_mask.sum())
    prims = np.zeros((k, c, 12), np.float32)
    prims[..., 11] = -1.0
    colors = np.zeros((k, c, 3), np.float32)
    counts = leaf_meta[:, 1]
    k_idx = np.repeat(np.arange(k), counts)
    slot_idx = (np.concatenate([np.arange(n) for n in counts])
                if k else np.zeros(0, int))
    local = np.concatenate([
        bvh.prim_order[lf:lf + n] for lf, n in zip(leaf_meta[:, 0], counts)
    ]) if k else np.zeros(0, int)
    prims[k_idx, slot_idx, 7] = local.astype(np.float32)
    prims[k_idx, slot_idx, 11] = ptype_code
    fill(prims, k_idx, slot_idx, local, colors)
    return prims, colors, bvh.node_bmin[leaf_mask], bvh.node_bmax[leaf_mask]


def _build_clusters(geometry, tv, tc, cluster_size, nt, ns):
    """Type-homogeneous clusters: (prims f32[K,C,12], colors f32[K*C,3],
    bmin f32[K,3], bmax f32[K,3]). Triangles first, then spheres, then
    cylinders, as in the JAX package."""
    c = cluster_size
    parts = []

    if nt:
        def fill_tri(prims, k_idx, slot_idx, local, colors):
            prims[k_idx, slot_idx, 0:3] = tv[local, 0]
            prims[k_idx, slot_idx, 4:7] = tv[local, 1]
            prims[k_idx, slot_idx, 8:11] = tv[local, 2]
            colors[k_idx, slot_idx] = tc[local]

        parts.append(_pack_type_clusters(
            build_bvh(tri_verts=tv, max_leaf_size=c, max_depth=48),
            c, PRIM_TRIANGLE, fill_tri))
    if ns:
        def fill_sph(prims, k_idx, slot_idx, local, colors):
            prims[k_idx, slot_idx, 0:3] = geometry.sphere_centers[local]
            prims[k_idx, slot_idx, 3] = geometry.sphere_radii[local]
            colors[k_idx, slot_idx] = geometry.sphere_colors[local]

        parts.append(_pack_type_clusters(
            build_bvh(sphere_centers=geometry.sphere_centers,
                      sphere_radii=geometry.sphere_radii,
                      max_leaf_size=c, max_depth=48),
            c, PRIM_SPHERE, fill_sph))
    if geometry.num_cylinders:
        def fill_cyl(prims, k_idx, slot_idx, local, colors):
            prims[k_idx, slot_idx, 0:3] = geometry.cyl_p1[local]
            prims[k_idx, slot_idx, 3] = geometry.cyl_radii[local]
            prims[k_idx, slot_idx, 4:7] = geometry.cyl_p2[local]
            colors[k_idx, slot_idx] = geometry.cyl_colors[local]

        parts.append(_pack_type_clusters(
            build_bvh(cyl_p1=geometry.cyl_p1, cyl_p2=geometry.cyl_p2,
                      cyl_radii=geometry.cyl_radii,
                      max_leaf_size=c, max_depth=48),
            c, PRIM_CYLINDER, fill_cyl))

    if not parts:
        prims = np.zeros((1, c, 12), np.float32)
        prims[..., 11] = -1.0
        return (prims, np.zeros((c, 3), np.float32),
                np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32))

    prims = np.concatenate([p[0] for p in parts])
    colors = np.concatenate([p[1] for p in parts])
    bmin = np.concatenate([p[2] for p in parts])
    bmax = np.concatenate([p[3] for p in parts])
    k = prims.shape[0]
    return prims, colors.reshape(k * c, 3), bmin, bmax


def scene_bounds(scene: SceneBuffers) -> tuple[np.ndarray, np.ndarray]:
    """World AABB of the scene as numpy f32[3] pair. Taken over the
    cluster AABBs, which cover exactly the primitive bounds the JAX
    package's root BVH node covers."""
    lo = scene.cluster_bmin.min(dim=0).values.cpu().numpy()
    hi = scene.cluster_bmax.max(dim=0).values.cpu().numpy()
    return lo, hi


def scene_scale(scene: SceneBuffers) -> float:
    """Half-diagonal of the scene bounds, min 1e-3."""
    lo, hi = scene_bounds(scene)
    return float(max(1e-3, 0.5 * np.linalg.norm(hi - lo)))


def numpy_fields(scene) -> dict:
    """Field dict of any dataclass scene (the JAX SceneBuffers included),
    ready for scene_from_numpy."""
    return {f.name: getattr(scene, f.name) for f in fields(scene)}
