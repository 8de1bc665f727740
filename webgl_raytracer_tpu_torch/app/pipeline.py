"""Scene-loading pipelines: the headless counterpart of the reference
viewer's application layer (main.js loadMolecularGeometry :603-865,
loadTestPrimitives :236-339, loadRandomSpheres :348-460, display-style
option table :496-514).

The port's own copy of webgl_raytracer_tpu/app/pipeline.py. It ties the
generators together (display style -> sphere/cylinder geometry, cartoon
mesh with HETATM ball-and-stick, SES surface with its surface-atom modes,
sheet H-bond cylinders, nitrogen density volume) and compiles the result
into SceneBuffers on `device` (None: cuda:0, raising without a GPU). The
volume stays a host DensityVolume; DensityVolume.to_device_buffers puts it
on the device for the Renderer.

With the recorder on (utils/telemetry.py) the molecule's geometry is the
host span scene.molecule (as its parse is, models/molecular.py) and the
SES build the host span scene.ses, beside scene.compile.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..models import molecule_to_geometry, split_by_hetatm
from ..models.cartoon import build_backbone_cartoon, build_sheet_hbond_cylinders
from ..models.density import DensityVolume, build_nitrogen_density_volume
from ..models.elements import element_radii_array
from ..models.mesh import TriangleMesh, merge_meshes
from ..models.molecular import Geometry, MolData
from ..models.surface import compute_ses, ses_to_mesh
from ..scene.compile import SceneBuffers, compile_scene
from ..utils import telemetry

DISPLAY_STYLES = ("ball-and-stick", "vdw", "stick", "cartoon")

SES_COLOR = (0.7, 0.75, 0.9)


def get_display_options(style: str = "ball-and-stick", atom_scale: float = 1.0,
                        bond_radius: float = 0.12) -> dict:
    """Style -> geometry conversion options (main.js:496-514)."""
    if style == "vdw":
        return dict(display_style=style, radius_scale=1.0, bond_radius=0.0, show_bonds=False)
    if style == "cartoon":
        return dict(display_style=style, radius_scale=0.0, bond_radius=0.0, show_bonds=False)
    if style == "stick":
        return dict(display_style=style, radius_scale=0.15, bond_radius=bond_radius,
                    show_bonds=True)
    return dict(display_style="ball-and-stick", radius_scale=atom_scale,
                bond_radius=bond_radius, show_bonds=True)


@dataclass
class LoadedScene:
    scene: SceneBuffers
    mesh: TriangleMesh
    geometry: Geometry
    volume: Optional[DensityVolume] = None
    stats: dict = field(default_factory=dict)


def _concat_geometry(a: Geometry, b_p1, b_p2, b_r, b_c) -> Geometry:
    """Append extra cylinders (debug H-bonds) to a geometry."""
    return Geometry(
        a.sphere_centers, a.sphere_radii, a.sphere_colors,
        np.concatenate([a.cyl_p1, b_p1]) if b_p1.size else a.cyl_p1,
        np.concatenate([a.cyl_p2, b_p2]) if b_p2.size else a.cyl_p2,
        np.concatenate([a.cyl_radii, b_r]) if b_r.size else a.cyl_radii,
        np.concatenate([a.cyl_colors, b_c]) if b_c.size else a.cyl_colors,
    )


def load_molecule_scene(
    mol: MolData,
    display_style: str = "ball-and-stick",
    atom_scale: float = 1.0,
    bond_radius: float = 0.12,
    show_surface: bool = False,
    probe_radius: float = 1.4,
    surface_resolution: float = 0.25,
    smooth_normals: bool = False,
    surface_atom_mode: str = "hetero",
    volume_enabled: bool = False,
    volume_options: dict | None = None,
    show_sheet_hbonds: bool = False,
    logger=None,
    cluster_size: int = 128,
    device=None,
) -> LoadedScene:
    """Molecular scene build (main.js loadMolecularGeometry):

    * ball-and-stick / vdw / stick -> atom spheres + bond cylinders;
    * cartoon -> backbone mesh; HETATM atoms stay ball-and-stick;
    * show_surface -> SES over the non-HETATM atoms (merged with the
      cartoon, or replacing the atom geometry unless surface_atom_mode ==
      'all'); device is also where WRT_DEVICE_MC=1 runs marching cubes;
    * show_sheet_hbonds -> the sheet H-bonds as thin cylinders;
    * volume_enabled -> the nitrogen Gaussian density grid (LoadedScene.volume)."""
    log = logger.info if logger else (lambda *_: None)
    opts = get_display_options(display_style, atom_scale, bond_radius)
    with telemetry.host_span("scene.molecule"):
        geometry = molecule_to_geometry(
            mol, radius_scale=opts["radius_scale"], bond_radius=opts["bond_radius"],
            show_bonds=opts["show_bonds"],
        )

        std, het = split_by_hetatm(mol)
        hetero_opts = (dict(radius_scale=0.4, bond_radius=0.12, show_bonds=True)
                       if display_style == "cartoon"
                       else dict(radius_scale=opts["radius_scale"],
                                 bond_radius=opts["bond_radius"],
                                 show_bonds=opts["show_bonds"]))
        hetero_geometry = molecule_to_geometry(het, **hetero_opts)

    display_geometry = geometry
    mesh = TriangleMesh()
    stats: dict = {}

    if display_style == "cartoon":
        log("Computing backbone cartoon (DSSP)...")
        mesh = build_backbone_cartoon(mol)
        stats["cartoon_triangles"] = mesh.num_triangles
        log(f"Cartoon built: {mesh.num_triangles} triangles")
        display_geometry = hetero_geometry

    if show_surface and mol.num_atoms > 0:
        surface_mol = std if std.num_atoms > 0 else None
        if surface_mol is None:
            if logger:
                logger.warn("No non-HETATM atoms available for surface; rendering atoms only.")
        else:
            log(f"Computing SES surface (probe={probe_radius}A, "
                f"resolution={surface_resolution}A)...")
            radii = element_radii_array(surface_mol.elements)
            with telemetry.host_span("scene.ses"):
                v, n, idx = compute_ses(
                    surface_mol.positions, radii, probe_radius=probe_radius,
                    resolution=surface_resolution, smooth_normals=smooth_normals,
                    device=device,
                )
            stats["ses_triangles"] = int(idx.shape[0])
            log(f"SES completed: {idx.shape[0]} triangles")
            if idx.shape[0] > 0:
                surface_mesh = ses_to_mesh(v, n, idx, SES_COLOR)
                if display_style == "cartoon":
                    mesh = merge_meshes(mesh, surface_mesh)
                else:
                    mesh = surface_mesh
                if surface_atom_mode == "all":
                    display_geometry = geometry
                else:
                    display_geometry = hetero_geometry
            elif logger:
                logger.warn("SES computation produced no surface")

    if show_sheet_hbonds:
        p1, p2, radii, colors = build_sheet_hbond_cylinders(mol)
        if p1.shape[0]:
            display_geometry = _concat_geometry(display_geometry, p1, p2, radii, colors)
            log(f"Debug: {p1.shape[0]} sheet H-bonds")

    volume = None
    if volume_enabled:
        volume = build_nitrogen_density_volume(mol, **(volume_options or {}))
        log(f"Volume: {volume.dims} voxels from {volume.nitrogen_count} N atoms")

    log(f"Loading {display_geometry.num_spheres} atoms, "
        f"{display_geometry.num_cylinders} bonds, {mesh.num_triangles} triangles")

    scene = compile_scene(
        display_geometry,
        tri_verts=mesh.tri_verts() if mesh.num_triangles else None,
        tri_normals=mesh.tri_vertex_normals() if mesh.num_triangles else None,
        tri_colors=mesh.tri_colors if mesh.num_triangles else None,
        tri_flags=mesh.tri_flags if mesh.num_triangles else None,
        cluster_size=cluster_size,
        device=device,
    )
    stats.update(
        spheres=display_geometry.num_spheres,
        cylinders=display_geometry.num_cylinders,
        triangles=mesh.num_triangles,
        clusters=scene.num_clusters,
    )
    return LoadedScene(scene=scene, mesh=mesh, geometry=display_geometry,
                       volume=volume, stats=stats)


def load_test_primitives(cluster_size: int = 128, device=None) -> LoadedScene:
    """The debug scene: 5 coloured spheres + 4 bond cylinders
    (main.js:236-339)."""
    spheres = np.array([
        [0, 0, 0], [1.2, 0, 0], [-1.2, 0, 0], [0, 1.2, 0], [0, -1.2, 0],
    ], np.float32)
    radii = np.array([0.5, 0.35, 0.35, 0.35, 0.35], np.float32)
    colors = np.array([
        [1.0, 0.2, 0.2], [0.2, 0.2, 1.0], [0.2, 1.0, 0.2],
        [1.0, 1.0, 0.2], [1.0, 0.5, 0.0],
    ], np.float32)
    p1 = np.array([[0.5, 0, 0], [-0.5, 0, 0], [0, 0.5, 0], [0, -0.5, 0]], np.float32)
    p2 = np.array([[0.85, 0, 0], [-0.85, 0, 0], [0, 0.85, 0], [0, -0.85, 0]], np.float32)
    cr = np.full(4, 0.1, np.float32)
    cc = np.full((4, 3), 0.8, np.float32)
    geometry = Geometry(spheres, radii, colors, p1, p2, cr, cc)
    scene = compile_scene(geometry, cluster_size=cluster_size, device=device)
    return LoadedScene(scene=scene, mesh=TriangleMesh(), geometry=geometry,
                       stats=dict(spheres=5, cylinders=4))


def mulberry32(seed: int):
    """The reference viewer's seeded PRNG (main.js:352-358), for
    bit-identical random-sphere scaling scenes."""
    state = seed & 0xFFFFFFFF

    def rand():
        nonlocal state
        state = (state + 0x6D2B79F5) & 0xFFFFFFFF
        t = state
        t = (t ^ (t >> 15)) * (1 | t) & 0xFFFFFFFF
        t = (t + ((t ^ (t >> 7)) * (61 | t) & 0xFFFFFFFF)) ^ t
        t &= 0xFFFFFFFF
        return ((t ^ (t >> 14)) & 0xFFFFFFFF) / 4294967296

    return rand


def _hsl_to_rgb(h, s, l):  # noqa: E741
    if s == 0:
        return (l, l, l)

    def hue2rgb(p, q, t):
        if t < 0:
            t += 1
        if t > 1:
            t -= 1
        if t < 1 / 6:
            return p + (q - p) * 6 * t
        if t < 1 / 2:
            return q
        if t < 2 / 3:
            return p + (q - p) * (2 / 3 - t) * 6
        return p

    q = l * (1 + s) if l < 0.5 else l + s - l * s
    p = 2 * l - q
    return (hue2rgb(p, q, h + 1 / 3), hue2rgb(p, q, h), hue2rgb(p, q, h - 1 / 3))


def load_random_spheres(count: int, cluster_size: int = 128, device=None) -> LoadedScene:
    """The reference viewer's scaling scene: `count` random spheres in a
    cube, mulberry32 seed 12345 (main.js:348-460). Not bench.py's scene,
    which draws from numpy's generator (scene.random_sphere_geometry)."""
    rand = mulberry32(12345)
    cube = count ** (1 / 3) * 2
    centers = np.zeros((count, 3), np.float32)
    radii = np.zeros(count, np.float32)
    colors = np.zeros((count, 3), np.float32)
    for i in range(count):
        centers[i] = [(rand() - 0.5) * cube, (rand() - 0.5) * cube, (rand() - 0.5) * cube]
        radii[i] = 0.15 + rand() * 0.25
        hue = rand()
        sat = 0.6 + rand() * 0.4
        light = 0.4 + rand() * 0.3
        colors[i] = _hsl_to_rgb(hue, sat, light)
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    geometry = Geometry(centers, radii, colors, z3, z3, z1, z3)
    scene = compile_scene(geometry, cluster_size=cluster_size, device=device)
    return LoadedScene(scene=scene, mesh=TriangleMesh(), geometry=geometry,
                       stats=dict(spheres=count))
