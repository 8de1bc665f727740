"""The port's host scene tables, CPU tracer, hover overlay and picking
against the JAX package's.

Everything here is host numpy in world coordinates with the same
operation order on both sides, so it must be equal bit for bit:

  * the tables of picking that the port's scenes build on the host on
    first use (the unified BVH, the leaf-ordered primitive table and the
    per-type tables, scene/compile.HOST_FIELDS) against the JAX
    SceneBuffers, for the debug primitives, the 1000 mulberry32 spheres and
    caffeine, and carried across by scene_from_numpy; .to() shares them,
    and compile_scene itself does not build them;
  * trace_scene_ray and brute_force_closest on seeded rays aimed at the
    primitives, with and without a clip plane (t's bits, type, index and
    extra);
  * the overlay's primitive bounds and projected rects;
  * pick_at_pixel, hover_at_pixel and autofocus_at_pixel through the
    port's Renderer against the JAX Renderer at the same size and camera.
"""

import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.app import pipeline as JP
from webgl_raytracer_tpu.models import get_builtin_molecule, molecule_to_geometry
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import picking as JK
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu.scene import overlay as JO
from webgl_raytracer_tpu.scene import pick as JS
from webgl_raytracer_tpu_torch import models as PM
from webgl_raytracer_tpu_torch.app import pipeline as PP
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import picking as PK
from webgl_raytracer_tpu_torch.scene import compile_scene as p_compile
from webgl_raytracer_tpu_torch.scene import overlay as PO
from webgl_raytracer_tpu_torch.scene import compile as PC
from webgl_raytracer_tpu_torch.scene import pick as PS
from webgl_raytracer_tpu_torch.scene.compile import (COUNT_FIELDS, HOST_FIELDS, numpy_fields,
                                                     scene_from_numpy)

TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)


def _caffeine_tris(pkg):
    if pkg == "jax":
        return j_compile(molecule_to_geometry(get_builtin_molecule("caffeine")),
                         tri_verts=TRIS)
    geo = PM.molecule_to_geometry(PM.get_builtin_molecule("caffeine"))
    return p_compile(geo, tri_verts=TRIS, device="cpu")


SCENES = {
    "primitives": lambda pkg: (JP.load_test_primitives().scene if pkg == "jax"
                               else PP.load_test_primitives(device="cpu").scene),
    "spheres1000": lambda pkg: (JP.load_random_spheres(1000).scene if pkg == "jax"
                                else PP.load_random_spheres(1000, device="cpu").scene),
    "caffeine": lambda pkg: (
        JP.load_molecule_scene(get_builtin_molecule("caffeine")).scene if pkg == "jax"
        else PP.load_molecule_scene(PM.get_builtin_molecule("caffeine"), device="cpu").scene),
    "caffeine+tris": _caffeine_tris,
}
_CACHE = {}


def _scenes(name):
    if name not in _CACHE:
        _CACHE[name] = (SCENES[name]("jax"), SCENES[name]("port"))
    return _CACHE[name]


@pytest.mark.parametrize("name", list(SCENES))
def test_host_tables_equal_jax(name):
    js, ps = _scenes(name)
    for field, dtype in HOST_FIELDS.items():
        a, b = np.asarray(getattr(js, field)), getattr(ps.pick_tables, field)
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype == dtype, field
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), field
    for field in COUNT_FIELDS:
        assert getattr(ps, field) == int(getattr(js, field)), field
    assert (ps.pick_tables.node_count, ps.prim_count) == (js.node_count, js.prim_count)
    carried = scene_from_numpy(numpy_fields(js), device="cpu")
    moved = ps.to("cpu")
    for field in HOST_FIELDS:
        assert np.array_equal(getattr(carried.pick_tables, field),
                              getattr(ps.pick_tables, field)), field
        assert getattr(moved.pick_tables, field) is getattr(ps.pick_tables, field), field
    assert carried.prim_count == moved.prim_count == ps.prim_count


def test_compile_scene_builds_the_host_tables_on_first_use(monkeypatch):
    """compile_scene builds no table of picking; the first read builds them
    once for the scene and its .to() copies, from the geometry as it was
    compiled."""
    built = []
    build = PC._pick_tables
    monkeypatch.setattr(PC, "_pick_tables", lambda *a: built.append(1) or build(*a))
    geo = PM.molecule_to_geometry(PM.get_builtin_molecule("caffeine"))
    ps = p_compile(geo, tri_verts=TRIS.copy(), device="cpu")
    moved = ps.to("cpu")
    assert built == [] and ps.prim_count == 24 + 25 + 2
    want = np.asarray(_scenes("caffeine+tris")[0].prim_a)
    geo.sphere_centers += 1.0
    assert moved.pick_tables is ps.pick_tables and built == [1]
    assert ps.pick_tables.prim_a.tobytes() == want.tobytes()


def _rays(scene, n, seed):
    """n rays from random points around the scene, each aimed at a random
    primitive's first point (jittered), plus a few random directions."""
    rng = np.random.default_rng(seed)
    a = np.asarray(scene.pick_tables.prim_a, np.float64)[:, :3]
    lo, hi = a.min(axis=0), a.max(axis=0)
    span = max(float(np.linalg.norm(hi - lo)), 1.0)
    centre = 0.5 * (lo + hi)
    dirs = rng.normal(size=(n, 3))
    origins = centre + span * dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    aim = a[rng.integers(0, a.shape[0], n)] + rng.normal(scale=0.05 * span / 10, size=(n, 3))
    d = aim - origins
    d[: n // 8] = rng.normal(size=(n // 8, 3))
    return origins, d / np.linalg.norm(d, axis=1, keepdims=True), centre


def _clip(centre, seed):
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=3)
    normal = (normal / np.linalg.norm(normal)).astype(np.float32)
    return normal, float(normal @ centre), float(rng.choice([-1.0, 1.0]))


def _same_hit(a, b):
    if a is None or b is None:
        assert a is b
        return
    assert np.float64(a.t).tobytes() == np.float64(b.t).tobytes()
    assert (a.prim_type, a.prim_index) == (b.prim_type, b.prim_index)
    assert np.asarray(a.extra, np.float64).tobytes() == np.asarray(b.extra, np.float64).tobytes()


@pytest.mark.parametrize("clipped", [False, True], ids=["no clip", "clip"])
@pytest.mark.parametrize("name", list(SCENES))
def test_trace_scene_ray_and_brute_force_equal(name, clipped):
    js, ps = _scenes(name)
    origins, dirs, centre = _rays(ps, 48, seed=len(name) + 7 * clipped)
    clip = _clip(centre, 3) if clipped else None
    hits = 0
    for o, d in zip(origins, dirs):
        for t_min in (1e-6, 1e-3):
            jh = JS.trace_scene_ray(js, o, d, t_min=t_min, clip=clip)
            ph = PS.trace_scene_ray(ps, o, d, t_min=t_min, clip=clip)
            _same_hit(jh, ph)
            hits += ph is not None
    assert hits > 0
    jb = JS.brute_force_closest(js, origins, dirs, clip=clip)
    pb = PS.brute_force_closest(ps, origins, dirs, clip=clip)
    for key in ("t", "prim_type", "prim_index", "extra"):
        assert jb[key].dtype == pb[key].dtype and jb[key].tobytes() == pb[key].tobytes(), key
    # The BVH walk finds the brute-force answer (both packages agree on it).
    found = np.isfinite(pb["t"])
    assert found.any()


@pytest.mark.parametrize("name", list(SCENES))
def test_overlay_bounds_and_rects_equal(name):
    js, ps = _scenes(name)
    jr = JRenderer(js, width=64, height=48)
    pr = Renderer(ps, width=64, height=48, device="cpu")
    jb, pb = jr.camera.basis(), pr.camera.basis()
    rects = 0
    for ptype, count in ((0, ps.tri_count), (1, ps.sphere_count), (2, ps.cylinder_count)):
        for index in sorted({0, count // 2, count - 1}) if count else ():
            jlo, jhi = JO.compute_primitive_world_bounds(js, ptype, index)
            plo, phi = PO.compute_primitive_world_bounds(ps, ptype, index)
            assert jlo.tobytes() == plo.tobytes() and jhi.tobytes() == phi.tobytes()
            for w, h in ((64, 48), (7, 300), (1920, 1080)):
                jrect = JO.project_aabb_to_canvas_rect(jlo, jhi, jb, w, h)
                prect = PO.project_aabb_to_canvas_rect(plo, phi, pb, w, h)
                assert jrect == prect
                rects += prect is not None
        with pytest.raises(IndexError):
            PO.compute_primitive_world_bounds(ps, ptype, count)
    assert rects > 0
    with pytest.raises(ValueError):
        PO.compute_primitive_world_bounds(ps, 5, 0)
    for point in (jb.origin + 3 * jb.forward, jb.origin - jb.forward):
        assert JO.project_point_to_canvas(point, jb, 64, 48) == \
            PO.project_point_to_canvas(point, pb, 64, 48)


PIXELS = [(x + 0.5, y + 0.5) for x in range(0, 64, 9) for y in range(0, 48, 7)] + [
    (32.0, 24.0), (0.0, 0.0), (63.9, 47.9), (-5.0, 10.0)]


@pytest.mark.parametrize("clip", [None, 0.8, 0.9], ids=["no clip", "clip 0.8", "clip 0.9"])
@pytest.mark.parametrize("name", ["primitives", "caffeine+tris"])
def test_picking_through_renderers_equal(name, clip):
    js, ps = _scenes(name)
    jr = JRenderer(js, width=64, height=48)
    pr = Renderer(ps, width=64, height=48, device="cpu")
    for r in (jr, pr):
        r.camera.drag(40.0, 25.0)
        if clip is not None:
            r.settings.clip_enabled = True
            r.settings.clip_distance = clip * r.camera.distance   # through the scene
    hits = 0
    for x, y in PIXELS:
        _same_hit(JK.pick_at_pixel(jr, x, y), PK.pick_at_pixel(pr, x, y))
        jh, ph = JK.hover_at_pixel(jr, x, y), PK.hover_at_pixel(pr, x, y)
        if jh is None or ph is None:
            assert jh is ph
            continue
        hits += 1
        _same_hit(jh.hit, ph.hit)
        assert jh.label == ph.label and jh.rect == ph.rect
        assert jh.bounds_min.tobytes() == ph.bounds_min.tobytes()
        assert jh.bounds_max.tobytes() == ph.bounds_max.tobytes()
        pr.frame_index = jr.frame_index = 3
        jf, pf = JK.autofocus_at_pixel(jr, x, y), PK.autofocus_at_pixel(pr, x, y)
        assert jf == pf and pr.settings.dof_focus_distance == jr.settings.dof_focus_distance
        assert pr.frame_index == 0
    assert hits > 0
    assert PK.autofocus_at_pixel(pr, -500.0, -500.0) is None


def test_tables_stay_on_host_for_a_cuda_scene():
    """.to() of a scene moves its tensors and keeps the host tables as the
    same numpy arrays (checked on a CUDA device where one exists)."""
    ps = _scenes("primitives")[1]
    target = "cuda" if torch.cuda.is_available() else "meta"
    moved = ps.to(target)
    assert moved.cluster_soa.device.type == target
    for field in HOST_FIELDS:
        assert getattr(moved.pick_tables, field) is getattr(ps.pick_tables, field)
