"""The port's host-side scene code against the JAX package: the BVH
builder, the cluster compile, the scene-centred kernel operands, the
camera, the lights and the settings split, all exact."""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgl_raytracer_tpu.ops.pallas_trace as PS
from bench import random_sphere_geometry as bench_spheres
from webgl_raytracer_tpu.models import (BUILTIN_MOLECULE_NAMES, get_builtin_molecule,
                                        molecule_to_geometry)
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu.scene import bvh as JBVH
from webgl_raytracer_tpu.scene.compile import scene_bounds as j_bounds
from webgl_raytracer_tpu_torch import models as PM
from webgl_raytracer_tpu_torch.ops.trace import clip_operand, scene_operands
from webgl_raytracer_tpu_torch.render import Renderer, split_settings, uniforms_from_numpy
from webgl_raytracer_tpu_torch.render.lights import light_dirs_for_camera
from webgl_raytracer_tpu_torch.scene import bvh as PBVH
from webgl_raytracer_tpu_torch.scene import (compile_scene, random_sphere_geometry,
                                             scene_bounds, scene_from_numpy)
from webgl_raytracer_tpu_torch.scene.compile import TENSOR_FIELDS, numpy_fields

TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)


def _inputs(name):
    if name == "spheres1000":
        return bench_spheres(1000), None
    return molecule_to_geometry(get_builtin_molecule("caffeine")), TRIS


@pytest.fixture(scope="module", params=["spheres1000", "caffeine+tris"])
def scenes(request):
    geo, tv = _inputs(request.param)
    return j_compile(geo, tri_verts=tv), compile_scene(geo, tri_verts=tv, device="cpu")


def test_random_sphere_geometry_matches_bench():
    a, b = bench_spheres(1000), random_sphere_geometry(1000)
    for f in dataclasses.fields(a):
        assert np.array_equal(getattr(a, f.name), getattr(b, f.name))


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_build_bvh_identical(backend):
    geo = molecule_to_geometry(get_builtin_molecule("caffeine"))
    kw = dict(tri_verts=TRIS, sphere_centers=geo.sphere_centers,
              sphere_radii=geo.sphere_radii, cyl_p1=geo.cyl_p1, cyl_p2=geo.cyl_p2,
              cyl_radii=geo.cyl_radii, max_leaf_size=4, backend=backend)
    a, b = JBVH.build_bvh(**kw), PBVH.build_bvh(**kw)
    for f in ("node_bmin", "node_bmax", "node_meta", "prim_encoded", "prim_order"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_compile_scene_identical(scenes):
    js, ps = scenes
    assert ps.num_clusters == js.num_clusters
    for f in ("tri_count", "sphere_count", "cylinder_count", "cluster_size"):
        assert getattr(ps, f) == getattr(js, f), f
    for f in TENSOR_FIELDS:
        assert np.array_equal(np.asarray(getattr(js, f)), getattr(ps, f).numpy()), f


def test_bench_scene_has_twelve_clusters():
    assert compile_scene(random_sphere_geometry(1000), device="cpu").num_clusters == 12


def test_scene_operands_identical(scenes):
    js, ps = scenes
    k = js.num_clusters
    soa16, bbT, _, mid, ct = (np.asarray(x) for x in PS._scene_operands(js))
    ops = scene_operands(ps)
    assert np.array_equal(mid, ops.mid.numpy())
    assert np.array_equal(soa16.reshape(k, 16, 128)[:, :12], ops.soa.numpy(),
                          equal_nan=True)
    assert np.array_equal(bbT[0:3, :k].T, ops.box[:, :3].numpy())
    assert np.array_equal(bbT[3:6, :k].T, ops.box[:, 3:].numpy())
    assert np.array_equal(ct, ops.ctype.numpy())
    for clip in (None, ((0.0, 0.6, 0.8), 0.5, -1.0)):
        jclip = None if clip is None else (jnp.asarray(clip[0], jnp.float32),
                                           jnp.float32(clip[1]), jnp.float32(clip[2]))
        cp, on = PS._scalar_operand(jclip, jnp.asarray(mid), js)
        pcp, pon = clip_operand(clip, ops)
        assert on == pon
        assert np.array_equal(np.asarray(cp), pcp.numpy())


def test_scene_from_numpy_round_trip(scenes):
    js, ps = scenes
    carried = scene_from_numpy(numpy_fields(js), device="cpu")
    again = scene_from_numpy({f: (getattr(carried, f).numpy() if f in TENSOR_FIELDS
                                  else getattr(carried, f))
                              for f in numpy_fields(carried)}, device="cpu")
    for f in TENSOR_FIELDS:
        assert np.array_equal(getattr(ps, f).numpy(), getattr(again, f).numpy())
    assert (again.num_clusters, again.sphere_count) == (js.num_clusters, js.sphere_count)


def test_bounds_camera_lights_uniforms(scenes):
    js, ps = scenes
    lo, hi = j_bounds(js)
    plo, phi = scene_bounds(ps)
    assert np.array_equal(np.asarray(lo), plo) and np.array_equal(np.asarray(hi), phi)

    jr = JRenderer(js, width=64, height=48)
    pr = Renderer(ps, width=64, height=48, device="cpu")
    assert jr.settings.ray_bias == pr.settings.ray_bias
    jb, pb = jr.camera.basis(), pr.camera.basis()
    for f in ("origin", "forward", "right", "up"):
        assert np.array_equal(getattr(jb, f), getattr(pb, f)), f
    jl = j_lights(jr.settings.lights, jb)
    pl = light_dirs_for_camera(pr.settings.lights, pb)
    assert np.array_equal(jl, pl)

    jflags, ju = j_split(jr.settings, jb, jl, has_env=False, has_volume=False)
    pflags, pu = split_settings(pr.settings, pb, pl, device="cpu")
    for f in dataclasses.fields(pflags):
        assert getattr(pflags, f.name) == getattr(jflags, f.name), f.name
    carried = uniforms_from_numpy({f.name: np.asarray(getattr(ju, f.name))
                                   for f in dataclasses.fields(ju)}, device="cpu")
    for f in dataclasses.fields(pu):
        a, b = getattr(pu, f.name), getattr(carried, f.name)
        assert a.dtype == torch.float32 and torch.equal(a, b), f.name

    jx, jy = (np.asarray(a) for a in jr._pixel_grids())
    px, py = pr._pixel_grids()
    assert np.array_equal(jx, px.numpy()) and np.array_equal(jy, py.numpy())
    assert np.array_equal(np.asarray(jr._unperm), pr._unperm.numpy())


@pytest.mark.parametrize("name", BUILTIN_MOLECULE_NAMES)
def test_builtin_molecules_and_geometry_identical(name):
    jm, pm = get_builtin_molecule(name), PM.get_builtin_molecule(name)
    assert np.array_equal(jm.positions, pm.positions)
    assert jm.elements == pm.elements and np.array_equal(jm.bonds, pm.bonds)
    for kw in ({}, {"radius_scale": 0.25, "show_bonds": False}):
        jg, pg = molecule_to_geometry(jm, **kw), PM.molecule_to_geometry(pm, **kw)
        assert [f.name for f in dataclasses.fields(jg)] == \
            [f.name for f in dataclasses.fields(pg)]
        for f in dataclasses.fields(jg):
            a, b = getattr(jg, f.name), getattr(pg, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name


def test_native_bvh_builder_identical():
    """The port's copy of the C++ builder, built into its own _build/,
    gives the JAX package's tree."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native builder cannot be built here")
    geo = bench_spheres(3000)
    kw = dict(sphere_centers=geo.sphere_centers, sphere_radii=geo.sphere_radii,
              max_leaf_size=128, max_depth=48, backend="native")
    a, b = JBVH.build_bvh(**kw), PBVH.build_bvh(**kw)
    for f in ("node_bmin", "node_bmax", "node_meta", "prim_encoded", "prim_order"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert PBVH.load_bvh_builder() is not None
    assert "webgl_raytracer_tpu_torch" in str(PBVH.load_bvh_builder()._name)


def test_entry_points_raise_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda:0")
    geo = random_sphere_geometry(50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_scene(geo)
    ps = compile_scene(geo, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scene_from_numpy(numpy_fields(ps))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(ps)
