"""The port's chunked transports (render/integrator.py: binned, permuted,
attrs) on 64x64 frames split into four chunks (WRT_CHUNKS=4), the frames
tests/test_compact.py renders in the JAX package.

Inside the port every transport is a permutation of the same per-lane
computation, so each frame must equal the whole-batch frame (WRT_CHUNKS=1)
exactly, ray counts included. Against the JAX package (run eagerly, as in
tests/test_torch_render.py) the binned and attrs frames are held to the
tolerance of test_frame_matches_jax there.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.models import get_builtin_molecule, molecule_to_geometry
from webgl_raytracer_tpu.models.molecular import Geometry
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import integrator as JI
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu_torch.ops import wavefront as PW
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.scene.compile import numpy_fields, scene_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per test worker, as in tests/test_torch_render.py;
    the previous value comes back after this module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)


def _spheres300():
    """tests/test_compact.py's frame scene."""
    rng = np.random.default_rng(17)
    n = 300
    centers = (rng.random((n, 3)).astype(np.float32) - 0.5) * 16
    radii = (0.2 + rng.random(n) * 0.4).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return j_compile(Geometry(centers, radii, colors, z3, z3, z1, z3)), {}


def _glass():
    """Caffeine + 2 triangles, one flagged glass, under the clip plane:
    the attrs rows' normal and flag columns shade."""
    js = j_compile(molecule_to_geometry(get_builtin_molecule("caffeine")),
                   tri_verts=TRIS, tri_flags=np.array([1.0, 0.0], np.float32))
    return js, {"material_mode": "surface-glass", "surface_flag_mode": 1,
                "clip_enabled": True, "clip_distance": 14.0}


SCENES = {"spheres300": _spheres300, "caffeine+tris glass": _glass}


@pytest.fixture(scope="module", params=list(SCENES))
def pair(request):
    """(JAX renderer, its frame inputs) and (port renderer, its frame
    inputs) for the same 64x64 frame."""
    js, settings = SCENES[request.param]()
    jr = JRenderer(js, width=64, height=64)
    pr = Renderer(scene_from_numpy(numpy_fields(js), device="cpu"), width=64, height=64,
                  device="cpu")
    for k, v in settings.items():
        setattr(jr.settings, k, v)
        setattr(pr.settings, k, v)
    basis = jr.camera.basis()
    jflags, ju = j_split(jr.settings, basis, j_lights(jr.settings.lights, basis),
                         has_env=False, has_volume=False, clip=jr.active_clip_plane(basis))
    return (jr, jflags, ju, *jr._pixel_grids()), (pr, *pr.frame_inputs())


class _Knobs:
    """Set environment knobs for one frame and restore them after."""

    def __init__(self, **knobs):
        self.knobs = knobs

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.knobs}
        os.environ.update(self.knobs)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _spy(monkeypatch, module, name):
    """Count calls of module.name (still calling it)."""
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _frame(p, **knobs):
    pr, flags, u, px, py = p
    with _Knobs(**knobs):
        color, (nr, no) = PI.render_batch_stats(pr.scene, flags, u, px, py, 0)
    return color, int(nr), int(no)


_WHOLE = {}


def _whole(p):
    key = (id(p[0]), p[1])
    if key not in _WHOLE:
        _WHOLE[key] = _frame(p, WRT_CHUNKS="1")
    return _WHOLE[key]


def _same(a, b):
    assert float(a[0].mean()) > 0.0 and bool(torch.isfinite(a[0]).all())
    assert torch.equal(a[0], b[0]), float((a[0] - b[0]).abs().max())
    assert a[1:] == b[1:]


# (flag overrides, knobs): re-packs after every bounce but the last, so
# 1-3 bounces give 0-2 re-packs; two samples a frame; buffers of n/2 and n
# lanes besides the default n/12 (1024 here).
BINNED = [({}, {}), ({"max_bounces": 1}, {}), ({"max_bounces": 2}, {}),
          ({"max_bounces": 3}, {}), ({"spp": 2}, {}),
          ({}, {"WRT_BIN_CAP_DIV": "2"}), ({}, {"WRT_BIN_CAP_DIV": "1"}),
          ({"max_bounces": 2, "spp": 2}, {"WRT_BIN_CAP_DIV": "2"})]


@pytest.mark.parametrize("case", BINNED, ids=lambda c: ",".join(
    f"{a}={b}" for a, b in (*c[0].items(), *c[1].items())) or "default")
def test_binned_frame_equals_whole_batch(pair, case, monkeypatch):
    overrides, knobs = case
    pr, flags, u, px, py = pair[1]
    p = (pr, dataclasses.replace(flags, **overrides), u, px, py)
    binned = _spy(monkeypatch, PI, "_binned_transport")
    permuted = _spy(monkeypatch, PI, "_run_permuted")
    out = _frame(p, WRT_CHUNKS="4", **knobs)
    assert len(binned) == p[1].spp and not permuted, \
        "every sample must take the binned transport"
    _same(out, _whole(p))


@pytest.mark.parametrize("scene", list(SCENES))
def test_binned_fallback_equals_whole_batch(scene, monkeypatch):
    """A cap below the live count (n/4096 gives the 1024-lane floor; a
    128x128 frame holds 1.4-1.7k primary hits) runs the permuted transport
    and still gives the whole-batch frame."""
    js, settings = SCENES[scene]()
    pr = Renderer(scene_from_numpy(numpy_fields(js), device="cpu"), width=128,
                  height=128, device="cpu")
    for k, v in settings.items():
        setattr(pr.settings, k, v)
    p = (pr, *pr.frame_inputs())
    binned = _spy(monkeypatch, PI, "_binned_transport")
    permuted = _spy(monkeypatch, PI, "_run_permuted")
    out = _frame(p, WRT_CHUNKS="4", WRT_BIN_CAP_DIV="4096")
    assert len(binned) == 1 and len(permuted) == 1, "the cap test must fall back"
    _same(out, _frame(p, WRT_CHUNKS="1"))


def test_permuted_frame_equals_whole_batch(pair, monkeypatch):
    binned = _spy(monkeypatch, PI, "_binned_transport")
    out = _frame(pair[1], WRT_CHUNKS="4", WRT_BINNED="0")
    assert not binned
    _same(out, _whole(pair[1]))


def test_attrs_frame_equals_whole_batch(pair, monkeypatch):
    """The attrs path: permuted with attribute rows; every closest trace
    asks for the attrs kernel, the shading reads the rows."""
    traces = _spy(monkeypatch, PI, "wf_trace_closest_v3")
    out = _frame(pair[1], WRT_CHUNKS="4", WRT_ATTRS="1")
    assert traces and all(kw.get("with_attrs") for kw in traces)
    _same(out, _whole(pair[1]))


def _jax_frame(j, **knobs):
    jr, jf, ju, jx, jy = j
    with _Knobs(**knobs), jax.disable_jit():
        jc, (jn, jo) = JI.render_batch_stats(jr.scene, None, None, jf, ju, jx, jy,
                                             jnp.uint32(0))
    return np.asarray(jc), int(jn), int(jo)


def _close_to_jax(p, j, bounces):
    """tests/test_torch_render.py's frame tolerance."""
    pc, pn, po = p[0].numpy(), p[1], p[2]
    jc, jn, jo = j
    diff = np.abs(pc - jc).max(axis=1)
    flipped = np.nonzero(diff > 1e-4)[0]
    assert len(flipped) <= 0.01 * diff.size, f"flipped rays: {flipped.tolist()}"
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * jc[keep].mean()
    assert abs(pn - jn) <= bounces * len(flipped), (pn, jn, flipped.tolist())
    assert abs(po - jo) <= 3 * bounces * len(flipped), (po, jo, flipped.tolist())


# The JAX side's knobs: its binned transport forced on its CPU path (the
# compact and wavefront transports off), or its attrs path through the
# Pallas kernels in interpret mode.
JAX_KNOBS = {"binned": dict(WRT_CHUNKS="4", WRT_BINNED="1", WRT_COMPACT="0",
                            WRT_WAVEFRONT="0"),
             "attrs": dict(WRT_CHUNKS="4", WRT_ATTRS="1", WRT_PALLAS_INTERPRET="1")}


@pytest.mark.parametrize("path", list(JAX_KNOBS))
def test_chunked_frame_matches_jax(pair, path):
    j = _jax_frame(pair[0], **JAX_KNOBS[path])
    knobs = dict(WRT_CHUNKS="4", WRT_ATTRS="1") if path == "attrs" else dict(WRT_CHUNKS="4")
    _close_to_jax(_frame(pair[1], **knobs), j, pair[1][1].max_bounces)


def test_record_without_full_record_keeps_slot(pair):
    """full_record=False leaves t unrefined and the record slim; finalising
    it gives the full record."""
    pr, flags, u, px, py = pair[1]
    seed, o3, d3 = PI.generate_camera_rays(u, flags, px, py, 0, 0)
    slim = PW.wf_trace_closest_v3(pr.scene, o3, d3, u.t_min, full_record=False)
    full = PW.wf_trace_closest_v3(pr.scene, o3, d3, u.t_min)
    assert torch.equal(slim.prim_slot, full.prim_slot)
    assert torch.equal(slim.prim_type >= 0, full.prim_type >= 0)
    fin = PW._finalize_hit(pr.scene, o3, d3, u.t_min.expand(px.shape[0]), None, slim.t,
                           slim.prim_slot, cost=None, refine_sphere_t=True)
    for f in ("t", "prim_type", "prim_local", "prim_slot", "extra"):
        assert torch.equal(getattr(fin, f), getattr(full, f)), f


def test_binned_frame_without_hits(monkeypatch):
    """A frame whose primaries all miss: the binned transport runs no
    bounce on its empty buffer and still counts every camera ray, as the
    whole batch does."""
    js, _ = _spheres300()
    pr = Renderer(scene_from_numpy(numpy_fields(js), device="cpu"), width=64, height=64,
                  device="cpu")
    flags, u, px, py = pr.frame_inputs()
    u.cam_forward = -u.cam_forward          # look away from the scene
    binned = _spy(monkeypatch, PI, "_binned_transport")
    out = _frame((pr, flags, u, px, py), WRT_CHUNKS="4")
    assert len(binned) == 1
    whole = _frame((pr, flags, u, px, py), WRT_CHUNKS="1")
    assert torch.equal(out[0], whole[0]) and out[1:] == whole[1:] == (64 * 64, 0)
