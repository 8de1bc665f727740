"""The port's frame loop (render/frame.py) on the CPU: the frame function
that the card captures as a CUDA graph, the block logic around it, and
the rest of the Renderer's surface.

(a) The frame function reads nothing back to the host on any transport:
    a guard makes every tensor-to-host read raise while it runs (the
    plain traces, which the card never captures, run outside the guard).
(b) Renderer.render_frames equals a loop of render_batch_stats plus the
    running mean, bit for bit with equal ray counts, on every transport;
    a block whose binned buffer overflows is redone and gives the
    permuted transport's frames.
(c) render_frames against the JAX package's render_frames (its fused
    scan, run eagerly) under tests/test_torch_render.py's frame tolerance.
(d) A trace with no active lane returns the miss record bit for bit, and
    bounces after every path has died change nothing.
(e) set_scene, resize, set_scale, the clip lock and checkpoints against
    the JAX Renderer; checkpoints load across the two packages.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from bench import random_sphere_geometry as bench_spheres
from webgl_raytracer_tpu.models import get_builtin_molecule, molecule_to_geometry
from webgl_raytracer_tpu.models.molecular import Geometry as JGeometry
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu_torch.env import EnvironmentController
from webgl_raytracer_tpu_torch.ops import trace as T
from webgl_raytracer_tpu_torch.ops import wavefront as PW
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.scene.compile import numpy_fields, scene_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per test worker, as in tests/test_torch_render.py;
    the previous value comes back after this module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(js):
    return scene_from_numpy(numpy_fields(js), device="cpu")


def _dense():
    """300 spheres of radius 0.8-1.2 in an 8-unit box: with the camera at
    0.45 of its fitted distance, 1,318 of a 64x32 frame's 2,048 primaries
    hit, more than the binned buffer's 1,024 lanes."""
    rng = np.random.default_rng(3)
    n = 300
    z3, z1 = np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    return j_compile(JGeometry(((rng.random((n, 3)) - 0.5) * 8).astype(np.float32),
                               (0.8 + rng.random(n) * 0.4).astype(np.float32),
                               rng.random((n, 3)).astype(np.float32), z3, z3, z1, z3))


_SCENES = {}


def _scene(name):
    """Port scenes shared by the tests of this module."""
    if name not in _SCENES:
        if name == "spheres300":
            js = j_compile(bench_spheres(300))
        elif name == "dense":
            js = _dense()
        else:
            js = j_compile(molecule_to_geometry(get_builtin_molecule("caffeine")),
                           tri_verts=TRIS, tri_flags=np.array([1.0, 0.0], np.float32))
        _SCENES[name] = _port(js)
    return _SCENES[name]


def _env(kind):
    envs = EnvironmentController(device="cpu")
    if kind == "sky":
        return envs.load_analytic_sky(width=64, height=32)
    return envs.load_hdr_file(os.path.join(REPO, "assets", "env", "sunny_sky_256x128.hdr"))


# name: (scene, width, height, knobs, settings, env, camera distance factor)
CASES = {
    "whole batch": ("spheres300", 32, 16, {"WRT_CHUNKS": "1"}, {}, None, 1.0),
    "binned": ("spheres300", 64, 32, {"WRT_CHUNKS": "4"}, {}, None, 1.0),
    "binned over its cap": ("dense", 64, 32, {"WRT_CHUNKS": "4", "WRT_BIN_CAP_DIV": "64"},
                            {"max_bounces": 2}, None, 0.45),
    "permuted": ("spheres300", 64, 32, {"WRT_CHUNKS": "4", "WRT_BINNED": "0"}, {}, None,
                 1.0),
    "attrs": ("caffeine+tris", 64, 32, {"WRT_CHUNKS": "4", "WRT_ATTRS": "1"},
              {"material_mode": "surface-glass", "surface_flag_mode": 1}, None, 1.0),
    "sky": ("spheres300", 64, 32, {"WRT_CHUNKS": "4"}, {"env_intensity": 0.4}, "sky",
            1.0),
    "hdr": ("caffeine+tris", 32, 16, {"WRT_CHUNKS": "1"}, {}, "hdr", 1.0),
    "dof": ("spheres300", 32, 16, {"WRT_CHUNKS": "1"},
            {"dof_enabled": True, "dof_aperture": 0.3}, None, 1.0),
    "clip": ("caffeine+tris", 64, 32, {"WRT_CHUNKS": "4"},
             {"clip_enabled": True, "clip_distance": 14.0}, None, 1.0),
}


def _renderer(case):
    name, w, h, _, settings, env, distance = CASES[case]
    r = Renderer(_scene(name), env=None if env is None else _env(env), width=w, height=h,
                 device="cpu")
    r.camera.distance *= distance
    for k, v in settings.items():
        setattr(r.settings, k, v)
    return r


@pytest.fixture
def knobs(monkeypatch):
    """Set a case's transport knobs for the test (restored after it)."""
    def set_(case):
        for k in PI.TRANSPORT_KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in CASES[case][3].items():
            monkeypatch.setenv(k, v)
    return set_


class HostRead(AssertionError):
    pass


class NoHostReads:
    """While `active`, every tensor-to-host read raises HostRead: truth
    tests, int/float/index conversion, item, tolist, cpu, numpy, nonzero
    and boolean-mask indexing. The plain traces run with it inactive."""

    METHODS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
               "numpy", "nonzero")
    PLAIN = ("closest_plain", "closest_attrs_plain", "any3_plain", "any_plain",
             "_perray_walk")

    def __init__(self, monkeypatch):
        self.active = False
        for name in self.METHODS:
            monkeypatch.setattr(torch.Tensor, name, self._guard(name, getattr(torch.Tensor, name)))
        monkeypatch.setattr(torch, "nonzero", self._guard("torch.nonzero", torch.nonzero))
        real_getitem = torch.Tensor.__getitem__

        def getitem(t, idx):
            keys = idx if isinstance(idx, tuple) else (idx,)
            if self.active and any(isinstance(k, torch.Tensor) and k.dtype == torch.bool
                                   for k in keys):
                raise HostRead("boolean-mask indexing")
            return real_getitem(t, idx)

        monkeypatch.setattr(torch.Tensor, "__getitem__", getitem)
        for name in self.PLAIN:
            monkeypatch.setattr(T, name, self._outside(getattr(T, name)))

    def _guard(self, name, real):
        def guarded(*a, **kw):
            if self.active:
                raise HostRead(name)
            return real(*a, **kw)
        return guarded

    def _outside(self, fn):
        def plain(*a, **kw):
            was, self.active = self.active, False
            try:
                return fn(*a, **kw)
            finally:
                self.active = was
        return plain


@pytest.mark.parametrize("case", list(CASES))
def test_frame_function_reads_nothing_back(case, knobs, monkeypatch):
    """(a) The captured frame: _frame on its static buffers, after one
    warm frame (the card's warm-up builds the scene's operands)."""
    knobs(case)
    r = _renderer(case)
    flags = r._frame_setup()
    r._frame(flags)
    guard = NoHostReads(monkeypatch)
    guard.active = True
    r._frame(flags)
    guard.active = False
    assert int(r._fi) == 2


def _eager(r, frames, **knobs):
    """frames of r through render_batch_stats and the running mean written
    out: (accumulator, path rays, occlusion rays)."""
    flags, u, px, py = r.frame_inputs()
    acc, paths, occl = None, 0, 0
    with pytest.MonkeyPatch.context() as mp:
        for k, v in knobs.items():
            mp.setenv(k, v)
        for f in range(frames):
            color, (p, o) = PI.render_batch_stats(r.scene, flags, u, px, py, f, env=r.env)
            acc = color if f == 0 else (acc * float(f) + color) / torch.tensor(f + 1.0)
            paths, occl = paths + int(p), occl + int(o)
    return acc, paths, occl


@pytest.mark.parametrize("case", ["whole batch", "binned", "binned over its cap",
                                  "permuted", "attrs"])
def test_render_frames_equal_eager_frames(case, knobs, monkeypatch):
    """(b) Two blocks, of one frame and of two, against three eager frames;
    over the cap the blocks are redone and give the permuted transport's
    frames."""
    knobs(case)
    binned = []
    real = PI._binned_transport
    monkeypatch.setattr(PI, "_binned_transport",
                        lambda *a, **kw: binned.append(1) or real(*a, **kw))
    r = _renderer(case)
    assert r.render_frames(1) and r.render_frames(2)
    assert r.frame_index == 3
    acc, paths, occl = _eager(r, 3)
    assert float(acc.mean()) > 0.0 and bool(torch.isfinite(acc).all())
    assert torch.equal(r._accum, acc), float((r._accum - acc).abs().max())
    assert r.ray_counts == (paths, occl)
    over = case == "binned over its cap"
    assert bool(binned) == (case in ("binned", "binned over its cap"))
    assert r.stats == {"captures": 0, "overflowed_blocks": 2 if over else 0,
                       "redone_frames": 3 if over else 0}
    if over:
        permuted = _eager(r, 3, WRT_BINNED="0")
        assert torch.equal(r._accum, permuted[0]) and r.ray_counts == permuted[1:]


def test_render_frames_match_jax():
    """(c) Three frames of the 200-sphere scene at 32x16 through both
    packages' render_frames, the JAX one a fused scan run eagerly, under
    tests/test_torch_render.py's frame tolerance (on the accumulated
    image: at most 1% of pixels off by more than 1e-4, the mean of the
    rest within 1e-3 relative)."""
    js = j_compile(bench_spheres(200))
    jr = JRenderer(js, width=32, height=16)
    pr = Renderer(_port(js), width=32, height=16, device="cpu")
    with jax.disable_jit():
        jr.render_frames(3)
    pr.render_frames(3)
    assert jr.frame_index == pr.frame_index == 3
    jc, pc = jr.accumulated(), pr.accumulated()
    assert np.isfinite(pc).all() and pc.mean() > 0
    diff = np.abs(pc - jc).max(axis=2)
    assert (diff > 1e-4).sum() <= 0.01 * diff.size, np.argwhere(diff > 1e-4).tolist()
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * jc[keep].mean()


def _miss(n):
    """The record and attribute row of a lane that hits nothing."""
    attrs = torch.zeros((n, 32))
    attrs[:, T.ATTR_MISS_COL] = -1.0
    return (torch.full((n,), PI.BIG), torch.full((n,), -1, dtype=torch.int32), attrs)


@pytest.mark.parametrize("name", ["spheres300", "caffeine+tris"])
def test_traces_without_active_lanes_miss(name):
    """(d) Every trace, block and per-ray, with every lane inactive: the
    miss record (t BIG, row -1, the miss attribute row) and no occlusion,
    bit for bit, also through the wavefront entry points."""
    scene = _scene(name)
    rng = np.random.default_rng(5)
    n = 256
    o3 = tuple(torch.as_tensor(x) for x in (rng.normal(size=(3, n)) * 3).astype(np.float32))
    d = rng.normal(size=(3, n)).astype(np.float32)
    d3 = tuple(torch.as_tensor(x) for x in d / np.linalg.norm(d, axis=0))
    off = torch.zeros(n, dtype=torch.bool)
    tmin = torch.full((n,), 1e-3)
    t_miss, row_miss, attrs_miss = _miss(n)
    for perray in (False, True):
        t, row = T.trace_closest(scene, o3, d3, tmin, active=off, perray=perray)
        assert torch.equal(t, t_miss) and torch.equal(row, row_miss)
        assert not bool(T.trace_any(scene, o3, d3, tmin, active=off, perray=perray).any())
    t, attrs = T.trace_closest_attrs(scene, o3, d3, tmin, active=off)
    assert torch.equal(t, t_miss) and torch.equal(attrs, attrs_miss)
    occ = T.trace_any3(scene, o3, (d3, d3, d3), tmin, actives=(off, off, off))
    assert not any(bool(x.any()) for x in occ)
    for full in (True, False):
        rec = PW.wf_trace_closest_v3(scene, o3, d3, tmin, active=off, secondary=True,
                                     full_record=full)
        for got, want in ((rec.t, t_miss), (rec.prim_type, row_miss),
                          (rec.prim_local, row_miss), (rec.prim_slot, row_miss),
                          (rec.extra, torch.zeros((n, 3)))):
            assert torch.equal(got, want)
    rec, attrs = PW.wf_trace_closest_v3(scene, o3, d3, tmin, active=off, with_attrs=True)
    assert torch.equal(rec.t, t_miss) and torch.equal(rec.prim_slot, row_miss)
    assert torch.equal(attrs, attrs_miss)


@pytest.mark.parametrize("env", [None, "sky"])
def test_bounces_after_every_path_died_change_nothing(env):
    """(d) A bounce over a batch with no live lane leaves the radiance
    (any values) and the ray counts bit for bit as they were; and a batch
    whose camera rays all miss gives the same radiance and counts at 1 and
    at 8 bounces."""
    r = _renderer("binned")
    r.env = None if env is None else _env(env)
    flags, u, px, py = r.frame_inputs()
    seed, o3, d3 = PI.generate_camera_rays(u, flags, px, py, 0, 0)
    n = px.shape[0]
    st = PI._initial_state(seed, o3, d3, px.device)
    rng = np.random.default_rng(9)
    rad = torch.as_tensor(rng.random((3, n)).astype(np.float32))
    rad[:, ::7] = 0.0
    st.radiance = tuple(x.clone() for x in rad)
    st.alive = torch.zeros(n, dtype=torch.bool)
    st.nrays = torch.tensor(5)
    st.noccl = torch.tensor(7)
    step = PI._make_bounce_step(r.scene, r.env, flags, u, n)
    for bounce in (1, 2):
        st = step(bounce, st)
    assert all(torch.equal(a, b) for a, b in zip(st.radiance, rad))
    assert int(st.nrays) == 5 and int(st.noccl) == 7 and not bool(st.alive.any())

    away = tuple(-x for x in d3)            # every camera ray misses the scene
    runs = []
    for bounces in (1, 8):
        f = dataclasses.replace(flags, max_bounces=bounces)
        radiance, _, rays = PI.trace_paths(r.scene, f, u, o3, away, seed, env=r.env)
        runs.append((radiance, int(rays[0]), int(rays[1])))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert runs[0][1:] == runs[1][1:] == (n, 0)


def _pair(w=48, h=32):
    js = j_compile(molecule_to_geometry(get_builtin_molecule("caffeine")))
    return js, JRenderer(js, width=w, height=h), Renderer(_port(js), width=w, height=h,
                                                          device="cpu")


def _same_camera(jr, pr):
    for name in ("target", "rotation"):
        np.testing.assert_array_equal(np.asarray(getattr(jr.camera, name)),
                                      np.asarray(getattr(pr.camera, name)))
    assert (jr.camera.distance, jr.camera.fov, jr.camera.width, jr.camera.height) == \
        (pr.camera.distance, pr.camera.fov, pr.camera.width, pr.camera.height)


def test_set_scene_matches_jax():
    """(e) Swapping the scene recomputes bounds, scale, ray bias and the
    camera fit as the JAX Renderer does, and restarts accumulation."""
    _, jr, pr = _pair()
    pr.render_frames(1)
    js2 = j_compile(bench_spheres(200))
    jr.set_scene(js2)
    pr.set_scene(_port(js2))
    _same_camera(jr, pr)
    assert pr.frame_index == 0 and pr.ray_counts == (0, 0)
    assert (jr.settings.ray_bias, jr.settings.t_min, jr.scene_scale) == \
        (pr.settings.ray_bias, pr.settings.t_min, pr.scene_scale)
    for a, b in zip(jr.bounds, pr.bounds):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pr.render_frames(1) and pr.accumulated().mean() > 0


def test_resize_and_set_scale_match_jax():
    """(e) resize and set_scale (dimensions snapped to 16-pixel tiles,
    scale clamped to [0.05, 2]) give the JAX Renderer's sizes; a size
    change restarts accumulation and the next frame renders at it."""
    _, jr, pr = _pair(100, 60)
    ops = (("set_scale", 0.01), ("render", None), ("set_scale", 0.5), ("set_scale", 3.0),
           ("resize", (40, 24)), ("resize", (40, 24)), ("set_scale", 1.0),
           ("set_scale", 0.33))
    for op, arg in ops:
        if op == "render":
            assert pr.render_frames(1) and pr.frame_index == 1
            continue
        for r in (jr, pr):
            getattr(r, op)(*(arg if isinstance(arg, tuple) else (arg,)))
        assert (jr.width, jr.height, jr.scale) == (pr.width, pr.height, pr.scale), (op, arg)
        _same_camera(jr, pr)
    assert pr.frame_index == 0 and (pr.width, pr.height) == (32, 16)
    assert pr.render_frames(1)
    assert pr.accumulated().shape == (16, 32, 3) and pr._accum.shape == (32 * 16, 3)


def test_clip_lock_matches_jax():
    """(e) The locked clip plane is the plane of the camera at lock time
    and stays in world space while the camera moves; unlocked, it follows
    the camera again. The same plane as the JAX Renderer's for the same
    camera, and as the uniforms a frame reads."""
    _, jr, pr = _pair()
    for r in (jr, pr):
        r.settings.clip_enabled = True
        r.settings.clip_distance = 2.0
    locked = pr.active_clip_plane(pr.camera.basis())
    for r in (jr, pr):
        r.lock_clip_plane()
        r.camera.rotation = np.array([0.0, np.sin(0.3), 0.0, np.cos(0.3)])
        r.camera.distance *= 1.3

    def planes():
        jp = jr.active_clip_plane(jr.camera.basis())
        pp = pr.active_clip_plane(pr.camera.basis())
        np.testing.assert_array_equal(jp[0], pp[0])
        assert jp[1:] == pp[1:]
        return pp

    moved = planes()
    np.testing.assert_array_equal(moved[0], locked[0])
    assert moved[1:] == locked[1:]
    assert pr.settings.clip_locked and pr.settings.clip_locked_side == locked[2]
    _, u, _, _ = pr.frame_inputs()
    np.testing.assert_array_equal(u.clip_normal.numpy(), locked[0])
    assert float(u.clip_offset) == np.float32(locked[1])
    for r in (jr, pr):
        r.unlock_clip_plane()
    free = planes()
    assert not np.array_equal(free[0], locked[0])
    assert pr.settings.clip_locked_normal is None


def test_checkpoints_round_trip_across_packages(tmp_path):
    """(e) A checkpoint (the JAX package's .npz keys: accum in ray order,
    frame_index, size, camera) written by either package loads in the
    other and in itself; resumed rendering continues the accumulation
    bit for bit; a checkpoint of another size raises."""
    js, jr, pr = _pair()
    pr.camera.distance *= 1.1
    pr.render_frames(2)
    pr.save_checkpoint(tmp_path / "port.npz")
    straight = Renderer(_port(js), width=48, height=32, device="cpu")
    straight.camera.distance *= 1.1
    straight.render_frames(3)

    resumed = Renderer(_port(js), width=48, height=32, device="cpu")
    resumed.load_checkpoint(tmp_path / "port.npz")
    assert resumed.frame_index == 2
    _same_camera(pr, resumed)
    assert torch.equal(resumed._accum, pr._accum)
    resumed.render_frames(1)
    assert torch.equal(resumed._accum, straight._accum)

    jr.load_checkpoint(str(tmp_path / "port.npz"))
    assert jr.frame_index == 2
    _same_camera(jr, pr)
    np.testing.assert_array_equal(jr.accumulated(), pr.accumulated())

    rng = np.random.default_rng(2)
    jr._accum = jax.numpy.asarray(rng.random((48 * 32, 3)).astype(np.float32))
    jr.frame_index = 7
    jr.camera.distance *= 0.8
    jr.save_checkpoint(str(tmp_path / "jax.npz"))
    fresh = Renderer(_port(js), width=48, height=32, device="cpu")
    fresh.load_checkpoint(tmp_path / "jax.npz")
    assert fresh.frame_index == 7
    _same_camera(jr, fresh)
    np.testing.assert_array_equal(fresh.accumulated(), jr.accumulated())

    small = Renderer(_port(js), width=32, height=32, device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        small.load_checkpoint(tmp_path / "port.npz")
