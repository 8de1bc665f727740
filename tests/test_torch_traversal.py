"""The port's stack tracer (ops/traversal.py) and brute sweep
(ops/wavefront._dense_trace) against the JAX package's.

The same scene (the JAX compile_scene's fields carried over with
scene_from_numpy) and the same rays, made with numpy from a seed, go
through webgl_raytracer_tpu/ops/traversal.py _traverse and the port's
plain walk, and through both packages' _dense_trace. The JAX side runs
eagerly (jax.disable_jit): jitted XLA code on the CPU contracts a*b+c
into FMAs, which the port never forms. Both then round every operation
alike, so every output is compared bit for bit: t, slot, type, local
index, extra, cost and the occlusion bits.

Scenes: caffeine (spheres and capped cylinders), the two-triangle scene
of tests/test_torch_render.py with and without a clip plane, and 300
random spheres. Rays start around the scene aimed at primitives, a
quarter of them inactive; the any-hit windows (accept_min, t_max) sit
at, one ulp around, and away from each ray's closest hit, and a small
max_steps cuts the walks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import random_sphere_geometry as bench_spheres
from webgl_raytracer_tpu.models import get_builtin_molecule, molecule_to_geometry
from webgl_raytracer_tpu.ops import traversal as JT
from webgl_raytracer_tpu.ops import wavefront as JW
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu_torch.ops import traversal as PT
from webgl_raytracer_tpu_torch.ops import wavefront as PW
from webgl_raytracer_tpu_torch.scene.compile import numpy_fields, scene_from_numpy

TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)
CLIP = (np.array([0.0, 0.0, 1.0], np.float32), np.float32(0.5), np.float32(1.0))
T_MIN = np.float32(1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """As in tests/test_torch_render.py: one torch thread, restored after
    this module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SCENES = {
    "caffeine": lambda: j_compile(molecule_to_geometry(get_builtin_molecule("caffeine"))),
    "tris": lambda: j_compile(None, tri_verts=TRIS),
    "spheres300": lambda: j_compile(bench_spheres(300)),
}
_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        js = SCENES[name]()
        _CACHE[name] = js, scene_from_numpy(numpy_fields(js), device="cpu")
    return _CACHE[name]


def _rays(js, n, seed):
    """(origin [n,3], direction [n,3], active [n]): origins on a sphere
    around the scene, aimed at jittered primitive points; 1/4 inactive."""
    rng = np.random.default_rng(seed)
    a = np.asarray(js.prim_a)[:, :3]
    centre, span = a.mean(0), max(float(np.linalg.norm(a.max(0) - a.min(0))), 4.0)
    u = rng.normal(size=(n, 3))
    o = centre + span * u / np.linalg.norm(u, axis=1, keepdims=True)
    aim = a[rng.integers(0, len(a), n)] + rng.normal(scale=0.3, size=(n, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), rng.random(n) >= 0.25


def _t3(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3))


def _bits_equal(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    bad = got != want
    assert not bad.any(), (name, int(bad.sum()), np.nonzero(bad.reshape(len(bad), -1))[0][:8])


def _jax_walk(js, o, d, clip, any_hit, active, max_steps, accept_min=None, t_max=None):
    with jax.disable_jit():
        return JT._traverse(js, jnp.asarray(o), jnp.asarray(d), T_MIN,
                            None if clip is None else tuple(map(jnp.asarray, clip)),
                            any_hit=any_hit,
                            accept_min=None if accept_min is None else jnp.asarray(accept_min),
                            t_max=None if t_max is None else jnp.asarray(t_max),
                            max_steps=max_steps, max_leaf=4,
                            active=jnp.asarray(active))


def _windows(t, rng):
    """Per ray an any-hit window (accept_min, t_max) around its closest
    hit t: (0, t+), (0, t), (0, t-), (t-, t+), (t, BIG), (t+, BIG), where
    t+ and t- are one ulp above and below t; (0, BIG) on a miss."""
    big = np.float32(1e20)
    up, down = np.nextafter(t, big), np.nextafter(t, np.float32(0))
    kind = rng.integers(0, 6, t.shape[0])
    lo = np.select([kind == 3, kind == 4, kind == 5], [down, t, up], np.float32(0))
    hi = np.select([kind == 0, kind == 1, kind == 2, kind == 3], [up, t, down, up], big)
    miss = t >= big
    return (np.where(miss, 0, lo).astype(np.float32), np.where(miss, big, hi).astype(np.float32))


CASES = [("caffeine", None, 2048), ("caffeine", None, 6), ("tris", None, 2048),
         ("tris", CLIP, 2048), ("spheres300", None, 2048)]


@pytest.mark.parametrize("case", CASES, ids=[f"{s} clip={c is not None} steps={m}"
                                             for s, c, m in CASES])
def test_walk_matches_jax(case):
    name, clip, max_steps = case
    js, ps = _scene(name)
    o, d, active = _rays(js, 384, seed=len(name) + max_steps)
    want = _jax_walk(js, o, d, clip, False, active, max_steps)
    got = PT.trace_closest(ps, _t3(o), _t3(d), float(T_MIN), clip=clip, max_steps=max_steps,
                           active=torch.from_numpy(active))
    for field in ("t", "prim_type", "prim_local", "prim_slot", "extra", "cost"):
        _bits_equal(getattr(got, field).numpy(), getattr(want, field), field)
    hit = got.prim_slot.numpy() >= 0
    assert hit.sum() > 50 and not hit[~active].any()
    if max_steps < 2048:
        # The cap cut walks: some rays stopped with their stack not empty.
        full = PT.trace_closest(ps, _t3(o), _t3(d), float(T_MIN), clip=clip,
                                active=torch.from_numpy(active))
        assert (full.cost > got.cost).any()

    # Any-hit windows around each ray's closest hit.
    t = got.t.numpy()
    lo, hi = _windows(t, np.random.default_rng(7))
    want_any = _jax_walk(js, o, d, clip, True, active, max_steps, accept_min=lo, t_max=hi)
    got_any, cost = PT.trace_any(ps, _t3(o), _t3(d), float(T_MIN), t_max=torch.from_numpy(hi),
                                 accept_min=torch.from_numpy(lo), clip=clip,
                                 max_steps=max_steps, active=torch.from_numpy(active),
                                 with_cost=True)
    _bits_equal(got_any.numpy(), want_any, "occluded")
    assert got_any.any() and not got_any.all()
    assert (cost.numpy()[~active] == 0).all()


def test_walk_t_max_and_empty_batch():
    """A t_max shorter than every hit occludes nothing; no ray at all is
    an empty result."""
    js, ps = _scene("spheres300")
    o, d, active = _rays(js, 64, seed=3)
    got = PT.trace_any(ps, _t3(o), _t3(d), float(T_MIN), t_max=1e-3)
    assert not got.any()
    empty = PT.trace_closest(ps, _t3(o[:0]), _t3(d[:0]), float(T_MIN))
    assert empty.t.shape == (0,) and empty.extra.shape == (0, 3)


def test_kernel_stack_depth_is_the_walks():
    """The stack kernel's stack size is the plain walk's STACK_DEPTH, passed
    by the build and in the library's hash: csrc/trace_stack.cu holds no
    size of its own."""
    import re

    from webgl_raytracer_tpu_torch.ops import kernels

    flags = kernels.compile_flags()
    assert f"-DWRT_STACK_DEPTH={PT.STACK_DEPTH}" in flags
    assert flags[:len(kernels.NVCC_FLAGS)] == kernels.NVCC_FLAGS
    assert PT.STACK_DEPTH == PT.DEFAULT_MAX_DEPTH + 2
    src = (kernels.CSRC_DIR / "trace_stack.cu").read_text()
    assert re.search(r"constexpr int kStack = WRT_STACK_DEPTH;", src)
    assert not re.search(r"kStack\s*=\s*\d", src)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name,clip", [("caffeine", None), ("tris", CLIP)],
                         ids=["caffeine", "tris clip"])
def test_dense_trace_matches_jax(name, clip, any_hit):
    js, ps = _scene(name)
    o, d, active = _rays(js, 512, seed=11)
    tmin = np.full(len(o), T_MIN, np.float32)
    lo = np.float32(0.3) if any_hit else None
    hi = np.float32(6.0) if any_hit else None
    with jax.disable_jit():
        want = JW._dense_trace(js, tuple(jnp.asarray(o[:, i]) for i in range(3)),
                               tuple(jnp.asarray(d[:, i]) for i in range(3)),
                               jnp.asarray(tmin),
                               None if clip is None else tuple(map(jnp.asarray, clip)),
                               any_hit, lo, hi, jnp.asarray(active))
    pclip = None if clip is None else (torch.from_numpy(clip[0]), float(clip[1]),
                                       float(clip[2]))
    got = PW._dense_trace(ps, _t3(o), _t3(d), torch.from_numpy(tmin), pclip, any_hit,
                          None if lo is None else float(lo), None if hi is None else float(hi),
                          torch.from_numpy(active))
    if any_hit:
        _bits_equal(got.numpy(), want, "occluded")
        assert got.any() and not got.all()
        return
    for field in ("t", "prim_type", "prim_local", "prim_slot", "extra", "cost"):
        _bits_equal(getattr(got, field).numpy(), getattr(want, field), field)
    assert (got.prim_slot >= 0).sum() > 50
