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


# The stack kernel's operands (ops/traversal.walk_args, pack_nodes): what
# the CPU can check of the CUDA path.

def _bench_scene(name):
    """A port scene of the smoke's stack cases, built on the CPU: the
    1000-sphere bench scene or the TSTP cartoon."""
    import os

    from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
    from webgl_raytracer_tpu_torch.models import parse_auto_detect
    from webgl_raytracer_tpu_torch.scene import compile_scene, random_sphere_geometry

    if name == "spheres1000":
        return compile_scene(random_sphere_geometry(1000), device="cpu")
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "proteins", "TSTP.pdb")
    with open(path, encoding="utf-8") as f:
        mol = parse_auto_detect(f.read(), "TSTP.pdb")
    return load_molecule_scene(mol, display_style="cartoon", device="cpu").scene


@pytest.mark.parametrize("name", ["spheres1000", "tstp cartoon"])
def test_packed_nodes_unpack_to_the_walk_tables(name):
    """The kernel's packed node table, decoded as csrc/trace_stack.cu reads
    it, gives back walk_tables' node rows exactly: bmin, bmax and
    (leftFirst, primCount, rightChild)."""
    tables = _bench_scene(name).walk_tables
    words = tables.nodes.view(torch.int32)
    assert tables.nodes.shape == (tables.node_bmin.shape[0], 8)
    assert tables.nodes.is_contiguous() and tables.nodes.dtype == torch.float32
    link = words[:, 7]
    leaf = link > 0
    meta = torch.stack([words[:, 3], torch.where(leaf, link, 0),
                        torch.where(leaf, -1, ~link)], dim=1)
    assert torch.equal(words[:, 0:3], tables.node_bmin.view(torch.int32))
    assert torch.equal(words[:, 4:7], tables.node_bmax.view(torch.int32))
    assert torch.equal(meta, tables.node_meta)
    assert bool(leaf.any()) and bool((~leaf).any())


@pytest.mark.parametrize("links", [[0, 2, 5], [1, 0, 2], [1, -1, 2], [1, 0, -2]],
                         ids=["leaf with a right child", "inner count 0 is fine",
                              "inner with a negative count", "inner right below -1"])
def test_check_links_refuses_links_pack_nodes_cannot_hold(links):
    meta = np.array([[1, 0, 2], links], np.int32)
    if links == [1, 0, 2]:
        PT.check_links(meta)
        return
    with pytest.raises(ValueError, match="BVH node 1"):
        PT.check_links(meta)


def _walk_batch(n=256):
    js, ps = _scene("caffeine")
    o, d, active = _rays(js, n, seed=5)
    return ps, _t3(o), _t3(d), torch.from_numpy(active)


BAD_WALK_OPERANDS = {
    "f64 origin": lambda o, d, a, k: ((o[0].double(), o[1], o[2]), d, a, k),
    "short direction row": lambda o, d, a, k: (o, (d[0], d[1][:-1], d[2]), a, k),
    "non-contiguous row": lambda o, d, a, k: (
        o, tuple(torch.stack(d, 1)[:, i] for i in range(3)), a, k),
    "f64 t_min": lambda o, d, a, k: (o, d, a, dict(k, t_min=torch.tensor(1e-3).double())),
    "t_max of two values": lambda o, d, a, k: (o, d, a, dict(k, t_max=torch.ones(2))),
    "accept_min row with a stride": lambda o, d, a, k: (
        o, d, a, dict(k, accept_min=torch.zeros(2 * a.shape[0])[::2])),
    "int activity mask": lambda o, d, a, k: (o, d, a.to(torch.int32), k),
    "short activity mask": lambda o, d, a, k: (o, d, a[:-1], k),
}


@pytest.mark.parametrize("case", list(BAD_WALK_OPERANDS))
def test_walk_kernel_refuses_operands_before_any_launch(case, monkeypatch):
    """The CUDA wrapper checks every operand it hands the kernel and raises
    before it allocates the live list or launches (here on CPU tensors,
    with ops/kernels.launch replaced by a trap)."""
    from webgl_raytracer_tpu_torch.ops import kernels
    from webgl_raytracer_tpu_torch.ops.wavefront import scene_types

    def trap(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(kernels, "launch", trap)
    ps, o3, d3, active = _walk_batch()
    o3, d3, active, kw = BAD_WALK_OPERANDS[case](
        o3, d3, active, dict(t_min=float(T_MIN), t_max=1e20, accept_min=None))
    with pytest.raises(ValueError):
        PT._walk_cuda(ps.walk_tables, scene_types(ps), o3, d3, kw["t_min"], kw["t_max"],
                      kw["accept_min"], None, active, True, 2048, 4)


def test_walk_kernel_takes_the_callers_tensors(monkeypatch):
    """Nothing is staged: the kernel gets the callers' rows and mask
    themselves (step 1), one value as a pointer with step 0 (an expanded
    origin, a 0-d t_min) or as a number, and the packed nodes; a masked
    batch also gets its compaction's list and zeroed count, an unmasked
    one none."""
    from webgl_raytracer_tpu_torch.ops import kernels
    from webgl_raytracer_tpu_torch.ops.wavefront import scene_types

    calls = []
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a) or 0)
    ps, o3, d3, active = _walk_batch()
    n = o3[0].shape[0]
    o3 = (o3[0], torch.tensor(2.0).expand(n), o3[2])
    tmin, lo = torch.tensor(T_MIN), torch.rand(n)
    PT._walk_cuda(ps.walk_tables, scene_types(ps), o3, d3, tmin, 1e20, lo, None, active,
                  True, 2048, 4)
    (entry, device, *args), = calls
    assert entry == "wrt_trace_stack_any" and device == o3[0].device
    rows = args[:12]
    assert all(a is b for a, b in zip(rows[0::2], (*o3, *d3)))
    assert rows[1::2] == [1, 0, 1, 1, 1, 1]
    assert args[12] is tmin and args[13:15] == [0, 0.0]
    assert args[15] is None and args[16:18] == [0, 1e20]
    assert args[18] is lo and args[19] == 1
    assert args[21] is active and args[22] == n and args[23] is ps.walk_tables.nodes
    live, count = args[33:35]
    assert live.dtype == torch.int32 and live.shape == (n,)
    assert count.dtype == torch.int32 and count.tolist() == [0]
    calls.clear()
    PT._walk_cuda(ps.walk_tables, scene_types(ps), o3, d3, tmin, 1e20, lo, None, None,
                  False, 2048, 4)
    (entry, _, *args), = calls
    assert entry == "wrt_trace_stack_closest" and args[21] is None and args[33:35] == [None, None]


def test_walk_operands_take_every_batch_a_stack_frame_traces(monkeypatch):
    """Each batch the integrator hands the walk (primaries, bounces, the
    joined shadow fan, env NEE, vis mode 2) passes the kernel's operand
    checks as it is, so the card's frames launch with nothing staged."""
    from webgl_raytracer_tpu_torch.env import EnvironmentController
    from webgl_raytracer_tpu_torch.render import Renderer
    from webgl_raytracer_tpu_torch.scene import compile_scene, molecule_geometry

    seen = {True: 0, False: 0}
    real = PT.walk_plain

    def walk(tables, types, o3, d3, t_min, t_max, accept_min, clip, active, any_hit, *steps):
        PT.walk_args(tables, types, o3, d3, t_min, t_max, accept_min, clip, active, *steps)
        seen[any_hit] += 1
        return real(tables, types, o3, d3, t_min, t_max, accept_min, clip, active, any_hit,
                     *steps)

    monkeypatch.setattr(PT, "walk_plain", walk)
    sky = EnvironmentController(device="cpu").load_analytic_sky(width=64, height=32)
    r = Renderer(compile_scene(molecule_geometry("caffeine"), device="cpu"), env=sky,
                 width=32, height=24, device="cpu")
    r.settings.tracer = "stack"
    r.render(1)
    r.settings.vis_mode = 2
    r.render(1)
    assert seen[False] >= 5 and seen[True] >= 8, seen


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
