"""The port's trace counts (ops/trace.py, "Counts": with_cost=True)
against the JAX package's Pallas with_cost outputs in interpret mode, and
against the invariants that hold whatever the schedule.

The plain versions stand in for the CUDA cost forms here;
tests/test_torch_kernels_cuda.py holds the kernels to them on a GPU.

Per-ray counts equal the JAX per-ray kernels' for one group of clusters
(K <= 128): both pop a ray's clusters front to back while the nearest
entry lies before its best t (closest) or before t_max until a hit
(occlusion). The JAX entries and t come from fused XLA code, which can
round a product differently from the port, so a ray whose deciding entry
lies within one ulp of its t may pop one cluster more or fewer: at least
99.9% of the rays must count the same, and each ray that differs must
differ by exactly 128 with some cluster entry within 1 ulp of its t. The
JAX block kernels charge every ray its 1024-ray block's union, so the
port's block counts are held to invariants instead. Above 128 clusters
the JAX group walk is uniform over the block, and the port's per-ray
count is held to its own group walk, written out here ray by ray.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgl_raytracer_tpu.ops.pallas_trace as PS
from webgl_raytracer_tpu.models.molecular import Geometry
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu_torch.ops import trace as T
from webgl_raytracer_tpu_torch.ops.wavefront import INF, cluster_entry_t, intersect_soa_t
from webgl_raytracer_tpu_torch.scene.compile import numpy_fields, scene_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    threads would oversubscribe them, and the many small tensor ops here
    run fastest on one thread. The setting is process-wide, so the
    previous value comes back after this module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


Z3 = np.zeros((0, 3), np.float32)
Z1 = np.zeros((0,), np.float32)
N_RAYS = 1500
EQUAL_FRACTION = 0.999
CLIP = ((0.0, 0.0, 1.0), 0.5, 1.0)


def _spheres(seed, n, extent):
    rng = np.random.default_rng(seed)
    centers = (rng.random((n, 3)).astype(np.float32) - 0.5) * extent
    radii = (0.15 + rng.random(n) * 0.3).astype(np.float32)
    return Geometry(centers, radii, rng.random((n, 3)).astype(np.float32),
                    Z3, Z3, Z1, Z3), None


def _triangles():
    rng = np.random.default_rng(17)
    t = 400
    v0 = (rng.random((t, 3)).astype(np.float32) - 0.5) * 12
    tv = np.stack([v0, v0 + rng.normal(size=(t, 3)).astype(np.float32),
                   v0 + rng.normal(size=(t, 3)).astype(np.float32)], axis=1)
    return Geometry(Z3, Z1, Z3, Z3, Z3, Z1, Z3), tv


def _caffeine_tris():
    from webgl_raytracer_tpu.models import get_builtin_molecule, molecule_to_geometry

    tv = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                   [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)
    return molecule_to_geometry(get_builtin_molecule("caffeine")), tv


# name -> (geometry, ray spread, ray z offset): tests/test_pallas_perray.py's
# sphere and triangle scenes and its multigroup scene (160 x 128 spheres),
# and the caffeine + triangles scene of the frame tests (three types).
SCENES = {
    "spheres900": (lambda: _spheres(11, 900, 14), 3.0, 12.0),
    "triangles400": (_triangles, 3.0, 12.0),
    "caffeine+tris": (_caffeine_tris, 3.0, 10.0),
    "two-level 160x128 spheres": (lambda: _spheres(31, 160 * 128, 60), 12.0, 40.0),
}
_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        geo, tv = SCENES[name][0]()
        js = j_compile(geo, tri_verts=tv)
        _CACHE[name] = (js, scene_from_numpy(numpy_fields(js), device="cpu"))
    return _CACHE[name]


def _rays(name, seed, n=N_RAYS):
    spread, zoff = SCENES[name][1:]
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32) * spread
    o[2] += zoff
    d = rng.normal(size=(3, 3, n)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.random(n) >= 0.2
    return o, d, act, np.full(n, 1e-3, np.float32)


def _p3(a):
    return tuple(torch.as_tensor(np.ascontiguousarray(a[i])) for i in range(3))


def _j3(a):
    return tuple(jnp.asarray(a[i]) for i in range(3))


def _port_counts(ps, o, d, act, tmin):
    """{kernel: (outputs..., count)} of the five plain versions through the
    public wrappers, the rays of `act` active."""
    o3, d3s, t = _p3(o), tuple(_p3(x) for x in d), torch.as_tensor(tmin)
    a = torch.as_tensor(act)
    lo = torch.full_like(t, 0.01)
    out = {}
    for per in (False, True):
        name = "_perray" if per else ""
        out["trace_closest" + name] = T.trace_closest(ps, o3, d3s[0], t, active=a, perray=per,
                                                      with_cost=True)
        out["trace_any" + name] = T.trace_any(ps, o3, d3s[0], t, t_max=30.0, accept_min=lo,
                                              active=a, perray=per, with_cost=True)
    occ, cost = T.trace_any3(ps, o3, d3s, t, accept_min=lo, actives=(a, a, a), with_cost=True)
    out["trace_any3"] = (*occ, cost)
    return out


@pytest.mark.parametrize("clip", [None, CLIP], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", ["spheres900", "caffeine+tris"])
def test_counting_changes_no_output(name, clip):
    """The five plain versions give the same (t, row) or bits with and
    without the count, called directly and through the wrappers."""
    _, ps = _scene(name)
    o, d, act, tmin = _rays(name, 3)
    o3, d3, t, a = _p3(o), _p3(d[0]), torch.as_tensor(tmin), torch.as_tensor(act)
    ops = ps.trace_operands
    cp, clip_on = T.clip_operand(clip, ops)
    od = T.closest_operand(o3, d3, t, a, ops.mid)
    plain = T.closest_plain(ops, od, cp, clip_on)
    counted = T.closest_plain(ops, od, cp, clip_on, with_cost=True)
    assert all(torch.equal(x, y) for x, y in zip(plain, counted[:2]))
    oda = T.any_operand(o3, d3, t, 30.0, 0.01, a, ops.mid)
    assert torch.equal(T.any_plain(ops, oda, cp, clip_on),
                       T.any_plain(ops, oda, cp, clip_on, with_cost=True)[0])
    od3 = T.any3_operand(o3, tuple(_p3(x) for x in d), t, 0.01, (a, a, None), ops.mid)
    assert torch.equal(T.any3_plain(ops, od3, cp, clip_on),
                       T.any3_plain(ops, od3, cp, clip_on, with_cost=True)[0])
    for per in (False, True):
        base = T.trace_closest(ps, o3, d3, t, clip=clip, active=a, perray=per)
        cost = T.trace_closest(ps, o3, d3, t, clip=clip, active=a, perray=per, with_cost=True)
        assert torch.equal(base[0], cost[0]) and torch.equal(base[1], cost[1])
        assert torch.equal(base[1], plain[1])
        kw = dict(t_max=30.0, accept_min=torch.full_like(t, 0.01), clip=clip, active=a,
                  perray=per)
        bits = T.trace_any(ps, o3, d3, t, **kw)
        assert torch.equal(bits, T.trace_any(ps, o3, d3, t, with_cost=True, **kw)[0])
        assert torch.equal(bits, T.any_plain(ops, oda, cp, clip_on))
    occ = T.trace_any3(ps, o3, tuple(_p3(x) for x in d), t, clip=clip)
    occ_c, _ = T.trace_any3(ps, o3, tuple(_p3(x) for x in d), t, clip=clip, with_cost=True)
    assert all(torch.equal(x, y) for x, y in zip(occ, occ_c))


def _ulp_gap(a, b):
    """|a - b| in units of the last place (f32, same sign)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _check_ulp_rule(what, ps, o, d, t_port, port, jax_):
    """At least EQUAL_FRACTION of the rays count what JAX counts; each one
    that does not differs by exactly 128, with some cluster entry within
    1 ulp of its t (its deciding pop)."""
    diff = np.nonzero(port != jax_)[0]
    print(f"{what}: {len(diff)} of {len(port)} rays count differently")
    assert len(diff) <= (1 - EQUAL_FRACTION) * len(port), diff.tolist()
    if len(diff):
        assert (np.abs(port[diff] - jax_[diff]) == 128).all()
        ops = ps.trace_operands
        oc = tuple(torch.as_tensor(o[i][diff]) - ops.mid[i] for i in range(3))
        e = cluster_entry_t(ops.box[:, :3], ops.box[:, 3:], oc,
                            tuple(torch.as_tensor(d[i][diff]) for i in range(3))).numpy()
        gap = _ulp_gap(e, np.asarray(t_port)[diff][:, None]).min(axis=1)
        assert (gap <= 1).all(), gap.tolist()


@pytest.mark.parametrize("name", ["spheres900", "triangles400"])
def test_perray_counts_match_jax(name):
    """Per-ray closest and occlusion counts against the JAX per-ray
    kernels' with_cost outputs (interpret mode), K <= 128, 20% of the rays
    inactive (0 on both sides)."""
    js, ps = _scene(name)
    assert ps.num_clusters <= T.GROUP
    o, d, act, tmin = _rays(name, 5)
    port = _port_counts(ps, o, d, act, tmin)
    ja = jnp.asarray(act)
    _, _, jc = PS.trace_closest(js, _j3(o), _j3(d[0]), jnp.asarray(tmin), active=ja,
                                interpret=True, perray=True, with_cost=True)
    t, row, pc = port["trace_closest_perray"]
    _check_ulp_rule(f"{name} closest", ps, o, d[0], t.numpy(), pc.numpy(), np.asarray(jc))
    _, jca = PS.trace_any(js, _j3(o), _j3(d[0]), jnp.asarray(tmin), t_max=30.0,
                          accept_min=jnp.full(tmin.shape, 0.01), active=ja, interpret=True,
                          perray=True, with_cost=True)
    pa = port["trace_any_perray"][1].numpy()
    _check_ulp_rule(f"{name} any", ps, o, d[0], np.full(len(pa), 30.0, np.float32), pa,
                    np.asarray(jca))
    assert int((pc > 0).sum()) > N_RAYS // 2


@pytest.mark.parametrize("name", ["spheres900", "triangles400", "caffeine+tris"])
def test_count_invariants(name):
    """Per-ray closest <= block closest on every ray (the front-to-back
    set is a subset of the index-order one within a group of clusters);
    every hit ray counts at least 128; every count is a multiple of 128
    and at most K x 128 (x 3 for the fan); inactive rays count 0. (Both
    schedules of trace_any count the same; the CUDA tests force each.)"""
    _, ps = _scene(name)
    k = ps.num_clusters
    o, d, act, tmin = _rays(name, 9)
    out = _port_counts(ps, o, d, act, tmin)
    (tb, rb, cb), (tp, rp, cp) = out["trace_closest"], out["trace_closest_perray"]
    assert torch.equal(rb, rp) and torch.equal(tb, tp)
    if k <= T.GROUP:
        assert bool((cp <= cb).all())
    hit = rb >= 0
    assert int(hit.sum()) > 50
    assert bool((cb[hit] >= 128).all()) and bool((cp[hit] >= 128).all())
    a = torch.as_tensor(act)
    for kernel, res in out.items():
        cost = res[-1]
        bound = k * 128 * (3 if kernel == "trace_any3" else 1)
        assert cost.dtype == torch.int32, kernel
        assert bool((cost % 128 == 0).all()) and int(cost.max()) <= bound, kernel
        assert not bool(cost[~a].any()), kernel
        assert int((cost > 0).sum()) > 50, kernel
    found, ca = out["trace_any"]
    assert bool((ca[found] >= 128).all())


def _group_walk_reference(ps, o, d, tmin, ray):
    """Ray `ray`'s (t, row, count) by the per-ray kernels' walk written
    out in numpy: pop the nearest unvisited group (lowest index on ties)
    while its entry is before the best t, inside it the nearest unvisited
    cluster while its entry is before the best t; each popped cluster's
    primitives update (t, row) lexicographically."""
    ops = ps.trace_operands
    c = ops.soa.shape[-1]
    oc = tuple(torch.as_tensor(o[i][ray:ray + 1]) - ops.mid[i] for i in range(3))
    dd = tuple(torch.as_tensor(d[i][ray:ray + 1]) for i in range(3))
    e = cluster_entry_t(ops.box[:, :3], ops.box[:, 3:], oc, dd)[0].numpy()
    ge = cluster_entry_t(ops.gbox[:, :3], ops.gbox[:, 3:], oc, dd)[0].numpy().copy()
    best, row, count = np.float32(1e20), -1, 0
    while True:
        g = int(np.argmin(ge))
        if not ge[g] < best:
            return best, row, count
        ge[g] = INF
        ev = e[g * T.GROUP:(g + 1) * T.GROUP].copy()
        while True:
            j = int(np.argmin(ev))
            if not ev[j] < best:
                break
            ev[j] = INF
            k = g * T.GROUP + j
            count += c
            ts = intersect_soa_t(ops.types, ops.soa[k], oc, dd,
                                 torch.as_tensor(tmin[ray:ray + 1]), None)[0].numpy()
            ts = np.where(ts > 0.0, ts, INF)
            tb = np.float32(ts.min())
            if tb < INF:
                cand = k * c + int(np.argmin(ts))
                if tb < best or (tb == best and cand < row):
                    best, row = tb, cand


def _split_plane_rays(ps, n, seed):
    """Rays inside the slab where the two group boxes of the 160-cluster
    scene overlap (they split the scene along z), running nearly parallel
    to it: both groups are entered at 0, so group 0 is walked first, and
    where the nearest hit lies in group 1 group 0's clusters beyond it are
    swept too. These are the rays whose count a flat walk gets wrong."""
    gb = ps.trace_operands.gbox.numpy() + ps.trace_operands.mid.numpy()[[0, 1, 2, 0, 1, 2]]
    lo, hi = gb[:, 2].max(), gb[:, 5].min()
    assert ps.trace_operands.gbox.shape[0] == 2 and lo < hi
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-25, 25, n), rng.uniform(-25, 25, n),
                  rng.uniform(lo, hi, n)]).astype(np.float32)
    d = np.stack([rng.normal(size=n), rng.normal(size=n), rng.normal(size=n) * 0.01])
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, 1e-3, np.float32)


def test_multigroup_perray_count_walks_the_groups():
    """Above 128 clusters (160 here) the plain per-ray count walks the
    kernels' groups: it equals a ray-by-ray numpy walk of them, t and row
    equal the block walk's, and each ray counts at least 128 x the
    clusters whose entry lies before its final t. A flat walk over all
    clusters would count exactly that; on these rays the group walk
    sweeps more on some (printed, and required)."""
    name = "two-level 160x128 spheres"
    _, ps = _scene(name)
    assert ps.num_clusters > T.GROUP
    o, d, tmin = _split_plane_rays(ps, 256, 5)
    o3, d3, t = _p3(o), _p3(d), torch.as_tensor(tmin)
    tp, rp, cp = T.trace_closest(ps, o3, d3, t, perray=True, with_cost=True)
    tb, rb = T.trace_closest(ps, o3, d3, t)
    assert torch.equal(tp, tb) and torch.equal(rp, rb) and int((rb >= 0).sum()) > 50
    ops = ps.trace_operands
    oc = tuple(o3[i] - ops.mid[i] for i in range(3))
    e = cluster_entry_t(ops.box[:, :3], ops.box[:, 3:], oc, d3)
    before = (e < tp[:, None]).sum(dim=1).to(torch.int32) * 128
    assert bool((cp >= before).all())
    flat = 0
    for ray in range(0, 256, 4):
        bt, br, bc = _group_walk_reference(ps, o, d, tmin, ray)
        assert (bt, br, bc) == (float(tp[ray]), int(rp[ray]), int(cp[ray])), ray
        flat += int(cp[ray]) != int(before[ray])
    print(f"{name}: {flat} of 64 rays pop clusters at or beyond their final t")
    assert flat >= 4
    fp, cf = T.trace_any(ps, o3, d3, t, t_max=80.0, accept_min=torch.full_like(t, 0.01),
                         perray=True, with_cost=True)
    fb = T.trace_any(ps, o3, d3, t, t_max=80.0, accept_min=torch.full_like(t, 0.01))
    assert torch.equal(fp, fb) and bool((cf[fp] >= 128).all())
    assert int(cf.max()) <= ps.num_clusters * 128
