"""The port's single-direction occlusion and per-ray traces
(webgl_raytracer_tpu_torch.ops.trace) against the JAX package's Pallas
kernels in interpret mode, and the port's per-ray routing against the JAX
package's predicates.

The plain versions stand in for the CUDA kernels here (the kernels have no
CPU mode; tests/test_torch_kernels_cuda.py holds them to the plain versions
on a GPU). Each scene is like one of tests/test_pallas_perray.py's, with at
most 1,500 rays.

Tolerances. Inside the port the per-ray walk and the block walk agree bit
for bit: rows, occlusion bits and t. Against the Pallas kernels, rows and
bits must match except on grazing rays, and t within T_RTOL (2e-4, the JAX
package's own Pallas-vs-XLA bar): XLA's CPU code contracts a*b+c into FMAs
inside the interpreted kernel, the port rounds every product, and where a
ray grazes a primitive (its discriminant or barycentric within rounding of
the boundary) that one rounding can turn a hit into a miss. A ray whose
row differs is accepted only if its float64 test against one side's winner
lies within GRAZE of the boundary (an occlusion bit: against some primitive
of the scene), and at most MAX_GRAZE rays of a batch may differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgl_raytracer_tpu.ops.pallas_trace as PS
from webgl_raytracer_tpu.models.molecular import Geometry
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu_torch.ops import trace as T
from webgl_raytracer_tpu_torch.ops import wavefront as PW
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

T_RTOL = 2e-4
GRAZE = 1e-5
MAX_GRAZE = 3
Z3 = np.zeros((0, 3), np.float32)
Z1 = np.zeros((0,), np.float32)


def _spheres(seed, n, extent):
    rng = np.random.default_rng(seed)
    centers = (rng.random((n, 3)).astype(np.float32) - 0.5) * extent
    radii = (0.15 + rng.random(n) * 0.3).astype(np.float32)
    return Geometry(centers, radii, rng.random((n, 3)).astype(np.float32),
                    Z3, Z3, Z1, Z3), None


def _cylinders():
    rng = np.random.default_rng(13)
    m = 300
    p1 = (rng.random((m, 3)).astype(np.float32) - 0.5) * 12
    axis = rng.normal(size=(m, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    p2 = p1 + axis * (0.5 + rng.random((m, 1)).astype(np.float32))
    radii = (0.08 + rng.random(m) * 0.15).astype(np.float32)
    return Geometry(Z3, Z1, Z3, p1, p2, radii, rng.random((m, 3)).astype(np.float32)), None


def _triangles():
    rng = np.random.default_rng(17)
    t = 400
    v0 = (rng.random((t, 3)).astype(np.float32) - 0.5) * 12
    tv = np.stack([v0, v0 + rng.normal(size=(t, 3)).astype(np.float32),
                   v0 + rng.normal(size=(t, 3)).astype(np.float32)], axis=1)
    empty = Geometry(Z3, Z1, Z3, Z3, Z3, Z1, Z3)
    return empty, tv


def _sphere_cylinder_mix():
    rng = np.random.default_rng(23)
    ns, nc = 500, 400
    centers = (rng.random((ns, 3)).astype(np.float32) - 0.5) * 14
    radii = (0.15 + rng.random(ns) * 0.3).astype(np.float32)
    colors = rng.random((ns, 3)).astype(np.float32)
    p1 = (rng.random((nc, 3)).astype(np.float32) - 0.5) * 14
    p2 = p1 + rng.normal(size=(nc, 3)).astype(np.float32) * 0.8
    cr = (0.05 + rng.random(nc) * 0.1).astype(np.float32)
    return Geometry(centers, radii, colors, p1, p2, cr,
                    rng.random((nc, 3)).astype(np.float32)), None


# name -> (geometry, ray spread, ray z offset, t_max of the occlusion test)
SCENES = {
    "spheres900": (lambda: _spheres(11, 900, 14), 3.0, 12.0, 30.0),
    "cylinders300": (_cylinders, 3.0, 12.0, 30.0),
    "triangles400": (_triangles, 3.0, 12.0, 30.0),
    "spheres+cylinders": (_sphere_cylinder_mix, 2.0, 8.0, 30.0),
    "routing 70x128 spheres": (lambda: _spheres(7, 70 * 128, 40), 8.0, 25.0, 60.0),
    "two-level 160x128 spheres": (lambda: _spheres(31, 160 * 128, 60), 12.0, 40.0, 80.0),
}

_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        geo, tv = SCENES[name][0]()
        js = j_compile(geo, tri_verts=tv)
        _CACHE[name] = (js, scene_from_numpy(numpy_fields(js), device="cpu"))
    return _CACHE[name]


def _rays(seed, n, spread, zoff):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32) * spread
    o[2] += zoff
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[2] -= 1.5
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d, np.full(n, 1e-3, np.float32)


def _j3(a):
    return tuple(jnp.asarray(a[i]) for i in range(3))


def _p3(a):
    return tuple(torch.as_tensor(np.ascontiguousarray(a[i])) for i in range(3))


def _graze(js, o, d, ray, row):
    """Distance of ray `ray`'s test against primitive `row` from its
    hit/miss boundary, in float64: |disc| / b^2 for spheres and cylinder
    caps (the body's |disc| / b^2 for cylinders), the smallest barycentric
    margin for triangles."""
    prim = np.asarray(js.cluster_prims).reshape(-1, 12)[row].astype(np.float64)
    oo, dd = o[:, ray].astype(np.float64), d[:, ray].astype(np.float64)
    ptype = int(prim[11])

    def sphere(center, r):
        s = oo - center
        b = s @ dd
        return abs(b * b - (s @ s - r * r)) / max(b * b, 1e-30)

    if ptype == 1:
        return sphere(prim[0:3], prim[3])
    if ptype == 2:
        p1, p2, r = prim[0:3], prim[4:7], prim[3]
        axis = (p2 - p1) / np.linalg.norm(p2 - p1)
        dp = dd - axis * (dd @ axis)
        op = (oo - p1) - axis * ((oo - p1) @ axis)
        a, b, c = dp @ dp, 2 * dp @ op, op @ op - r * r
        return min(abs(b * b - 4 * a * c) / max(b * b, 1e-30), sphere(p1, r), sphere(p2, r))
    v0, v1, v2 = prim[0:3], prim[4:7], prim[8:11]
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(dd, e2)
    det = e1 @ p
    tv = oo - v0
    u = (tv @ p) / det
    v = (dd @ np.cross(tv, e1)) / det
    return min(abs(u), abs(v), abs(1 - u - v))


def _assert_rows(js, o, d, jrows, prows, what):
    """Rows equal except on at most MAX_GRAZE grazing rays."""
    bad = np.nonzero(jrows != prows)[0]
    assert len(bad) <= MAX_GRAZE, f"{what}: {len(bad)} rays differ: {bad.tolist()}"
    for i in bad:
        g = min(_graze(js, o, d, i, r) for r in (jrows[i], prows[i]) if r >= 0)
        assert g < GRAZE, f"{what}: ray {i} differs ({jrows[i]} vs {prows[i]}), graze {g}"
    return bad


def _nearest_graze(js, o, d, ray):
    """Smallest _graze of ray `ray` over every primitive of the scene."""
    rows = np.nonzero(np.asarray(js.cluster_prims).reshape(-1, 12)[:, 11] >= 0)[0]
    return min(_graze(js, o, d, ray, r) for r in rows)


def _closest_matches_pallas(js, ps, o, d, tmin, what):
    """The port's per-ray plain walk: equal to its block walk bit for bit,
    and to the Pallas per-ray kernel under the grazing rule. Returns the
    port's rows."""
    jt, jr = PS.trace_closest(js, _j3(o), _j3(d), jnp.asarray(tmin), interpret=True,
                              perray=True)
    jt, jr = np.asarray(jt), np.asarray(jr)
    pt, pr = T.trace_closest(ps, _p3(o), _p3(d), torch.as_tensor(tmin), perray=True)
    bt, br = T.trace_closest(ps, _p3(o), _p3(d), torch.as_tensor(tmin))
    assert int((pr >= 0).sum()) > 50
    assert torch.equal(pr, br) and torch.equal(pt.view(torch.int32), bt.view(torch.int32))
    bad = _assert_rows(js, o, d, jr, pr.numpy(), what)
    keep = np.ones(len(jr), bool)
    keep[bad] = False
    np.testing.assert_allclose(pt.numpy()[keep], jt[keep], rtol=T_RTOL)
    return pr.numpy()


def _any_matches_pallas(js, ps, o, d, tmin, t_max, act, what):
    """The port's per-ray and block plain occlusion: equal to each other,
    and to the Pallas block and per-ray kernels under the grazing rule."""
    n = o.shape[1]
    lo = np.full(n, 0.01, np.float32)
    kw = dict(t_max=t_max, accept_min=jnp.asarray(lo), active=jnp.asarray(act),
              interpret=True)
    jb = np.asarray(PS.trace_any(js, _j3(o), _j3(d), jnp.asarray(tmin), **kw))
    jp = np.asarray(PS.trace_any(js, _j3(o), _j3(d), jnp.asarray(tmin), perray=True, **kw))
    pkw = dict(t_max=t_max, accept_min=torch.as_tensor(lo), active=torch.as_tensor(act))
    pb = T.trace_any(ps, _p3(o), _p3(d), torch.as_tensor(tmin), **pkw)
    pp = T.trace_any(ps, _p3(o), _p3(d), torch.as_tensor(tmin), perray=True, **pkw)
    assert torch.equal(pb, pp)
    assert not pb.numpy()[~act].any()
    assert 20 < int(pb.sum()) < int(act.sum())
    bad = np.nonzero((jb != pb.numpy()) | (jp != pb.numpy()))[0]
    assert len(bad) <= MAX_GRAZE, f"{what}: bits differ on {bad.tolist()}"
    for i in bad:
        assert _nearest_graze(js, o, d, i) < GRAZE, f"{what}: ray {i} differs"


@pytest.mark.parametrize("name", list(SCENES))
def test_closest_perray_plain_matches_pallas(name):
    js, ps = _scene(name)
    _, spread, zoff, _ = SCENES[name]
    o, d, tmin = _rays(5, 1500, spread, zoff)
    _closest_matches_pallas(js, ps, o, d, tmin, name)


@pytest.mark.parametrize("name", list(SCENES))
def test_any_and_any_perray_plain_match_pallas(name):
    js, ps = _scene(name)
    _, spread, zoff, t_max = SCENES[name]
    o, d, tmin = _rays(7, 1500, spread, zoff)
    _any_matches_pallas(js, ps, o, d, tmin, t_max, np.arange(1500) % 5 != 0, name)


def _box_face_rays(js, n, seed):
    """n rays whose origins lie exactly on a plane of a cluster box (a
    random cluster, axis and side; the other two coordinates inside the
    box), half pointing into the box through that face and half out of
    it: their entries into that box are zeros, which the CUDA kernels
    order by bit pattern."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(js.cluster_bmin), np.asarray(js.cluster_bmax)
    k = rng.integers(0, lo.shape[0], n)
    axis = rng.integers(0, 3, n)
    on_hi = rng.random(n) < 0.5
    rows = np.arange(n)
    o = (lo[k] + rng.random((n, 3)).astype(np.float32) * (hi[k] - lo[k])).astype(np.float32)
    o[rows, axis] = np.where(on_hi, hi[k, axis], lo[k, axis])
    d = rng.normal(size=(n, 3))
    inward = rng.random(n) < 0.5
    d[rows, axis] = np.abs(d[rows, axis]) * np.where(on_hi == inward, -1.0, 1.0)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (np.ascontiguousarray(o.T), np.ascontiguousarray(d.T),
            np.full(n, 1e-3, np.float32))


FACE_SCENES = ("spheres900", "spheres+cylinders", "two-level 160x128 spheres")


@pytest.mark.parametrize("name", FACE_SCENES)
def test_box_face_rays_match_pallas(name):
    """Rays that start on cluster box planes: the plain per-ray walk that
    the CUDA kernels are held to on the card, against the Pallas per-ray
    kernels."""
    js, ps = _scene(name)
    o, d, tmin = _box_face_rays(js, 1500, 43)
    _closest_matches_pallas(js, ps, o, d, tmin, f"{name} box faces")
    _any_matches_pallas(js, ps, o, d, tmin, SCENES[name][3], np.ones(1500, bool),
                        f"{name} box faces")


def _copy_cluster(js, a, b, grow):
    """js with cluster b's primitives replaced by cluster a's and b's box
    a's grown by `grow` on every side: each hit in a is then an exact t tie
    with the same slot of b."""
    c = js.cluster_size
    edit = {name: np.array(getattr(js, name))
            for name in ("cluster_prims", "cluster_soa", "cluster_attr", "cluster_color",
                         "cluster_bmin", "cluster_bmax")}
    for name in ("cluster_prims", "cluster_soa", "cluster_attr"):
        edit[name][b] = edit[name][a]
    edit["cluster_color"][b * c:(b + 1) * c] = edit["cluster_color"][a * c:(a + 1) * c]
    edit["cluster_bmin"][b] = edit["cluster_bmin"][a] - grow
    edit["cluster_bmax"][b] = edit["cluster_bmax"][a] + grow
    return dataclasses.replace(js, **edit)


def _rays_at_cluster(js, a, n, seed):
    """n rays from outside cluster a's box toward its spheres' centres."""
    rng = np.random.default_rng(seed)
    p = np.asarray(js.cluster_prims)[a]
    centres = p[p[:, 11] == 1.0][:, :3]
    size = float(np.linalg.norm(np.asarray(js.cluster_bmax)[a] - np.asarray(js.cluster_bmin)[a]))
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = (centres[np.arange(n) % len(centres)] + u * (1.01 * size + 0.1)).astype(np.float32)
    return (np.ascontiguousarray(o.T), np.ascontiguousarray((-u).T.astype(np.float32)),
            np.full(n, 1e-3, np.float32))


@pytest.mark.parametrize("grow", [0.0, 0.5], ids=["same box", "grown box"])
def test_cross_cluster_ties(grow):
    """Cluster 0 copied into the last cluster: every ray that ends in
    cluster 0 ties exactly with the copy's same slot, and the port's
    lexicographic (t, row) rule keeps cluster 0's lower row in both walks.
    With the same box both walks visit cluster 0 first (equal entries,
    lowest cluster first) and the Pallas per-ray kernel's rule (strict <
    per lane slot in visiting order, then the lowest packed row) keeps it
    too, so the two are compared. With the copy's box grown, rays enter the
    copy first and the Pallas rule keeps the copy's row: the rules cannot
    agree there (ROADMAP Queue 3, first entry), so the port's per-ray walk
    is held to its index-order walk (closest_plain), and the Pallas rows to
    the copy's, ray by ray."""
    js0, _ = _scene("spheres900")
    a, b = 0, js0.num_clusters - 1
    js = _copy_cluster(js0, a, b, grow)
    ps = scene_from_numpy(numpy_fields(js), device="cpu")
    o, d, tmin = _rays_at_cluster(js, a, 1500, 41)
    if grow == 0.0:
        pr = _closest_matches_pallas(js, ps, o, d, tmin, "ties, same box")
    else:
        pt, pr = T.trace_closest(ps, _p3(o), _p3(d), torch.as_tensor(tmin), perray=True)
        bt, br = T.closest_plain(ps.trace_operands, T.closest_operand(
            _p3(o), _p3(d), torch.as_tensor(tmin), None, ps.trace_operands.mid),
            *T.clip_operand(None, ps.trace_operands))
        assert torch.equal(pr, br) and torch.equal(pt.view(torch.int32), bt.view(torch.int32))
        pr = pr.numpy()
        jr = np.asarray(PS.trace_closest(js, _j3(o), _j3(d), jnp.asarray(tmin),
                                         interpret=True, perray=True)[1])
        copy_rows = np.where(pr // 128 == a, pr + (b - a) * 128, pr)
        _assert_rows(js, o, d, jr, copy_rows, "ties, grown box")
    assert int((pr // 128 == a).sum()) > 1000
    assert not (pr // 128 == b).any()


def test_clip_perray_plain_matches_pallas():
    js, ps = _scene("triangles400")
    o, d, tmin = _rays(3, 1024, 3.0, 12.0)
    clip = ((0.0, 1.0, 0.0), 0.0, 1.0)
    jclip = (np.array(clip[0], np.float32), np.float32(0.0), np.float32(1.0))
    jt, jr = PS.trace_closest(js, _j3(o), _j3(d), jnp.asarray(tmin), clip=jclip,
                              interpret=True, perray=True)
    pt, pr = T.trace_closest(ps, _p3(o), _p3(d), torch.as_tensor(tmin), clip=clip,
                             perray=True)
    bt, br = T.trace_closest(ps, _p3(o), _p3(d), torch.as_tensor(tmin), clip=clip)
    assert torch.equal(pr, br) and torch.equal(pt, bt)
    bad = _assert_rows(js, o, d, np.asarray(jr), pr.numpy(), "clip")
    keep = np.ones(1024, bool)
    keep[bad] = False
    np.testing.assert_allclose(pt.numpy()[keep], np.asarray(jt)[keep], rtol=T_RTOL)


@pytest.mark.parametrize("name", list(SCENES))
def test_routing_matches_jax_predicates(name, monkeypatch):
    """wf_trace_closest_v3(secondary=True) and wf_trace_any_v3(divergent=True)
    take the per-ray walk exactly where the JAX package's predicates send
    the trace per-ray; primaries and co-directional batches never do."""
    js, ps = _scene(name)
    for env_knob in ("WRT_PERRAY", "WRT_PERRAY_ANY", "WRT_PERRAY_TRIMIX"):
        monkeypatch.delenv(env_knob, raising=False)
    calls = []
    real_c, real_a = T.trace_closest, T.trace_any

    def spy(tag, real):
        return lambda *a, **k: (k.get("perray") and calls.append(tag)) or real(*a, **k)

    monkeypatch.setattr(T, "trace_closest", spy("closest", real_c))
    monkeypatch.setattr(T, "trace_any", spy("any", real_a))
    o, d, tmin = _rays(9, 64, *SCENES[name][1:3])
    for secondary in (False, True):
        calls.clear()
        PW.wf_trace_closest_v3(ps, _p3(o), _p3(d), torch.as_tensor(tmin),
                               secondary=secondary)
        want = secondary and PS.perray_auto_secondary(js)
        assert calls == (["closest"] if want else []), (secondary, calls)
        calls.clear()
        PW.wf_trace_any_v3(ps, _p3(o), _p3(d), torch.as_tensor(tmin),
                           divergent=secondary)
        want = PS.perray_auto_any(js, secondary)
        assert calls == (["any"] if want else []), (secondary, calls)
    assert T.perray_supported(ps) == PS.perray_supported(js)
    assert T.perray_types(ps) == PS._perray_mode(js)[1]
    if name.startswith(("routing", "two-level")):
        assert T.perray_auto_secondary(ps)


if __name__ == "__main__":
    # Report the rays that differ from the Pallas kernels in the tests'
    # batches, from the repository root: PYTHONPATH=. python tests/test_torch_perray.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name, (_, spread, zoff, t_max) in SCENES.items():
        js, ps = _scene(name)
        o, d, tmin = _rays(5, 1500, spread, zoff)
        jr = np.asarray(PS.trace_closest(js, _j3(o), _j3(d), jnp.asarray(tmin),
                                         interpret=True, perray=True)[1])
        pr = T.trace_closest(ps, _p3(o), _p3(d), torch.as_tensor(tmin), perray=True)[1]
        rows = [(int(i), int(jr[i]), int(pr[i])) for i in np.nonzero(jr != pr.numpy())[0]]
        o, d, tmin = _rays(7, 1500, spread, zoff)
        lo = np.full(1500, 0.01, np.float32)
        act = np.arange(1500) % 5 != 0
        jb = np.asarray(PS.trace_any(js, _j3(o), _j3(d), jnp.asarray(tmin), t_max=t_max,
                                     accept_min=jnp.asarray(lo), active=jnp.asarray(act),
                                     interpret=True))
        pb = T.trace_any(ps, _p3(o), _p3(d), torch.as_tensor(tmin), t_max=t_max,
                         accept_min=torch.as_tensor(lo), active=torch.as_tensor(act))
        bits = np.nonzero(jb != pb.numpy())[0].tolist()
        print(f"{name}: K={ps.num_clusters}; closest rows differ (ray, pallas, port): "
              f"{rows}; occlusion bits differ on rays {bits}")
