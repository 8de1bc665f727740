"""The port's cluster tracer (webgl_raytracer_tpu_torch.ops.trace and
.wavefront) against the JAX package.

The plain versions of the two kernels are held to the Pallas kernels they
replace, run in interpret mode as tests/test_any3.py runs them: hit rows
and occlusion bits exactly, t within rtol 2e-4. That t tolerance is the
one the JAX package holds its Pallas kernel to against its XLA path
(tests/test_pallas.py): XLA's CPU backend contracts a*b+c into FMAs, the
port (and its kernels, built -fmad=false) rounds every product, and the
sphere discriminant b*b - c cancels for distant spheres, which turns that
one rounding into up to ~6e-5 relative in t. The eager JAX helpers
(cluster_entry_t, intersect_soa_t) round op by op and agree exactly.

The CUDA kernels themselves run only on a GPU:
tests/test_torch_kernels_cuda.py compares them with the plain versions
there and skips elsewhere.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webgl_raytracer_tpu.ops.pallas_trace as PS
import webgl_raytracer_tpu.ops.wavefront as JW
from webgl_raytracer_tpu.models import get_builtin_molecule, molecule_to_geometry
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
CLIP = ((0.0, 0.0, 1.0), 0.5, 1.0)


def _sphere_geometry():
    rng = np.random.default_rng(11)
    n = 400
    centers = (rng.random((n, 3)).astype(np.float32) - 0.5) * 14
    radii = (0.15 + rng.random(n) * 0.3).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    z3 = np.zeros((0, 3), np.float32)
    z1 = np.zeros((0,), np.float32)
    return Geometry(centers, radii, colors, z3, z3, z1, z3), None


def _mixed_geometry():
    tv = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                   [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)
    return molecule_to_geometry(get_builtin_molecule("caffeine")), tv


@pytest.fixture(scope="module", params=["spheres400", "caffeine+tris"])
def scenes(request):
    geo, tv = _sphere_geometry() if request.param == "spheres400" else _mixed_geometry()
    js = j_compile(geo, tri_verts=tv)
    return js, scene_from_numpy(numpy_fields(js), device="cpu")


def _fan(n, seed, spread=0.05):
    """Co-origin rays (the cone-light shadow shape) and candidate masks,
    as numpy."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32) * 3
    o[2] += 10
    base = rng.normal(size=(3, n)).astype(np.float32)
    base[2] -= 1.2
    base /= np.linalg.norm(base, axis=0, keepdims=True)
    ds, acts = [], []
    for _ in range(3):
        d = base + rng.normal(size=(3, n)).astype(np.float32) * spread
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        ds.append(d)
        acts.append(rng.random(n) < 0.6)
    return o, ds, acts, np.full(n, 1e-3, np.float32)


def _j3(a):
    return tuple(jnp.asarray(a[i]) for i in range(3))


def _p3(a):
    return tuple(torch.as_tensor(np.ascontiguousarray(a[i])) for i in range(3))


def _jclip(clip):
    if clip is None:
        return None
    return (tuple(np.float32(c) for c in clip[0]), np.float32(clip[1]),
            np.float32(clip[2]))


@pytest.mark.parametrize("clip", [None, CLIP], ids=["noclip", "clip"])
def test_trace_closest_plain_matches_pallas(scenes, clip):
    js, ps = scenes
    o, ds, acts, tmin = _fan(1500, 7)
    jt, jr = PS.trace_closest(js, _j3(o), _j3(ds[0]), jnp.asarray(tmin),
                              clip=_jclip(clip), active=jnp.asarray(acts[0]),
                              interpret=True)
    pt, pr = T.trace_closest(ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin),
                             clip=clip, active=torch.as_tensor(acts[0]))
    jt, jr = np.asarray(jt), np.asarray(jr)
    assert (pr >= 0).sum() > 50
    assert np.array_equal(jr, pr.numpy())
    np.testing.assert_allclose(pt.numpy(), jt, rtol=T_RTOL)


@pytest.mark.parametrize("clip", [None, CLIP], ids=["noclip", "clip"])
def test_trace_any3_plain_matches_pallas(scenes, clip):
    js, ps = scenes
    o, ds, acts, tmin = _fan(1500, 9)
    lo = np.full(1500, 0.01, np.float32)
    jocc = PS.trace_any3(js, _j3(o), tuple(_j3(d) for d in ds), jnp.asarray(tmin),
                         accept_min=jnp.asarray(lo), clip=_jclip(clip),
                         actives=tuple(jnp.asarray(a) for a in acts),
                         interpret=True)
    pocc = T.trace_any3(ps, _p3(o), tuple(_p3(d) for d in ds), torch.as_tensor(tmin),
                        accept_min=torch.as_tensor(lo), clip=clip,
                        actives=tuple(torch.as_tensor(a) for a in acts))
    for j in range(3):
        assert np.asarray(jocc[j]).sum() > 20
        assert np.array_equal(np.asarray(jocc[j]), pocc[j].numpy()), f"direction {j}"


def test_cluster_entry_and_intersector_exact(scenes):
    """The plain versions' building blocks round exactly like the JAX
    package's own (eager) helpers on the same centred operands."""
    js, ps = scenes
    o, ds, _, tmin = _fan(700, 3)
    ops = T.scene_operands(ps)
    mid = ops.mid.numpy()
    oc = o - mid[:, None]
    jent = JW.cluster_entry_t(jnp.asarray(ops.box[:, :3].numpy()),
                              jnp.asarray(ops.box[:, 3:].numpy()), _j3(oc), _j3(ds[0]))
    pent = PW.cluster_entry_t(ops.box[:, :3], ops.box[:, 3:], _p3(oc), _p3(ds[0]))
    assert np.array_equal(np.asarray(jent), pent.numpy())
    for k in range(ps.num_clusters):
        soa = ops.soa[k]
        jt = JW.intersect_soa_t(js, jnp.asarray(soa.numpy()), _j3(oc), _j3(ds[0]),
                                jnp.asarray(tmin), None)
        pt = PW.intersect_soa_t(ops.types, soa, _p3(oc), _p3(ds[0]),
                                torch.as_tensor(tmin), None)
        assert np.array_equal(np.asarray(jt), pt.numpy()), f"cluster {k}"


@pytest.mark.parametrize("refine", [False, True], ids=["raw", "refine_sphere_t"])
def test_finalize_hit_matches_jax(scenes, refine):
    js, ps = scenes
    o, ds, acts, tmin = _fan(1500, 7)
    jt, jr = PS.trace_closest(js, _j3(o), _j3(ds[0]), jnp.asarray(tmin),
                              active=jnp.asarray(acts[0]), interpret=True)
    cost = np.zeros(1500, np.int32)
    jrec = JW._finalize_hit(js, _j3(o), _j3(ds[0]), jnp.asarray(tmin), None, jt, jr,
                            cost=jnp.asarray(cost), refine_sphere_t=refine)
    prec = PW._finalize_hit(ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin), None,
                            torch.as_tensor(np.array(jt)),
                            torch.as_tensor(np.array(jr)),
                            cost=torch.as_tensor(cost), refine_sphere_t=refine)
    for f in ("prim_type", "prim_local", "prim_slot", "cost"):
        assert np.array_equal(np.asarray(getattr(jrec, f)), getattr(prec, f).numpy()), f
    np.testing.assert_allclose(prec.t.numpy(), np.asarray(jrec.t), rtol=T_RTOL)
    np.testing.assert_allclose(prec.extra.numpy(), np.asarray(jrec.extra),
                               rtol=T_RTOL, atol=1e-5)


def test_cpu_tensors_never_launch(scenes):
    _, ps = scenes
    o, ds, acts, tmin = _fan(256, 5)
    before = dict(T.launches)
    T.trace_closest(ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin))
    T.trace_any3(ps, _p3(o), tuple(_p3(d) for d in ds), torch.as_tensor(tmin),
                 actives=tuple(torch.as_tensor(a) for a in acts))
    assert T.launches == before
    with pytest.raises(ValueError):
        T.trace_closest(ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin), impl="cuda")



@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("clip", [None, CLIP], ids=["noclip", "clip"])
def test_trace_closest_attrs_plain_matches_pallas(scenes, clip, masked):
    """The attrs walk's plain version against the Pallas attrs kernel in
    interpret mode: slot column and every attribute column exactly (the
    JAX kernel extracts the row with an exact one-hot product), t within
    T_RTOL; and against the JAX package's gather_attr_rows of the same
    winners, which the plain version's gather must equal."""
    js, ps = scenes
    o, ds, acts, tmin = _fan(1500, 29)
    act = acts[1] if masked else None
    jt, ja = PS.trace_closest_attrs(js, _j3(o), _j3(ds[0]), jnp.asarray(tmin),
                                    clip=_jclip(clip),
                                    active=None if act is None else jnp.asarray(act),
                                    interpret=True)
    pt, pa = T.trace_closest_attrs(ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin),
                                   clip=clip,
                                   active=None if act is None else torch.as_tensor(act))
    ja, pa = np.asarray(ja), pa.numpy()
    hit = pa[:, 11] >= 0
    assert hit.sum() > 50
    assert np.array_equal(ja, pa)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=T_RTOL)
    # Misses, inactive lanes included: zeros, column 11 = -1, t = BIG.
    assert (pa[~hit, 11] == -1.0).all() and (np.delete(pa[~hit], 11, axis=1) == 0).all()
    assert (pt.numpy()[~hit] == np.float32(1e20)).all()
    # The plain walk is trace_closest's walk, and its rows are the gather.
    tt, tr = T.trace_closest(ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin), clip=clip,
                             active=None if act is None else torch.as_tensor(act))
    assert torch.equal(pt, tt)
    assert np.array_equal(np.where(hit, pa[:, 28].astype(np.int64), -1), tr.numpy())
    jrec = JW._finalize_hit(js, _j3(o), _j3(ds[0]), jnp.asarray(tmin), None,
                            jnp.asarray(tt.numpy()), jnp.asarray(tr.numpy()),
                            cost=jnp.zeros(1500, jnp.int32))
    # As device arrays, as the JAX package holds them: its gathers clamp
    # the side-table index of non-triangle lanes.
    jsd = dataclasses.replace(js, tri_normals=jnp.asarray(js.tri_normals),
                              tri_flags=jnp.asarray(js.tri_flags))
    assert np.array_equal(np.asarray(JW.gather_attr_rows(jsd, jrec)), pa)


def test_finalize_hit_row_equals_gather(scenes):
    """_finalize_hit with the attrs kernel's rows equals _finalize_hit
    with its own gather, field by field, bit for bit."""
    _, ps = scenes
    o, ds, acts, tmin = _fan(1500, 31)
    args = (ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin), None)
    t, attrs = T.trace_closest_attrs(ps, *args[1:4], active=torch.as_tensor(acts[0]))
    slot = T.attr_slot(attrs)
    a = PW._finalize_hit(*args, t, slot, cost=None, refine_sphere_t=True,
                         row=attrs[:, :12])
    b = PW._finalize_hit(*args, t, slot, cost=None, refine_sphere_t=True)
    assert int((slot >= 0).sum()) > 50
    for f in ("t", "prim_type", "prim_local", "prim_slot", "extra"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _interval_edges(t):
    """(accept_lo, t_max, window) per ray around t, its closest hit: ray i
    takes window i mod 6 of (0, t+), (0, t), (0, t-), (t-, t+), (t, BIG),
    (t+, BIG), where t+ and t- are the floats one ulp above and below t."""
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    down = torch.nextafter(t, torch.zeros_like(t))
    zero, big = torch.zeros_like(t), torch.full_like(t, 1e20)
    lo = torch.stack([zero, zero, zero, down, t, up])
    hi = torch.stack([up, t, down, up, big, big])
    window = torch.arange(t.shape[0]) % 6
    return lo.gather(0, window[None])[0], hi.gather(0, window[None])[0], window


@pytest.mark.parametrize("clip", [None, CLIP], ids=["noclip", "clip"])
def test_any_plain_matches_pallas_on_interval_edges(scenes, clip):
    """Occlusion windows one ulp around or at each hit ray's closest t (the
    port's): any_plain and the per-ray walk against the Pallas
    `_make_any_kernel` in interpret mode. The Pallas kernel's own t of the
    same primitive can differ from the port's by a few ulps (XLA's CPU code
    contracts FMAs; T_RTOL), which moves it across a one-ulp edge; so a ray
    may differ only where the Pallas closest t lies on the other side of
    its window than the port's, and there the Pallas bit is that side.
    Windows that end at or below t occlude no ray; windows that hold t
    occlude every ray."""
    js, ps = scenes
    o, ds, acts, tmin = _fan(1500, 37)
    pt, pr = T.trace_closest(ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin), clip=clip)
    keep = np.nonzero(pr.numpy() >= 0)[0]
    o, d, tmin, t = o[:, keep], ds[0][:, keep], tmin[keep], pt[keep]
    lo, hi, window = _interval_edges(t)
    kw = dict(t_max=hi, accept_min=lo, clip=clip)
    pb = T.trace_any(ps, _p3(o), _p3(d), torch.as_tensor(tmin), **kw)
    assert torch.equal(pb, T.trace_any(ps, _p3(o), _p3(d), torch.as_tensor(tmin), perray=True,
                                       **kw))
    jb = np.asarray(PS.trace_any(js, _j3(o), _j3(d), jnp.asarray(tmin),
                                 t_max=jnp.asarray(hi.numpy()),
                                 accept_min=jnp.asarray(lo.numpy()), clip=_jclip(clip),
                                 interpret=True))
    jt = np.asarray(PS.trace_closest(js, _j3(o), _j3(d), jnp.asarray(tmin), clip=_jclip(clip),
                                     interpret=True)[0])
    pb, t, lo, hi, window = pb.numpy(), t.numpy(), lo.numpy(), hi.numpy(), window.numpy()
    assert len(keep) > 50
    for w in (1, 2):
        assert not pb[window == w].any()
    for w in (0, 3):
        assert pb[window == w].all()
    np.testing.assert_allclose(jt, t, rtol=T_RTOL)
    inside, inside_j = (lo < t) & (t < hi), (lo < jt) & (jt < hi)
    assert (inside != inside_j).any()
    assert np.array_equal(jb, np.where(inside != inside_j, inside_j, pb))


def test_trace_closest_attrs_ragged_miss_rows_match_pallas(scenes):
    """A ragged batch (1,013 rays: 31 warps of 32 and one of 21) with
    inactive lanes: the plain attrs version's rows against the Pallas attrs
    kernel's in interpret mode, equal in value, and its miss rows (inactive
    lanes included) +0.0 with column 11 = -1, bit for bit, with t = BIG on
    both sides. The Pallas kernel's one-hot extraction leaves -0.0 in the
    miss rows of active lanes, equal in value."""
    js, ps = scenes
    o, ds, acts, tmin = _fan(1013, 41)
    act = acts[2]
    jt, ja = PS.trace_closest_attrs(js, _j3(o), _j3(ds[0]), jnp.asarray(tmin),
                                    active=jnp.asarray(act), interpret=True)
    pt, pa = T.trace_closest_attrs(ps, _p3(o), _p3(ds[0]), torch.as_tensor(tmin),
                                   active=torch.as_tensor(act))
    jt, ja, pt, pa = np.asarray(jt), np.asarray(ja), pt.numpy(), pa.numpy()
    miss = pa[:, 11] < 0
    assert miss[~act].all() and (~act).sum() > 300
    assert 20 < (~miss).sum() < act.sum()
    miss_row = np.zeros(32, np.float32)
    miss_row[11] = -1.0
    assert (pa[miss].view(np.int32) == miss_row.view(np.int32)).all()
    assert (pt[miss] == np.float32(1e20)).all() and (jt[miss] == np.float32(1e20)).all()
    assert np.array_equal(ja, pa)
