"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Needs an NVIDIA GPU and nvcc; every test here is marked `cuda` and skips
without a CUDA device. The file imports neither JAX nor the JAX package's
device code, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Kernels and plain versions round identically (-fmad=false), so rows,
occlusion bits and t must agree bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from webgl_raytracer_tpu_torch.env import EnvironmentController
from webgl_raytracer_tpu_torch.models import Geometry
from webgl_raytracer_tpu_torch.ops import trace as T
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render.integrator import generate_camera_rays
from webgl_raytracer_tpu_torch.scene import (compile_scene, molecule_geometry,
                                             random_sphere_geometry)

pytestmark = pytest.mark.cuda

TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)


# A full batch, and one whose last warp is ragged (1013 = 31 * 32 + 21).
BATCHES = pytest.mark.parametrize("n", [1 << 16, 1013], ids=["full", "ragged"])


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _compile(name, device):
    if name == "spheres400":
        return compile_scene(random_sphere_geometry(400, seed=11), device=device)
    if name == "spheres20k":
        return compile_scene(random_sphere_geometry(20000, seed=11), device=device)
    if name == "spheres10k":
        return compile_scene(random_sphere_geometry(10000), device=device)
    if name == "spheres+cylinders+tris":
        # Over 64 clusters of all three types: the ray-major shadow fan.
        g = random_sphere_geometry(9000, seed=5)
        rng = np.random.default_rng(5)
        p1 = ((rng.random((300, 3)) - 0.5) * 40).astype(np.float32)
        p2 = p1 + rng.normal(size=(300, 3)).astype(np.float32)
        return compile_scene(Geometry(
            g.sphere_centers, g.sphere_radii, g.sphere_colors, p1, p2,
            np.full(300, 0.2, np.float32), np.full((300, 3), 0.5, np.float32)),
            tri_verts=TRIS, device=device)
    return compile_scene(molecule_geometry("caffeine"), tri_verts=TRIS, device=device)


@pytest.fixture(scope="module", params=["spheres400", "caffeine+tris"])
def scene(request, device):
    return _compile(request.param, device)


@pytest.fixture(scope="module", params=["spheres400", "caffeine+tris", "spheres20k"])
def any_scene(request, device):
    """Scenes for the per-ray kernels: spheres20k has more than 128
    clusters (the two-level walk)."""
    return _compile(request.param, device)


@pytest.fixture(scope="module", params=["spheres400", "caffeine+tris", "spheres10k",
                                        "spheres+cylinders+tris", "spheres20k"])
def occlusion_scene(request, device):
    """Scenes for trace_any and trace_any_perray: spheres10k (K = 128),
    spheres+cylinders+tris (K = 124, three types) and spheres20k take
    trace_any's ray-major schedule, the others its cluster-major one;
    spheres20k is the per-ray kernel's two-level walk."""
    return _compile(request.param, device)


def _fan(n, seed, device, spread=0.05):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n)).astype(np.float32) * 3
    o[2] += 10
    base = rng.normal(size=(3, n)).astype(np.float32)
    base[2] -= 1.2
    base /= np.linalg.norm(base, axis=0, keepdims=True)
    d3s, acts = [], []
    for _ in range(3):
        d = base + rng.normal(size=(3, n)).astype(np.float32) * spread
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        d3s.append(tuple(torch.as_tensor(d[i], device=device) for i in range(3)))
        acts.append(torch.as_tensor(rng.random(n) < 0.6, device=device))
    o3 = tuple(torch.as_tensor(o[i], device=device) for i in range(3))
    return o3, tuple(d3s), tuple(acts), torch.full((n,), 1e-3, device=device)


@pytest.fixture(scope="module", params=["spheres400", "caffeine+tris", "spheres10k",
                                        "spheres+cylinders+tris"])
def trace_scene(request, device):
    """Scenes for the warp-cooperative kernels: spheres10k has K = 128,
    spheres+cylinders+tris over 64 clusters of the three types (the
    shadow fan's ray-major schedule)."""
    return _compile(request.param, device)


@BATCHES
@pytest.mark.parametrize("clip", [None, ((0.0, 0.0, 1.0), 0.5, 1.0)],
                         ids=["noclip", "clip"])
def test_trace_closest_kernel_matches_plain(trace_scene, device, clip, n):
    o3, d3s, acts, tmin = _fan(n, 13, device)
    before = T.launches["trace_closest"]
    tk, rk = T.trace_closest(trace_scene, o3, d3s[0], tmin, clip=clip, active=acts[0])
    assert T.launches["trace_closest"] == before + 1
    tp, rp = T.trace_closest(trace_scene, o3, d3s[0], tmin, clip=clip, active=acts[0],
                             impl="plain")
    assert T.launches["trace_closest"] == before + 1
    assert int((rk >= 0).sum()) > n // 50
    assert torch.equal(rk, rp)
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))


def test_trace_closest_kernel_breaks_exact_ties_by_lowest_row(device):
    """Every sphere twice: each hit is an exact tie in t between two rows
    of one cluster, settled by the lowest row as in the plain version."""
    g = random_sphere_geometry(500, seed=3)
    twins = compile_scene(Geometry(
        np.repeat(g.sphere_centers, 2, axis=0), np.repeat(g.sphere_radii, 2),
        np.repeat(g.sphere_colors, 2, axis=0), g.cyl_p1, g.cyl_p2, g.cyl_radii,
        g.cyl_colors), device=device)
    r = Renderer(twins, width=160, height=120, device=device)
    flags, u, px, py = r.frame_inputs()
    _, o3, d3 = generate_camera_rays(u, flags, px, py, 0, 0)
    tmin = u.t_min.expand(px.shape[0])
    tk, rk = T.trace_closest(twins, o3, d3, tmin)
    tp, rp = T.trace_closest(twins, o3, d3, tmin, impl="plain")
    assert int((rk >= 0).sum()) > 100
    assert torch.equal(rk, rp)
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))


def _sphere_centres(scene, n, device):
    """Origins at the scene's sphere centres (each ray starts inside a
    sphere, so every direction is occluded), cycled to n lanes."""
    p = scene.cluster_prims.reshape(-1, 12)
    c = p[p[:, 11] == 1.0][:, :3]
    c = c[torch.arange(n, device=device) % c.shape[0]]
    return tuple(c[:, i].contiguous() for i in range(3))


@BATCHES
@pytest.mark.parametrize("masks", ["random", "one direction", "none", "all occluded"])
@pytest.mark.parametrize("clip", [None, ((0.0, 0.0, 1.0), 0.5, 1.0)],
                         ids=["noclip", "clip"])
def test_trace_any3_kernel_matches_plain(trace_scene, device, clip, masks, n):
    o3, d3s, acts, tmin = _fan(n, 17, device)
    none = torch.zeros_like(acts[0])
    if masks == "one direction":
        acts = (none, acts[1], none)
    elif masks == "none":
        acts = (none, none, none)
    elif masks == "all occluded":
        o3 = _sphere_centres(trace_scene, n, device)
        acts = (None, None, None)
    lo = torch.full_like(tmin, 0.01)
    before = T.launches["trace_any3"]
    ok = T.trace_any3(trace_scene, o3, d3s, tmin, accept_min=lo, clip=clip, actives=acts)
    assert T.launches["trace_any3"] == before + 1
    op = T.trace_any3(trace_scene, o3, d3s, tmin, accept_min=lo, clip=clip, actives=acts,
                      impl="plain")
    for j, (a, b) in enumerate(zip(ok, op)):
        assert torch.equal(a, b)
        live = acts[j] is None or bool(acts[j].any())
        if masks == "all occluded":
            assert bool(a.all())
        elif live:
            assert int(a.sum()) > n // 50
        else:
            assert not bool(a.any())


def test_frame_kernel_matches_plain(scene, device):
    images = []
    for impl in (None, "plain"):
        r = Renderer(scene, width=96, height=64, device=device, impl=impl)
        r.render_frames(2)
        images.append(r._accum)
    assert torch.equal(images[0], images[1])
    assert float(images[0].mean()) > 0.0


def _interval_edges(t):
    """(accept_lo, t_max, window) per ray around t, its closest hit: ray i
    takes window i mod 6 of (0, t+), (0, t), (0, t-), (t-, t+), (t, BIG),
    (t+, BIG), where t+ and t- are the floats one ulp above and below t."""
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    down = torch.nextafter(t, torch.zeros_like(t))
    zero, big = torch.zeros_like(t), torch.full_like(t, 1e20)
    lo = torch.stack([zero, zero, zero, down, t, up])
    hi = torch.stack([up, t, down, up, big, big])
    window = torch.arange(t.shape[0], device=t.device) % 6
    return lo.gather(0, window[None])[0], hi.gather(0, window[None])[0], window


@BATCHES
@pytest.mark.parametrize("rays", ["fan", "interval edges"])
@pytest.mark.parametrize("clip", [None, ((0.0, 0.0, 1.0), 0.5, 1.0)],
                         ids=["noclip", "clip"])
def test_trace_any_kernels_match_plain(occlusion_scene, device, clip, rays, n):
    """trace_any and trace_any_perray: kernel == plain == each other. On
    interval-edge rays each ray's (accept_lo, t_max) lies one ulp around or
    at its closest hit t: a window that ends at or below t occludes no ray,
    and one that holds t nearly every hit ray."""
    o3, d3s, acts, tmin = _fan(n, 19, device, spread=1.0)
    kw = dict(t_max=25.0, accept_min=torch.full_like(tmin, 0.01), clip=clip,
              active=acts[0])
    if rays == "interval edges":
        t, row = T.trace_closest(occlusion_scene, o3, d3s[0], tmin, clip=clip, active=acts[0])
        lo, hi, window = _interval_edges(t)
        kw.update(t_max=hi, accept_min=lo)
    before = dict(T.launches)
    bk = T.trace_any(occlusion_scene, o3, d3s[0], tmin, **kw)
    pk = T.trace_any(occlusion_scene, o3, d3s[0], tmin, perray=True, **kw)
    assert T.launches["trace_any"] == before["trace_any"] + 1
    assert T.launches["trace_any_perray"] == before["trace_any_perray"] + 1
    bp = T.trace_any(occlusion_scene, o3, d3s[0], tmin, impl="plain", **kw)
    pp = T.trace_any(occlusion_scene, o3, d3s[0], tmin, perray=True, impl="plain", **kw)
    assert int(bk.sum()) > n // 500
    assert torch.equal(bk, bp) and torch.equal(pk, pp) and torch.equal(bk, pk)
    if rays == "interval edges":
        hit = row >= 0
        for w in (1, 2):
            assert not bool((bk & hit & (window == w)).any())
        for w in (0, 3):
            inside = hit & (window == w)
            assert int((bk & inside).sum()) >= 0.99 * int(inside.sum())


@BATCHES
@pytest.mark.parametrize("clip", [None, ((0.0, 0.0, 1.0), 0.5, 1.0)],
                         ids=["noclip", "clip"])
def test_trace_closest_perray_kernel_matches_plain_and_block(any_scene, device, clip, n):
    """On spheres20k (more than 128 clusters) the two-level walk; the
    ragged batch leaves lanes of the last warp without a ray."""
    o3, d3s, acts, tmin = _fan(n, 23, device, spread=1.0)
    before = T.launches["trace_closest_perray"]
    tk, rk = T.trace_closest(any_scene, o3, d3s[0], tmin, clip=clip, active=acts[0],
                             perray=True)
    assert T.launches["trace_closest_perray"] == before + 1
    tp, rp = T.trace_closest(any_scene, o3, d3s[0], tmin, clip=clip, active=acts[0],
                             perray=True, impl="plain")
    tb, rb = T.trace_closest(any_scene, o3, d3s[0], tmin, clip=clip, active=acts[0])
    assert int((rk >= 0).sum()) > n // 500
    for t, r in ((tp, rp), (tb, rb)):
        assert torch.equal(rk, r)
        assert torch.equal(tk.view(torch.int32), t.view(torch.int32))


def _copy_cluster(scene, a, b, grow):
    """The scene with cluster b's primitives replaced by cluster a's and
    b's box a's grown by `grow` on every side. Each hit in a is then an
    exact t tie with the same slot of b, which the lower row (a's) must
    win; with grow > 0 a ray from outside enters b first, so a per-ray
    walk finds the tie in the higher row first."""
    c = scene.cluster_size
    edit = {name: getattr(scene, name).clone()
            for name in ("cluster_prims", "cluster_soa", "cluster_attr", "cluster_color",
                         "cluster_bmin", "cluster_bmax")}
    for name in ("cluster_prims", "cluster_soa", "cluster_attr"):
        edit[name][b] = edit[name][a]
    edit["cluster_color"][b * c:(b + 1) * c] = edit["cluster_color"][a * c:(a + 1) * c]
    edit["cluster_bmin"][b] = edit["cluster_bmin"][a] - grow
    edit["cluster_bmax"][b] = edit["cluster_bmax"][a] + grow
    return dataclasses.replace(scene, **edit)


def _rays_at_cluster(scene, a, n, seed, device):
    """n rays from outside cluster a's box toward its spheres' centres."""
    rng = np.random.default_rng(seed)
    p = scene.cluster_prims[a].cpu().numpy()
    centres = p[p[:, 11] == 1.0][:, :3]
    size = float(np.linalg.norm((scene.cluster_bmax[a] - scene.cluster_bmin[a]).cpu().numpy()))
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = (centres[np.arange(n) % len(centres)] + u * (1.01 * size + 0.1)).astype(np.float32)
    d = (-u).astype(np.float32)
    return (tuple(torch.as_tensor(o[:, i], device=device) for i in range(3)),
            tuple(torch.as_tensor(d[:, i], device=device) for i in range(3)))


def _box_face_rays(scene, n, seed, device):
    """n rays whose origins lie exactly on a plane of a cluster box (a
    random cluster, axis and side; the other two coordinates inside the
    box), half pointing into the box through that face and half out of
    it. Their entry into that box is a zero, which fmaxf may give as
    -0.0."""
    rng = np.random.default_rng(seed)
    lo = scene.cluster_bmin.cpu().numpy()
    hi = scene.cluster_bmax.cpu().numpy()
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
    return (tuple(torch.as_tensor(o[:, i], device=device) for i in range(3)),
            tuple(torch.as_tensor(d[:, i], device=device) for i in range(3)))


def _perray_against_plain_and_block(scene, o3, d3, device):
    """Both per-ray kernels against their plain versions and the block
    kernels, bit for bit. Returns the per-ray kernel's rows."""
    n = o3[0].shape[0]
    tmin = torch.full((n,), 1e-3, device=device)
    before = dict(T.launches)
    tk, rk = T.trace_closest(scene, o3, d3, tmin, perray=True)
    fk = T.trace_any(scene, o3, d3, tmin, t_max=25.0, accept_min=0.01, perray=True)
    assert T.launches["trace_closest_perray"] == before["trace_closest_perray"] + 1
    assert T.launches["trace_any_perray"] == before["trace_any_perray"] + 1
    for impl, per in (("plain", True), (None, False)):
        t, r = T.trace_closest(scene, o3, d3, tmin, perray=per, impl=impl)
        assert torch.equal(rk, r)
        assert torch.equal(tk.view(torch.int32), t.view(torch.int32))
        f = T.trace_any(scene, o3, d3, tmin, t_max=25.0, accept_min=0.01, perray=per,
                        impl=impl)
        assert torch.equal(fk, f)
    assert int(fk.sum()) > n // 50
    return rk


@pytest.mark.parametrize("grow", [0.0, 0.5], ids=["same box", "grown box"])
@pytest.mark.parametrize("name", ["spheres400", "spheres20k"])
def test_perray_kernels_settle_cross_cluster_ties(device, name, grow):
    """The lowest row wins an exact tie between two clusters, whichever the
    walk visits first; on spheres20k the two clusters lie in different
    groups (the two-level walk)."""
    scene = _compile(name, device)
    a, b = 0, scene.num_clusters - 1
    ties = _copy_cluster(scene, a, b, grow)
    o3, d3 = _rays_at_cluster(ties, a, 4000, 31, device)
    rk = _perray_against_plain_and_block(ties, o3, d3, device)
    assert int((rk // 128 == a).sum()) > 1000
    assert not bool((rk // 128 == b).any())


@pytest.mark.parametrize("name", ["spheres400", "caffeine+tris", "spheres20k"])
def test_perray_kernels_on_box_face_rays(device, name):
    scene = _compile(name, device)
    o3, d3 = _box_face_rays(scene, 4000, 37, device)
    rk = _perray_against_plain_and_block(scene, o3, d3, device)
    assert int((rk >= 0).sum()) > 250


def test_sky_frame_kernel_matches_plain(device):
    """A sky-lit 10k-sphere frame runs the per-ray kernels and equals the
    plain-traced frame."""
    scene = compile_scene(random_sphere_geometry(10000), device=device)
    env = EnvironmentController(device=device).load_analytic_sky(width=128, height=64)
    images = []
    before = dict(T.launches)
    for impl in (None, "plain"):
        r = Renderer(scene, env=env, width=64, height=48, device=device, impl=impl)
        r.settings.env_intensity = 0.4
        r.render_frames(2)
        images.append(r._accum)
    assert T.launches["trace_closest_perray"] > before["trace_closest_perray"]
    assert T.launches["trace_any_perray"] > before["trace_any_perray"]
    assert torch.equal(images[0], images[1])
    assert float(images[0].mean()) > 0.0


@BATCHES
@pytest.mark.parametrize("clip", [None, ((0.0, 0.0, 1.0), 0.5, 1.0)],
                         ids=["noclip", "clip"])
def test_trace_closest_attrs_kernel_matches_plain_and_closest(trace_scene, device, clip, n):
    """The attrs kernel: t and all 32 columns bit for bit against its plain
    version (miss rows, inactive lanes included: zeros with column 11 =
    -1); t and the winning slot against the trace_closest kernel."""
    o3, d3s, acts, tmin = _fan(n, 29, device)
    before = dict(T.launches)
    tk, ak = T.trace_closest_attrs(trace_scene, o3, d3s[0], tmin, clip=clip, active=acts[0])
    assert T.launches["trace_closest_attrs"] == before["trace_closest_attrs"] + 1
    tp, ap = T.trace_closest_attrs(trace_scene, o3, d3s[0], tmin, clip=clip, active=acts[0],
                                   impl="plain")
    tc, rc = T.trace_closest(trace_scene, o3, d3s[0], tmin, clip=clip, active=acts[0])
    assert T.launches["trace_closest_attrs"] == before["trace_closest_attrs"] + 1
    slot = T.attr_slot(ak)
    assert int((slot >= 0).sum()) > min(100, n // 50)
    assert not bool((slot[~acts[0]] >= 0).any())
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(ak.view(torch.int32), ap.view(torch.int32))
    assert torch.equal(tk.view(torch.int32), tc.view(torch.int32))
    assert torch.equal(slot, rc)


@pytest.mark.parametrize("iters", [0, 1, 7, 13, 16])
@pytest.mark.parametrize("rows", [1, 31, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sweep_sol_kernel_matches_plain(device, dtype, rows, iters):
    """The probe: f32 bit for bit; bf16 within chip_smoke.py's stated
    tolerance (at most 1% of rows differ, each within 2^-6 relative). Rows
    that fill no whole row group and iters off the 8-sweep centre cycle
    take the kernel's ragged edge and its remainder sweeps; 0 iters leaves
    1e20 on every row."""
    from webgl_raytracer_tpu_torch.tools import sweep_sol as SW

    a, s = SW.probe_inputs(device)
    a = a[:rows].contiguous()
    before = SW.launches["sweep_sol"]
    k = SW.sweep_sol(a, s, iters, dtype)
    assert SW.launches["sweep_sol"] == before + 1
    p = SW.sweep_sol(a, s, iters, dtype, impl="plain")
    assert k.shape == (rows,)
    if iters == 0:
        no_hit = torch.tensor(1e20, dtype=dtype).float().item()
        assert bool((p == no_hit).all())
    elif rows == 1024 and iters == 16:
        assert int((p < 1e19).sum()) > 512
    if dtype == torch.float32:
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    else:
        rel = (k - p).abs() / p.abs().clamp_min(1e-30)
        assert float(rel.max()) <= 2.0 ** -6
        assert int((k != p).sum()) <= 0.01 * k.numel()


@pytest.mark.parametrize("knobs", [{}, {"WRT_ATTRS": "1"}], ids=["binned", "attrs"])
def test_chunked_frame_equals_whole_batch(device, knobs, monkeypatch):
    """A 128x128 frame in four chunks (binned, or permuted with attrs rows)
    equals the whole-batch frame bit for bit, ray counts included."""
    from webgl_raytracer_tpu_torch.render.integrator import render_batch_stats

    scene = compile_scene(random_sphere_geometry(1000), device=device)
    r = Renderer(scene, width=128, height=128, device=device)
    flags, u, px, py = r.frame_inputs()
    out = {}
    for name, chunks in (("whole", "1"), ("chunked", "4")):
        monkeypatch.setenv("WRT_CHUNKS", chunks)
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        before = dict(T.launches)
        c, (nr, no) = render_batch_stats(scene, flags, u, px, py, 0)
        out[name] = (c, int(nr), int(no), {k: T.launches[k] - before[k] for k in before})
    assert torch.equal(out["whole"][0], out["chunked"][0])
    assert out["whole"][1:3] == out["chunked"][1:3]
    if knobs:
        assert out["chunked"][3]["trace_closest_attrs"] > 0
        assert out["chunked"][3]["trace_closest"] == 0


@pytest.mark.parametrize("name", ["caffeine+tris", "tstp cartoon"])
@pytest.mark.parametrize("clip_on", [False, True], ids=["no clip", "clip"])
def test_oracle_card_trace_matches_numpy_trace(device, name, clip_on):
    """The reference oracle's card trace (render/reference_oracle.py) gives
    its numpy trace's closest rows, t (bit for bit) and occlusion bits on
    the card: rays aimed at primitives, 20% masked."""
    from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
    from webgl_raytracer_tpu_torch.models import parse_auto_detect
    from webgl_raytracer_tpu_torch.render import reference_oracle as O

    if name == "tstp cartoon":
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "proteins", "TSTP.pdb")
        with open(path, encoding="utf-8") as f:
            mol = parse_auto_detect(f.read(), "TSTP.pdb")
        scene = load_molecule_scene(mol, display_style="cartoon", device=device).scene
    else:
        scene = _compile(name, device)
    prims = scene.cluster_prims.reshape(-1, 12).cpu().numpy()
    points = prims[prims[:, 11] >= 0, 0:3]
    clip = ((np.array([0.0, 0.0, 1.0], np.float32), float(np.median(points[:, 2])), 1.0)
            if clip_on else None)
    rng = np.random.default_rng(9)
    n = 4096
    mid, ext = points.mean(0), float(np.abs(points.max(0) - points.min(0)).max())
    o = mid + (rng.random((n, 3)) - 0.5) * ext * 1.5
    d = points[rng.integers(0, points.shape[0], n)] + rng.normal(0, 0.3, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o3 = tuple(o[:, i].astype(np.float32) for i in range(3))
    d3 = tuple(d[:, i].astype(np.float32) for i in range(3))
    mask = rng.random(n) < 0.8
    lo = np.full(n, 0.01, np.float32)
    hi = np.where(np.arange(n) % 2 == 0, O.BIG, np.float32(5.0)).astype(np.float32)
    host = O._NpScene(scene)
    card = O._NpScene(scene, device)
    with np.errstate(over="ignore", invalid="ignore"):
        t_np, row_np = O.trace_closest(host, o3, d3, 1e-4, clip, mask)
        any_np = O.trace_any(host, o3, d3, 1e-4, clip, lo, hi, mask)
    t_c, row_c = O.trace_closest(card, o3, d3, 1e-4, clip, mask)
    any_c = O.trace_any(card, o3, d3, 1e-4, clip, lo, hi, mask)
    assert int((row_np >= 0).sum()) >= 400
    assert np.array_equal(row_c, row_np)
    assert t_c.tobytes() == t_np.tobytes()
    assert np.array_equal(any_c, any_np)


# The frame loop on the card (render/frame.py): one frame captured as a
# CUDA graph and replayed.

GRAPH_TRANSPORTS = {"whole batch": {"WRT_CHUNKS": "1"}, "binned": {"WRT_CHUNKS": "4"},
                    "binned over its cap": {"WRT_CHUNKS": "4", "WRT_BIN_CAP_DIV": "64"},
                    "permuted": {"WRT_CHUNKS": "4", "WRT_BINNED": "0"},
                    "attrs": {"WRT_CHUNKS": "4", "WRT_ATTRS": "1"}}


def _set_knobs(monkeypatch, knobs):
    for k in ("WRT_CHUNKS", "WRT_BINNED", "WRT_BIN_CAP_DIV", "WRT_ATTRS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)


def _eager_frames(r, frames):
    """frames of r through render_batch_stats and the running mean written
    out: (accumulator, path rays, occlusion rays)."""
    from webgl_raytracer_tpu_torch.render.integrator import render_batch_stats

    flags, u, px, py = r.frame_inputs()
    acc, paths, occl = None, 0, 0
    for f in range(frames):
        color, (p, o) = render_batch_stats(r.scene, flags, u, px, py, f, env=r.env,
                                           vol=r.volume)
        acc = color if f == 0 else (acc * float(f) + color) / torch.tensor(
            f + 1.0, device=color.device)
        paths, occl = paths + int(p), occl + int(o)
    return acc, paths, occl


@pytest.mark.parametrize("transport", list(GRAPH_TRANSPORTS))
def test_capture_makes_no_host_sync(device, transport, monkeypatch):
    """The warm-up frame and the capture run under
    torch.cuda.set_sync_debug_mode("error"): no host sync on any
    transport's frame."""
    from webgl_raytracer_tpu_torch.ops.kernels import library

    _set_knobs(monkeypatch, GRAPH_TRANSPORTS[transport])
    scene = compile_scene(random_sphere_geometry(1000), device=device)
    r = Renderer(scene, width=256, height=256, device=device)
    flags = r._frame_setup()
    scene.trace_operands, library()           # built once, outside the frame
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r._captured(flags)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert r.stats["captures"] == 1


@pytest.mark.parametrize("transport", ["whole batch", "binned", "binned over its cap"])
def test_graph_frames_equal_eager_frames(device, transport, monkeypatch):
    """Two blocks (one frame, two frames) of graph replays at 256x256 equal
    three eager frames bit for bit, ray counts included; the kernels'
    launch counts grow by the replays; over its cap each block is redone
    through the permuted transport."""
    _set_knobs(monkeypatch, GRAPH_TRANSPORTS[transport])
    scene = compile_scene(random_sphere_geometry(1000), device=device)
    r = Renderer(scene, width=256, height=256, device=device)
    r.render_frames(1)
    before = dict(T.launches)
    r.render_frames(2)
    assert T.launches["trace_closest"] > before["trace_closest"]
    assert T.launches["trace_any3"] > before["trace_any3"]
    acc, paths, occl = _eager_frames(r, 3)
    assert torch.equal(r._accum, acc)
    assert r.ray_counts == (paths, occl)
    over = transport == "binned over its cap"
    assert r.stats == {"captures": 1, "overflowed_blocks": 2 if over else 0,
                       "redone_frames": 3 if over else 0}


@pytest.mark.parametrize("name", ["spheres400", "caffeine+tris", "spheres10k"])
def test_kernels_on_inactive_batches_miss(device, name):
    """Every kernel on a batch with no active lane: t BIG, row -1, the miss
    attribute row, no occlusion."""
    scene = _compile(name, device)
    o3, d3s, _, tmin = _fan(4096, 3, device)
    off = torch.zeros(4096, dtype=torch.bool, device=device)
    big = torch.full((4096,), float(np.float32(1e20)), device=device)
    for perray in (False, True):
        t, row = T.trace_closest(scene, o3, d3s[0], tmin, active=off, perray=perray)
        assert torch.equal(t, big) and bool((row == -1).all())
        assert not bool(T.trace_any(scene, o3, d3s[0], tmin, active=off,
                                    perray=perray).any())
    t, attrs = T.trace_closest_attrs(scene, o3, d3s[0], tmin, active=off)
    miss = torch.zeros((4096, 32), device=device)
    miss[:, T.ATTR_MISS_COL] = -1.0
    assert torch.equal(t, big) and torch.equal(attrs, miss)
    occ = T.trace_any3(scene, o3, d3s, tmin, actives=(off, off, off))
    assert not any(bool(x.any()) for x in occ)


def test_camera_change_refreshes_uniforms_without_recapture(device, monkeypatch):
    """A camera move between blocks reaches the captured frame through the
    uniform buffer: no recapture, and the frames equal eager frames of
    the moved camera."""
    _set_knobs(monkeypatch, {"WRT_CHUNKS": "4"})
    scene = compile_scene(random_sphere_geometry(1000), device=device)
    r = Renderer(scene, width=256, height=256, device=device)
    r.render_frames(2)
    r.camera.rotation = np.array([0.0, np.sin(0.2), 0.0, np.cos(0.2)])
    r.camera.distance *= 0.9
    r.reset_accumulation()
    r.render_frames(2)
    assert r.stats["captures"] == 1
    acc, paths, occl = _eager_frames(r, 2)
    assert torch.equal(r._accum, acc) and r.ray_counts == (paths, occl)


def test_flag_or_knob_change_recaptures(device, monkeypatch):
    """A change of the static flags or of a transport knob recaptures (one
    graph held at a time), and each block equals its eager frames."""
    _set_knobs(monkeypatch, {"WRT_CHUNKS": "4"})
    scene = compile_scene(random_sphere_geometry(1000), device=device)
    r = Renderer(scene, width=256, height=256, device=device)
    steps = (("max_bounces", 2), ("knob", "1"), ("max_bounces", 4), ("same", None))
    captures = 1
    r.render_frames(1)
    for what, value in steps:
        if what == "max_bounces":
            r.settings.max_bounces = value
            captures += 1
        elif what == "knob":
            monkeypatch.setenv("WRT_CHUNKS", value)
            captures += 1
        r.reset_accumulation()
        r.render_frames(2)
        assert r.stats["captures"] == captures, (what, value)
        acc, paths, occl = _eager_frames(r, 2)
        assert torch.equal(r._accum, acc) and r.ray_counts == (paths, occl), (what, value)


# The volume march (ops/volume.py, csrc/volume_march.cu).

def _volume(device, shape=(7, 11, 13), seed=4, scale=3.0):
    """A random density grid with nz != ny != nx over a box that is not a
    cube."""
    from webgl_raytracer_tpu_torch.models.density import volume_buffers_from_numpy

    rng = np.random.default_rng(seed)
    data = (rng.random(shape) ** 2 * scale).astype(np.float32)
    return volume_buffers_from_numpy(data, np.array([-2.0, -1.5, -1.0], np.float32),
                                     np.array([2.5, 1.0, 2.0], np.float32), data.max(),
                                     device)


def _march_rays(n, device, seed=5):
    """Rays from around the box towards it (1/8 starting inside it, 1/8
    parallel to y), surfaces before, inside and beyond it, 10% inactive."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) - 0.5) * 10.0).astype(np.float32)
    o[: n // 8] = (rng.random((n // 8, 3)) - 0.5).astype(np.float32)
    d = ((rng.random((n, 3)) - 0.5) * np.array([4.0, 2.0, 2.5])).astype(np.float32) - o
    d[n // 8: n // 4, 1] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ts = np.where(rng.random(n) < 0.3, rng.random(n) * 12.0, 1e20).astype(np.float32)
    tp = (0.2 + rng.random((n, 3))).astype(np.float32)

    def tri(a):
        return tuple(torch.tensor(np.ascontiguousarray(a[:, i]), device=device)
                     for i in range(3))

    return (tri(o), tri(d), torch.tensor(ts, device=device), tri(tp),
            torch.tensor(rng.random(n) < 0.9, device=device))


# name: (rays, density scale, step, max steps, how the rays are changed)
MARCH_EDGE_CASES = {
    "lanes die mid-march": (1 << 16, 40.0, 0.25, 256, None),
    "ragged warp": (1013, 2.0, 0.5, 256, None),
    "rays miss the box": (4096, 2.0, 0.5, 256, "miss"),
    "t_surface before entry": (4096, 2.0, 0.5, 256, "surface first"),
    "step 0": (4096, 2.0, 0.0, 256, None),
    "max_steps 0": (4096, 2.0, 0.5, 0, None),
    "max_steps 1": (4096, 2.0, 0.5, 1, None),
    "max_steps 1024": (4096, 0.3, 0.02, 1024, None),
}


@pytest.mark.parametrize("case", list(MARCH_EDGE_CASES))
def test_volume_march_kernel_matches_plain(device, case):
    from webgl_raytracer_tpu_torch.ops import volume as PV

    n, scale, step, steps, change = MARCH_EDGE_CASES[case]
    vol = _volume(device)
    o, d, ts, tp, act = _march_rays(n, device)
    if change == "miss":          # from beyond the box's +x face, heading +x
        o, d = (o[0] + 50.0, o[1], o[2]), (d[0].abs(), d[1], d[2])
    elif change == "surface first":
        ts = torch.full_like(ts, 5e-5)
    args = (vol, o, d, ts, torch.tensor(1e-4, device=device),
            torch.tensor([0.435, 0.643, 1.0], device=device), torch.tensor(scale, device=device),
            torch.tensor(1.0, device=device), torch.tensor(step, device=device),
            torch.tensor(0.0, device=device), tp, act, steps)
    before = T.launches["volume_march"]
    kr, kt = PV.march_volume(*args)
    assert T.launches["volume_march"] == before + 1
    pr, pt = PV.march_volume(*args, impl="plain")
    torch.cuda.synchronize()
    for a, b in zip(kr + kt, pr + pt):
        assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
    ran = torch.stack(kr, 1).gt(0).any(1)
    if change is not None or step == 0.0 or steps == 0:
        assert not bool(ran.any())
        assert all(torch.equal(a, b) for a, b in zip(kt, tp))
    else:
        assert bool(ran.any())
    if case == "lanes die mid-march":
        assert int(torch.stack(kt, 1).eq(0).all(1).sum()) > 100


def test_volume_march_kernel_refuses_what_it_cannot_take(device):
    from webgl_raytracer_tpu_torch.ops import volume as PV

    vol = _volume(device)
    o, d, ts, tp, act = _march_rays(256, device)
    color = torch.tensor([0.4, 0.6, 1.0], device=device)
    with pytest.raises(ValueError, match="max_steps"):
        PV.march_volume(vol, o, d, ts, 1e-4, color, 1.0, 1.0, 0.5, 0.0, tp, act, 1025)
    with pytest.raises(ValueError, match="one value"):
        PV.march_volume(vol, o, d, ts, torch.full((256,), 1e-4, device=device), color,
                        1.0, 1.0, 0.5, 0.0, tp, act, 8)


def _volume_renderer(device, size=128, spacing=0.8):
    from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
    from webgl_raytracer_tpu_torch.models import get_builtin_molecule

    loaded = load_molecule_scene(get_builtin_molecule("caffeine"), display_style="stick",
                                 volume_enabled=True, volume_options=dict(spacing=spacing),
                                 device=device)
    r = Renderer(loaded.scene, volume=loaded.volume.to_device_buffers(device), width=size,
                 height=size, device=device)
    r.settings.volume_enabled = True
    return r, loaded


@pytest.mark.parametrize("transport", ["whole batch", "permuted"])
def test_volume_frame_capture_makes_no_host_sync(device, transport, monkeypatch):
    """A volume frame's warm-up and capture under
    torch.cuda.set_sync_debug_mode("error")."""
    from webgl_raytracer_tpu_torch.ops.kernels import library

    _set_knobs(monkeypatch, {"WRT_CHUNKS": "1" if transport == "whole batch" else "4"})
    r, _ = _volume_renderer(device)
    flags = r._frame_setup()
    assert flags.volume_enabled
    r.scene.trace_operands, library()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r._captured(flags)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert r.stats["captures"] == 1


def test_volume_graph_frames_equal_eager_frames(device, monkeypatch):
    """Volume frames in 4 chunks (the permuted transport): graph replays
    equal eager frames bit for bit, ray counts included, through the
    march kernel; the plain march gives the same frame."""
    _set_knobs(monkeypatch, {"WRT_CHUNKS": "4"})
    r, _ = _volume_renderer(device)
    before = T.launches["volume_march"]
    r.render_frames(1)
    r.render_frames(2)
    assert T.launches["volume_march"] > before
    acc, paths, occl = _eager_frames(r, 3)
    assert torch.equal(r._accum, acc) and r.ray_counts == (paths, occl)
    assert r.stats == {"captures": 1, "overflowed_blocks": 0, "redone_frames": 0}


def test_set_scene_with_a_new_volume_recaptures(device, monkeypatch):
    """set_scene with a new volume (another grid spacing) recaptures, and
    the new block equals eager frames of the new volume."""
    _set_knobs(monkeypatch, {"WRT_CHUNKS": "1"})
    r, loaded = _volume_renderer(device, size=96)
    r.render_frames(2)
    first = r._accum.clone()
    from webgl_raytracer_tpu_torch.models.density import build_nitrogen_density_volume
    from webgl_raytracer_tpu_torch.models import get_builtin_molecule

    vol2 = build_nitrogen_density_volume(get_builtin_molecule("caffeine"), spacing=0.5)
    r.set_scene(loaded.scene, volume=vol2.to_device_buffers(device))
    r.render_frames(2)
    assert r.stats["captures"] == 2
    acc, paths, occl = _eager_frames(r, 2)
    assert torch.equal(r._accum, acc) and r.ray_counts == (paths, occl)
    assert not torch.equal(r._accum, first)


# The cost forms (ops/trace.py, "Counts"): the kernels compiled with their
# counter, held to the plain versions' counts exactly.

COST_SCENES = {12: 1000, 128: 10000, 1976: 150000}    # K -> bench.py's sphere count
_COST_CACHE = {}


def _cost_scene(k, device):
    if k not in _COST_CACHE:
        scene = compile_scene(random_sphere_geometry(COST_SCENES[k]), device=device)
        assert scene.num_clusters == k
        _COST_CACHE[k] = scene
    return _COST_CACHE[k]


def _cost_rays(scene, batch, device):
    """Random rays through the scene's cube: 2^14 of them, or a ragged
    1,013 (31 full warps and one of 21 rays) with 40% inactive."""
    n = (1 << 14) if batch == "random" else 1013
    rng = np.random.default_rng(29)
    extent = float((scene.cluster_bmax.max() - scene.cluster_bmin.min()).cpu())
    o = ((rng.random((3, n)) - 0.5) * extent).astype(np.float32)
    d = rng.normal(size=(3, 3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o3 = tuple(torch.as_tensor(o[i], device=device) for i in range(3))
    d3s = tuple(tuple(torch.as_tensor(d[j, i], device=device) for i in range(3))
                for j in range(3))
    act = None if batch == "random" else torch.as_tensor(rng.random(n) >= 0.4, device=device)
    return o3, d3s, act, torch.full((n,), 1e-3, device=device)


def _any_cost_forced(scene, o3, d3, tmin, t_max, lo, active, ray_major):
    """trace_any's cost form with its schedule forced (uncounted)."""
    from webgl_raytracer_tpu_torch.ops import kernels

    ops = scene.trace_operands
    od = T.any_operand(o3, d3, tmin, t_max, lo, active, ops.mid)
    cp, clip_on = T.clip_operand(None, ops)
    n = od.shape[1]
    found = torch.empty(n, dtype=torch.int32, device=od.device)
    cost = torch.empty(n, dtype=torch.int32, device=od.device)
    err = kernels.library().wrt_trace_any_cost_schedule(
        od.data_ptr(), n, ops.soa.data_ptr(), ops.box.data_ptr(), ops.ctype.data_ptr(),
        ops.soa.shape[0], cp.data_ptr(), int(clip_on), found.data_ptr(), cost.data_ptr(),
        ray_major, kernels.stream_handle(od.device))
    assert err == 0
    return found != 0, cost


@pytest.mark.parametrize("batch", ["random", "ragged"])
@pytest.mark.parametrize("k", list(COST_SCENES))
@pytest.mark.parametrize("kernel", ["trace_closest", "trace_closest_perray", "trace_any",
                                    "trace_any_perray", "trace_any3"])
def test_cost_form_matches_plain_and_default(device, kernel, k, batch):
    """Each cost form against its plain version (counts, t, rows and bits
    equal) and against its default form (t, rows and bits equal); the
    launch goes to the cost form's counter; inactive lanes count 0."""
    scene = _cost_scene(k, device)
    o3, d3s, act, tmin = _cost_rays(scene, batch, device)
    perray = kernel.endswith("_perray")
    lo = torch.full_like(tmin, 0.01)

    def run(with_cost, impl=None):
        if kernel.startswith("trace_closest"):
            return T.trace_closest(scene, o3, d3s[0], tmin, active=act, perray=perray,
                                   impl=impl, with_cost=with_cost)
        if kernel == "trace_any3":
            acts = (act, act, act)
            out = T.trace_any3(scene, o3, d3s, tmin, accept_min=lo, actives=acts, impl=impl,
                               with_cost=with_cost)
            return (*out[0], out[1]) if with_cost else out
        out = T.trace_any(scene, o3, d3s[0], tmin, t_max=20.0, accept_min=lo, active=act,
                          perray=perray, impl=impl, with_cost=with_cost)
        return out if with_cost else (out,)

    before = dict(T.launches)
    got = run(True)
    assert T.launches[kernel + "_cost"] == before[kernel + "_cost"] + 1
    assert T.launches[kernel] == before[kernel]
    want = run(True, impl="plain")
    default = run(False)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
    for a, b in zip(got[:-1], default):
        assert torch.equal(a, b)
    cost = got[-1]
    assert cost.dtype == torch.int32 and bool((cost % 128 == 0).all())
    assert int(cost.max()) <= k * 128 * (3 if kernel == "trace_any3" else 1)
    assert int((cost > 0).sum()) > cost.shape[0] // 20
    if act is not None:
        assert not bool(cost[~act].any())


@pytest.mark.parametrize("batch", ["random", "ragged"])
@pytest.mark.parametrize("k", list(COST_SCENES))
def test_trace_any_cost_schedules_agree(device, k, batch):
    """trace_any's cost form with each schedule forced: the same bits and
    counts as its plain version (both schedules visit in index order)."""
    scene = _cost_scene(k, device)
    o3, d3s, act, tmin = _cost_rays(scene, batch, device)
    lo = torch.full_like(tmin, 0.01)
    fp, cp = T.trace_any(scene, o3, d3s[0], tmin, t_max=20.0, accept_min=lo, active=act,
                         impl="plain", with_cost=True)
    for ray_major in (0, 1):
        f, c = _any_cost_forced(scene, o3, d3s[0], tmin, 20.0, lo, act, ray_major)
        assert torch.equal(f, fp) and torch.equal(c, cp), ray_major


def test_vis_mode2_frame_launches_the_cost_form_once(device):
    """A vis mode 2 frame traces its pixel rays once through
    trace_closest_cost and draws the plain count's heatmap exactly; modes
    1 and 3 take the default form."""
    from webgl_raytracer_tpu_torch.render.integrator import cost_heatmap

    scene = compile_scene(random_sphere_geometry(1000), device=device)
    views = {}
    for impl in (None, "plain"):
        r = Renderer(scene, width=160, height=96, device=device, impl=impl)
        r.settings.vis_mode = 2
        before = dict(T.launches)
        r.render_frame()
        spent = {k: v - before[k] for k, v in T.launches.items() if v != before[k]}
        assert spent == ({"trace_closest_cost": 1} if impl is None else {})
        assert r.frame_index == 1 and r.stats["captures"] == 0
        views[impl] = r._accum.clone()
    assert torch.equal(views[None], views["plain"])
    assert float(views[None].mean()) > 0 and cost_heatmap(
        torch.zeros(1, dtype=torch.int32, device=device)).tolist() == [[0.0, 0.0, 1.0]]
    for mode in (1, 3):
        r = Renderer(scene, width=160, height=96, device=device)
        r.settings.vis_mode = mode
        before = dict(T.launches)
        r.render_frame()
        spent = {k: v - before[k] for k, v in T.launches.items() if v != before[k]}
        assert spent == {"trace_closest": 1}


@pytest.mark.parametrize("name", ["spheres400", "caffeine+tris"])
@pytest.mark.parametrize("clip", [None, ((0.0, 0.0, 1.0), 0.5, 1.0)],
                         ids=["no clip", "clip"])
def test_trace_stack_kernels_match_plain(device, name, clip, monkeypatch):
    """trace_stack_closest and trace_stack_any against the plain walk, bit
    for bit, with inactive rays, a capped walk and any-hit windows; on a
    CUDA tensor the wrappers never take the plain walk."""
    from webgl_raytracer_tpu_torch.ops import traversal as PT

    scene = _compile(name, device)
    o3, d3s, acts, tmin = _fan(1013, 3, device, spread=0.4)
    d3, act = d3s[0], acts[0]
    plain = {(steps, any_hit): (PT.trace_any(scene, o3, d3, tmin, t_max=30.0, accept_min=0.5,
                                             clip=clip, max_steps=steps, active=act,
                                             impl="plain", with_cost=True)
                                if any_hit else
                                PT.trace_closest(scene, o3, d3, tmin, clip=clip,
                                                 max_steps=steps, active=act, impl="plain"))
             for steps in (2048, 5) for any_hit in (False, True)}
    monkeypatch.setattr(PT, "walk_plain", None)
    for (steps, any_hit), want in plain.items():
        before = dict(T.launches)
        if any_hit:
            got = PT.trace_any(scene, o3, d3, tmin, t_max=30.0, accept_min=0.5, clip=clip,
                               max_steps=steps, active=act, with_cost=True)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        else:
            got = PT.trace_closest(scene, o3, d3, tmin, clip=clip, max_steps=steps,
                                   active=act)
            for field in ("t", "prim_slot", "prim_type", "prim_local", "extra", "cost"):
                a, b = getattr(got, field), getattr(want, field)
                assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                   b.view(torch.int32) if b.is_floating_point() else b), field
            assert bool((got.prim_slot[~act] == -1).all())
        kernel = "trace_stack_any" if any_hit else "trace_stack_closest"
        assert T.launches[kernel] == before[kernel] + 1


# The march's and the stack walk's edge batches: empty, one
# ray, a warp less one and a warp plus one, no live lane, and one live
# lane among 3 x 1920 x 1080 (a 1080p [3N] shadow batch).
EDGE_BATCHES = ["0", "1", "31", "33", "no live lane", "one live lane in 6.2M"]
ONE_LIVE_RAYS = 3 * 1920 * 1080


def _edge_active(case, n, device):
    """The activity mask of an edge batch (case of EDGE_BATCHES) of n
    rays: given (None) for the sizes, none live, or one live at n // 2 + 7."""
    if case == "no live lane":
        return torch.zeros(n, dtype=torch.bool, device=device)
    if case.startswith("one live"):
        act = torch.zeros(n, dtype=torch.bool, device=device)
        act[n // 2 + 7] = True
        return act
    return None


@pytest.mark.parametrize("case", EDGE_BATCHES)
def test_volume_march_kernel_edge_batches(device, case):
    """volume_march on the edge batches, bit for bit its plain version; the
    one live lane's batch passes every ray operand as one value (stride-0
    rows) and marches that lane only."""
    from webgl_raytracer_tpu_torch.ops import volume as PV

    vol = _volume(device)
    if case.startswith("one live"):
        n = ONE_LIVE_RAYS

        def one(v):
            return torch.tensor(v, device=device).expand(n)

        o, d, ts = (one(0.0), one(0.0), one(0.5)), (one(1.0), one(0.0), one(0.0)), one(1e20)
        tp = (one(1.0), one(0.8), one(0.6))
        act = _edge_active(case, n, device)
    else:
        n = 4096 if case == "no live lane" else int(case)
        o, d, ts, tp, act = _march_rays(n, device)
        act = act if _edge_active(case, n, device) is None else _edge_active(case, n, device)
    args = (vol, o, d, ts, torch.tensor(1e-4, device=device),
            torch.tensor([0.435, 0.643, 1.0], device=device), torch.tensor(2.0, device=device),
            torch.tensor(1.0, device=device), torch.tensor(0.5, device=device),
            torch.tensor(0.0, device=device), tp, act, 256)
    before = T.launches["volume_march"]
    kr, kt = PV.march_volume(*args)
    assert T.launches["volume_march"] == before + (n > 0)
    pr, pt = PV.march_volume(*args, impl="plain")
    torch.cuda.synchronize()
    for a, b in zip(kr + kt, pr + pt):
        assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
    ran = (torch.stack(kr, 1) > 0).any(1) | (torch.stack(kt, 1) != torch.stack(tp, 1)).any(1)
    if case == "no live lane":
        assert not bool(ran.any())
    elif case.startswith("one live"):
        assert ran.nonzero().squeeze(1).tolist() == [n // 2 + 7]


@pytest.mark.parametrize("case", EDGE_BATCHES)
def test_trace_stack_kernel_edge_batches(device, case):
    """trace_stack_closest and trace_stack_any on the edge batches, bit for
    bit the plain walk (one live lane: a 6.2M-ray batch whose origin is one
    value for every ray)."""
    from webgl_raytracer_tpu_torch.ops import traversal as PT

    scene = _compile("caffeine+tris", device)
    if case.startswith("one live"):
        n = ONE_LIVE_RAYS
        o3, d3s, _, _ = _fan(1, 3, device, spread=0.4)
        o3 = tuple(x.reshape(()).expand(n) for x in o3)
        d3 = tuple(x.expand(n) for x in d3s[0])
        tmin = torch.tensor(1e-3, device=device)
    else:
        n = 1013 if case == "no live lane" else int(case)
        o3, d3s, _, tmin = _fan(n, 3, device, spread=0.4)
        d3 = d3s[0]
    act = _edge_active(case, n, device)
    for any_hit in (False, True):
        def run(impl):
            if any_hit:
                return PT.trace_any(scene, o3, d3, tmin, t_max=30.0, accept_min=0.5,
                                    active=act, impl=impl, with_cost=True)
            rec = PT.trace_closest(scene, o3, d3, tmin, active=act, impl=impl)
            return rec.t.view(torch.int32), rec.prim_slot, rec.extra.view(torch.int32), rec.cost

        got, want = run(None), run("plain")
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        cost = got[-1]
        if act is not None:
            assert int((cost > 0).sum()) == int(act.sum())


def test_stack_and_march_kernels_in_one_captured_graph(device):
    """volume_march and both stack entry points, each launched twice inside
    one captured CUDA graph (each masked walk allocates and zeroes its own
    live list's count on the capture's stream), replayed twice: every
    output equal to the eager calls' bit for bit."""
    from webgl_raytracer_tpu_torch.ops import traversal as PT
    from webgl_raytracer_tpu_torch.ops import volume as PV

    scene = _compile("caffeine+tris", device)
    o3, d3s, acts, tmin = _fan(1013, 3, device, spread=0.4)
    vol = _volume(device)
    mo, md, mts, mtp, mact = _march_rays(4096, device)
    scalars = [torch.tensor(v, device=device) for v in (1e-4, 2.0, 1.0, 0.5, 0.0)]
    color = torch.tensor([0.435, 0.643, 1.0], device=device)

    def calls():
        outs = []
        for k in range(2):
            kr, kt = PV.march_volume(vol, mo, md, mts, scalars[0], color, *scalars[1:], mtp,
                                     mact, 256)
            rec = PT.trace_closest(scene, o3, d3s[k], tmin, active=acts[k])
            found, cost = PT.trace_any(scene, o3, d3s[k], tmin, t_max=30.0, accept_min=0.5,
                                       active=acts[k], with_cost=True)
            outs += [*kr, *kt, rec.t, rec.prim_slot, rec.extra, rec.cost, found, cost]
        return outs

    eager = [x.clone() for x in calls()]
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        calls()                              # warm-up on the side stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            captured = calls()
    for _ in range(2):
        for x in captured:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            a, b = (x.view(torch.int32) if x.is_floating_point() else x for x in (a, b))
            assert torch.equal(a, b)


@pytest.mark.parametrize("settings", [{"tracer": "stack"}, {"use_bvh": False}],
                         ids=["stack", "brute"])
def test_tracer_graph_frames_equal_eager_frames(device, settings):
    """Frames of the stack tracer and of the brute sweep are captured and
    replay to the eager frames bit for bit, ray counts included."""
    from webgl_raytracer_tpu_torch.render.integrator import render_batch_stats

    r = Renderer(_compile("caffeine+tris", device), width=64, height=48, device=device)
    for k, v in settings.items():
        setattr(r.settings, k, v)
    r.render_frames(3)
    assert r.stats["captures"] == 1
    flags, u, px, py = r.frame_inputs()
    acc, rays = None, [0, 0]
    for f in range(3):
        color, (p, o) = render_batch_stats(r.scene, flags, u, px, py, f)
        acc = color if f == 0 else (acc * float(f) + color) / torch.tensor(
            f + 1.0, device=device)
        rays = [rays[0] + int(p), rays[1] + int(o)]
    assert torch.equal(r._accum, acc) and list(r.ray_counts) == rays


# Launches on the tensors' own card (ops/kernels.launch, Renderer._captured).

@pytest.fixture(scope="module")
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the kernels and a captured frame run on "
                    "cuda:1 while cuda:0 is current")
    return torch.device("cuda", 1)


def _card_results(card):
    """trace_closest, trace_any3, volume_march and trace_stack_closest on
    `card`, and two captured frames of a Renderer there, all with cuda:0
    current; returns their outputs on the host and the ray counts, after
    checking that each kernel launched and the frame was captured once."""
    from webgl_raytracer_tpu_torch.ops import traversal as PT
    from webgl_raytracer_tpu_torch.ops import volume as PV

    torch.cuda.set_device(0)
    scene = _compile("caffeine+tris", card)
    o3, d3s, acts, tmin = _fan(1013, 3, card, spread=0.4)
    o, d, ts, tp, act = _march_rays(4096, card)
    scalars = [torch.tensor(v, device=card) for v in (1e-4, 2.0, 1.0, 0.5, 0.0)]
    before = dict(T.launches)
    t, row = T.trace_closest(scene, o3, d3s[0], tmin, active=acts[0])
    occ = T.trace_any3(scene, o3, d3s, tmin, actives=acts)
    kr, kt = PV.march_volume(_volume(card), o, d, ts, scalars[0],
                             torch.tensor([0.435, 0.643, 1.0], device=card), *scalars[1:],
                             tp, act, 256)
    rec = PT.trace_closest(scene, o3, d3s[0], tmin, active=acts[0])
    r = Renderer(scene, width=64, height=64, device=card)
    r.render_frames(2)
    torch.cuda.synchronize(card)
    assert torch.cuda.current_device() == 0
    for name in ("trace_closest", "trace_any3", "volume_march", "trace_stack_closest"):
        assert T.launches[name] > before[name], name
    assert r.stats["captures"] == 1 and r._accum.device == card
    outs = (t, row, *occ, *kr, *kt, rec.t, rec.prim_slot, r._accum)
    return [x.cpu().numpy().tobytes() for x in outs], r.ray_counts


def test_kernels_and_captured_frames_run_on_their_tensors_card(device, second_card):
    """Each kernel launches on its operands' card and a Renderer captures
    and replays on its own card while another card is current: the same
    calls on cuda:1 equal those on cuda:0 bit for bit."""
    on_first, on_second = _card_results(device), _card_results(second_card)
    assert on_first == on_second


# The bounce step's shading kernels (ops/shade.py, csrc/shade.cu) against
# the plain step (impl="plain"): bit for bit on the radiance of every lane
# and on the whole state of each lane live on entry, with the same ray
# counts.

SHADE_MODES = ("metallic", "matte", "surface-glass", "translucent-plastic")
SHADE_SCENES = ("spheres1000", "caffeine+tris")


def _shade_scene(name, device):
    if name == "spheres1000":
        return compile_scene(random_sphere_geometry(1000), device=device)
    # Caffeine's spheres and cylinders and two triangles, the first flagged.
    return compile_scene(molecule_geometry("caffeine"), tri_verts=TRIS,
                         tri_flags=np.array([1.0, 0.0], np.float32), device=device)


def _shade_renderer(scene, device, mode="metallic", sky=None, size=(128, 96)):
    from webgl_raytracer_tpu_torch.render.config import apply_material_preset

    r = Renderer(scene, env=sky, width=size[0], height=size[1], device=device)
    r.settings.env_intensity = 0.4
    r.settings.ambient_intensity = 0.2
    r.settings.material_mode = mode
    if mode == "metallic":
        r.settings.metallic = 0.3
    if mode == "surface-glass":
        r.settings.surface_flag_mode = 1
        r.settings.surface_opacity = 0.3
    if mode == "translucent-plastic":
        apply_material_preset(r.settings, mode)
    return r


@pytest.fixture(scope="module")
def small_sky(device):
    return EnvironmentController(device=device).load_analytic_sky(width=128, height=64)


def _clone_state(st):
    from webgl_raytracer_tpu_torch.render.integrator import PathState

    def c(x):
        return tuple(v.clone() for v in x)

    return PathState(seed=st.seed.clone(), origin=c(st.origin), direction=c(st.direction),
                     throughput=c(st.throughput), radiance=c(st.radiance),
                     last_pdf=st.last_pdf.clone(), alive=st.alive.clone(),
                     nrays=st.nrays.clone(), noccl=st.noccl.clone())


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_step(fused, plain, entry):
    """The fused step's state against the plain step's: radiance on every
    lane, the rest on the lanes live on entry (a lane dead on entry keeps
    no state but alive False), alive and the ray counts everywhere."""
    live = entry.alive
    assert torch.equal(_bits(torch.stack(fused.radiance)), _bits(torch.stack(plain.radiance)))
    for a, b in ((fused.origin, plain.origin), (fused.direction, plain.direction),
                 (fused.throughput, plain.throughput), ((fused.last_pdf,), (plain.last_pdf,))):
        assert torch.equal(_bits(torch.stack(a))[:, live], _bits(torch.stack(b))[:, live])
    assert torch.equal(fused.seed[live], plain.seed[live])
    assert torch.equal(fused.alive, plain.alive)
    assert int(fused.nrays) == int(plain.nrays) and int(fused.noccl) == int(plain.noccl)


def _step_by_step(r, frame=5):
    """Every bounce of r's whole-batch frame through the fused and the
    plain step from the plain step's state; returns the live lanes on
    entry of each bounce after checking each bounce launched the two
    kernels once."""
    from webgl_raytracer_tpu_torch.render import integrator as PI

    flags, u, px, py = r.frame_inputs()
    seed, o3, d3 = generate_camera_rays(u, flags, px, py, frame, 0)
    n = px.shape[0]
    st = PI._initial_state(seed, o3, d3, px.device)
    fused = PI._make_bounce_step(r.scene, r.env, flags, u, n)
    plain = PI._make_bounce_step(r.scene, r.env, flags, u, n, impl="plain")
    assert fused.__name__ == "fused_body" and plain.__name__ == "bounce_body"
    live = []
    for b in range(flags.max_bounces):
        before = dict(T.launches)
        out = fused(b, _clone_state(st))
        assert T.launches["shade_surface"] == before["shade_surface"] + 1
        assert T.launches["shade_scatter"] == before["shade_scatter"] + 1
        want = plain(b, _clone_state(st))
        _same_step(out, want, st)
        live.append(int(st.alive.sum()))
        st = want
    return live


@pytest.mark.parametrize("sky", [False, True], ids=["ambient", "sky"])
@pytest.mark.parametrize("mode", SHADE_MODES)
@pytest.mark.parametrize("name", SHADE_SCENES)
def test_fused_bounce_step_matches_plain(device, small_sky, name, mode, sky):
    """Material modes 0-3, ambient and under the sky, bounces 0-3, on the
    spheres and on spheres, cylinders and (flagged) triangles."""
    r = _shade_renderer(_shade_scene(name, device), device, mode,
                        sky=small_sky if sky else None)
    live = _step_by_step(r)
    assert live[0] == 128 * 96 and live[1] > 0


SHADE_VARIANTS = {
    "rim off": lambda s: setattr(s, "rim_boost", 0.0),
    "light 1 disabled": lambda s: setattr(s.lights[1], "enabled", False),
    "no light": lambda s: [setattr(lt, "enabled", False) for lt in s.lights],
    "no shadows": lambda s: setattr(s, "cast_shadows", False),
    "uniform colour": lambda s: setattr(s, "use_imported_color", False),
    "stack tracer": lambda s: setattr(s, "tracer", "stack"),
    "brute sweep": lambda s: setattr(s, "use_bvh", False),
}


@pytest.mark.parametrize("variant", list(SHADE_VARIANTS))
def test_fused_bounce_step_variants_match_plain(device, small_sky, variant):
    r = _shade_renderer(_shade_scene("caffeine+tris", device), device, sky=small_sky)
    SHADE_VARIANTS[variant](r.settings)
    _step_by_step(r)


@pytest.mark.parametrize("sky", [False, True], ids=["ambient", "sky"])
def test_fused_bounce_step_on_a_dead_batch(device, small_sky, sky):
    """A batch with no live lane: the radiance keeps its bits, no lane
    lives, the counts do not move, and both kernels still launch once."""
    from webgl_raytracer_tpu_torch.render import integrator as PI

    r = _shade_renderer(_shade_scene("spheres1000", device), device,
                        sky=small_sky if sky else None)
    flags, u, px, py = r.frame_inputs()
    seed, o3, d3 = generate_camera_rays(u, flags, px, py, 0, 0)
    n = px.shape[0]
    st = PI._initial_state(seed, o3, d3, device)
    rad = torch.rand((3, n), device=device)
    st.radiance = tuple(x.clone() for x in rad)
    st.alive = torch.zeros(n, dtype=torch.bool, device=device)
    step = PI._make_bounce_step(r.scene, r.env, flags, u, n)
    for b in (0, 2):
        before = dict(T.launches)
        st = step(b, st)
        assert T.launches["shade_surface"] - before["shade_surface"] == 1
        assert T.launches["shade_scatter"] - before["shade_scatter"] == 1
    assert torch.equal(torch.stack(st.radiance), rad)
    assert not bool(st.alive.any()) and int(st.nrays) == 0 and int(st.noccl) == 0


def _tstp_scene(device):
    from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
    from webgl_raytracer_tpu_torch.models import parse_auto_detect

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "proteins", "TSTP.pdb")
    with open(path, encoding="utf-8") as f:
        mol = parse_auto_detect(f.read(), "TSTP.pdb")
    return load_molecule_scene(mol, display_style="cartoon", device=device).scene


# (scene, sky, knobs, frames launched per frame: bounces x chunks).
SHADE_TRANSPORTS = {
    "whole batch": ("spheres1000", True, {"WRT_CHUNKS": "1"}, 4),
    "binned": ("spheres1000", True, {"WRT_CHUNKS": "4"}, 4),
    "binned ambient": ("caffeine+tris", False, {"WRT_CHUNKS": "4", "WRT_BIN_CAP_DIV": "2"},
                       4),
    "permuted": ("caffeine+tris", True, {"WRT_CHUNKS": "4", "WRT_BINNED": "0"}, 16),
    "tstp attrs rows": ("tstp", True, {"WRT_CHUNKS": "4", "WRT_ATTRS": "1"}, 16),
    "stack": ("caffeine+tris", True, {"WRT_CHUNKS": "1"}, 4),
}


@pytest.mark.parametrize("transport", list(SHADE_TRANSPORTS))
def test_fused_frames_match_plain_on_every_transport(device, small_sky, transport,
                                                     monkeypatch):
    """Two captured frames through the kernels equal the plain step's
    frames bit for bit, ray counts included, and each bounce of each
    chunk launches both kernels once."""
    name, sky, knobs, per_frame = SHADE_TRANSPORTS[transport]
    _set_knobs(monkeypatch, knobs)
    scene = _tstp_scene(device) if name == "tstp" else _shade_scene(name, device)
    out = []
    for impl in (None, "plain"):
        r = Renderer(scene, env=small_sky if sky else None, width=256, height=256,
                     device=device, impl=impl)
        r.settings.env_intensity = 0.4
        if transport == "stack":
            r.settings.tracer = "stack"
        before = dict(T.launches)
        r.render_frames(2)
        got = {k: T.launches[k] - before[k] for k in ("shade_surface", "shade_scatter")}
        out.append((r._accum, r.ray_counts, got))
        assert r.stats["redone_frames"] == 0
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    # The capture's warm-up frame and two replays.
    assert out[0][2] == {"shade_surface": 3 * per_frame, "shade_scatter": 3 * per_frame}
    assert out[1][2] == {"shade_surface": 0, "shade_scatter": 0}
    assert float(out[0][0].mean()) > 0.0


def test_fused_volume_frame_matches_plain(device, monkeypatch):
    """A volume frame (permuted, the march before the shading) through the
    kernels equals the plain step's frame."""
    _set_knobs(monkeypatch, {"WRT_CHUNKS": "4"})
    images = []
    for impl in (None, "plain"):
        r, _ = _volume_renderer(device)
        r.impl = impl
        r.render_frames(2)
        images.append((r._accum, r.ray_counts))
    assert torch.equal(images[0][0], images[1][0]) and images[0][1] == images[1][1]


def test_captured_1080p_sky_frame_equals_eager(device, monkeypatch):
    """The benchmark's frame: 1080p, 1000 spheres under the sky, binned at
    n/16 lanes; two replays equal three eager frames bit for bit."""
    _set_knobs(monkeypatch, {"WRT_BIN_CAP_DIV": "16"})
    scene = compile_scene(random_sphere_geometry(1000), device=device)
    sky = EnvironmentController(device=device).load_analytic_sky(width=1024, height=512)
    r = Renderer(scene, env=sky, width=1920, height=1080, device=device)
    r.render_frames(1)
    r.render_frames(2)
    acc, paths, occl = _eager_frames(r, 3)
    assert torch.equal(r._accum, acc) and r.ray_counts == (paths, occl)
    assert r.stats["captures"] == 1


@pytest.mark.parametrize("sky", [False, True], ids=["ambient", "sky"])
def test_fused_recorder_layout(device, small_sky, sky, monkeypatch):
    """With the recorder on, a binned bounce's parts are extend (from
    bounce 1), shade (shade_surface and the fan), env.nee (under the sky),
    sample (shade_scatter) and repack (but the last); each kernel is a
    span of its own."""
    from webgl_raytracer_tpu_torch.utils import telemetry

    _set_knobs(monkeypatch, {"WRT_CHUNKS": "4"})
    r = Renderer(_shade_scene("spheres1000", device), env=small_sky if sky else None,
                 width=256, height=256, device=device)
    telemetry.enable()
    try:
        flags = r._frame_setup()
        plan = r._frame(flags)
        torch.cuda.synchronize()
        layout = plan.layout
    finally:
        telemetry.disable()
    names = [s[0] for s in layout]
    for b in range(4):
        i = names.index(f"bounce[{b}]")
        parts = [s[0] for s in layout if s[1] == i]
        assert parts == (["extend"] if b else []) + ["shade"] + (
            ["env.nee"] if sky else []) + ["sample"] + (["repack"] if b < 3 else [])
        shade = names.index("shade", i)
        sample = names.index("sample", i)
        assert "shade_surface" in [s[0] for s in layout if s[1] == shade]
        assert [s[0] for s in layout if s[1] == sample] == ["shade_scatter"]
