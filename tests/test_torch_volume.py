"""The port's density volume and its march against the JAX package.

* build_nitrogen_density_volume bit for bit, and its validation errors.
* intersect_aabb_range and the trilinear lookup bit for bit, and the plain
  march against the JAX march_volume (run eagerly: fused XLA CPU code
  contracts FMAs the port never forms) on random rays through a grid with
  nx != ny != nz, lanes dying mid-march: the same lanes march, radiance
  and throughput within 1e-6 absolute (the two sides' f32 exp differ in
  the last place; the port's CPU exp is float64 rounded once).
* A volume frame (32x32 caffeine stick, the golden volume_march scene)
  against the JAX Renderer's under tests/test_torch_render.py's frame
  tolerances; the port's oracle with a volume against the JAX oracle on
  its numpy path, bit for bit.
* The captured frame of a volume frame reads nothing back to the host,
  its graph-loop block logic equals eager frames, it takes the permuted
  transport (never the binned one) and equals the whole-batch frame.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_frame_loop import NoHostReads
from webgl_raytracer_tpu.app.pipeline import load_molecule_scene as j_load
from webgl_raytracer_tpu.models import get_builtin_molecule as j_mol
from webgl_raytracer_tpu.models import parse_auto_detect as j_parse
from webgl_raytracer_tpu.models import density as JD
from webgl_raytracer_tpu.models.molecular import parse_pdb as j_parse_pdb
from webgl_raytracer_tpu.ops import intersect as JX
from webgl_raytracer_tpu.ops import volume as JV
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import integrator as JI
from webgl_raytracer_tpu.render import reference_oracle as JO
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
from webgl_raytracer_tpu_torch.models import density as PD
from webgl_raytracer_tpu_torch.models import get_builtin_molecule, parse_auto_detect
from webgl_raytracer_tpu_torch.models.molecular import parse_pdb
from webgl_raytracer_tpu_torch.ops import volume as PV
from webgl_raytracer_tpu_torch.ops.intersect import intersect_aabb_range
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.render import reference_oracle as PO
from webgl_raytracer_tpu_torch.render.config import StaticFlags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "assets", "proteins", "TSTP.pdb"), encoding="utf-8") as _f:
    TSTP = _f.read()
SINGLE_N = ("HETATM    1  N   LIG A   1       1.000   2.000   3.000  1.00  0.00"
            "           N")
NO_N = "ATOM      1  CA  ALA A   1       0.000   0.000   0.000  1.00  0.00           C"
MARCH_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def eager_fori(monkeypatch):
    """Under jax.disable_jit, lax.fori_loop hands its body a Python int,
    which the JAX march casts with .astype: loop with int32 scalars
    instead, the loop XLA runs."""
    def fori_loop(lower, upper, body, init):
        carry = init
        for i in range(int(lower), int(upper)):
            carry = body(jnp.int32(i), carry)
        return carry

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)


MOLECULES = {
    "single N": (lambda: parse_pdb(SINGLE_N), lambda: j_parse_pdb(SINGLE_N)),
    "caffeine": (lambda: get_builtin_molecule("caffeine"), lambda: j_mol("caffeine")),
    "TSTP": (lambda: parse_auto_detect(TSTP, "TSTP.pdb"), lambda: j_parse(TSTP, "TSTP.pdb")),
}


@pytest.mark.parametrize("spacing", [0.5, 0.8])
@pytest.mark.parametrize("name", list(MOLECULES))
def test_density_volume_matches_jax(name, spacing):
    p_mol, j_mol_ = MOLECULES[name]
    p = PD.build_nitrogen_density_volume(p_mol(), spacing=spacing)
    j = JD.build_nitrogen_density_volume(j_mol_(), spacing=spacing)
    assert p.data.dtype == np.float32 and p.data.tobytes() == j.data.tobytes()
    assert p.dims == j.dims and p.data.shape == j.data.shape[:3]
    for f in ("origin", "spacing", "bounds_min", "bounds_max"):
        assert getattr(p, f).tobytes() == getattr(j, f).tobytes(), f
    for f in ("max_value", "nitrogen_count", "sigma", "cutoff"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.nitrogen_count == {"single N": 1, "caffeine": 4}.get(name, p.nitrogen_count)


BAD_OPTIONS = {
    "no nitrogen": (NO_N, {}),
    "voxel guard": (SINGLE_N, {"spacing": 0.01}),
    "negative spacing": (SINGLE_N, {"spacing": -1}),
    "zero gaussian scale": (SINGLE_N, {"gaussian_scale": 0}),
    "nan cutoff": (SINGLE_N, {"cutoff_sigma": float("nan")}),
    "zero max voxels": (SINGLE_N, {"max_voxels": 0}),
}


@pytest.mark.parametrize("case", list(BAD_OPTIONS))
def test_density_volume_errors_match_jax(case):
    text, kw = BAD_OPTIONS[case]
    with pytest.raises(ValueError) as jerr:
        JD.build_nitrogen_density_volume(j_parse_pdb(text), **kw)
    with pytest.raises(ValueError) as perr:
        PD.build_nitrogen_density_volume(parse_pdb(text), **kw)
    assert str(perr.value) == str(jerr.value)


def test_volume_buffers_carry_the_jax_grid():
    jvol = JD.build_nitrogen_density_volume(j_mol("caffeine"), spacing=0.8)
    jb = jvol.to_device_buffers()
    pb = PD.volume_buffers_from_numpy(np.asarray(jb.data), np.asarray(jb.vmin),
                                      np.asarray(jb.vmax), np.asarray(jb.max_value), "cpu")
    mine = PD.build_nitrogen_density_volume(get_builtin_molecule("caffeine"),
                                            spacing=0.8).to_device_buffers("cpu")
    for b in (pb, mine):
        assert (b.nx, b.ny, b.nz) == (jb.nx, jb.ny, jb.nz)
        assert b.data.numpy().tobytes() == np.asarray(jb.data).tobytes()
        assert b.vmin.numpy().tobytes() == np.asarray(jb.vmin).tobytes()
        assert b.vmax.numpy().tobytes() == np.asarray(jb.vmax).tobytes()
        assert b.max_value.dtype == torch.float32 and b.max_value.dim() == 0
        assert float(b.max_value) == float(jb.max_value)


# ---------------------------------------------------------------------------
# The march on a random grid with nx != ny != nz.

GRID = (7, 11, 13)          # (nz, ny, nx)


def _grid(seed=4):
    rng = np.random.default_rng(seed)
    data = (rng.random(GRID) ** 2 * 3.0).astype(np.float32)
    vmin = np.array([-2.0, -1.5, -1.0], np.float32)
    vmax = np.array([2.5, 1.0, 2.0], np.float32)
    jb = JV.VolumeBuffers(data=jnp.asarray(data), vmin=jnp.asarray(vmin),
                          vmax=jnp.asarray(vmax),
                          max_value=jnp.asarray(data.max(), jnp.float32),
                          nx=GRID[2], ny=GRID[1], nz=GRID[0])
    pb = PD.volume_buffers_from_numpy(data, vmin, vmax, data.max(), "cpu")
    return jb, pb


def _rays(n, seed=5):
    """Rays from around the box towards points inside it, some parallel to
    an axis, some starting inside, and surfaces before, inside and beyond
    the box; 10% inactive."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) - 0.5) * 10.0).astype(np.float32)
    o[: n // 8] = (rng.random((n // 8, 3)) - 0.5).astype(np.float32)     # inside
    target = ((rng.random((n, 3)) - 0.5) * np.array([4.0, 2.0, 2.5])).astype(np.float32)
    d = target - o
    d[n // 8: n // 4, 1] = 0.0                                            # parallel to y
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    t_surface = np.where(rng.random(n) < 0.3, rng.random(n) * 12.0,
                         np.float32(1e20)).astype(np.float32)
    tp = (0.2 + rng.random((n, 3))).astype(np.float32)
    active = rng.random(n) < 0.9
    return o, d, t_surface, tp, active


def _triple(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3))


def test_box_range_and_trilinear_lookup_match_jax():
    jb, pb = _grid()
    o, d, _, _, _ = _rays(512)
    jh, jn, jf = JX.intersect_aabb_range(jb.vmin, jb.vmax, jnp.asarray(o), jnp.asarray(d))
    ph, pn, pf = intersect_aabb_range(pb.vmin, pb.vmax, _triple(o), _triple(d))
    assert np.array_equal(ph.numpy(), np.asarray(jh)) and ph.any() and not ph.all()
    assert pn.numpy().tobytes() == np.asarray(jn).tobytes()
    assert pf.numpy().tobytes() == np.asarray(jf).tobytes()
    rng = np.random.default_rng(6)
    pos = (rng.random((2000, 3)) * 6.0 - 3.0).astype(np.float32)      # inside and out
    with jax.disable_jit():
        want = np.asarray(JV.sample_volume_trilinear(jb, jnp.asarray(pos)))
    got = PV.sample_volume_trilinear(pb, _triple(pos)).numpy()
    assert got.tobytes() == want.tobytes()


MARCH_CASES = {
    # name: (density scale, step, threshold, max steps)
    "lanes die mid-march": (40.0, 0.25, 0.0, 48),
    "thin, threshold": (0.8, 0.3, 0.2, 40),
    "few steps": (2.0, 0.5, 0.0, 3),
}


@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_plain_march_matches_jax(case, eager_fori):
    scale, step, threshold, steps = MARCH_CASES[case]
    jb, pb = _grid()
    o, d, ts, tp, act = _rays(384)
    color = np.array([0.435, 0.643, 1.0], np.float32)
    t_min = np.float32(1e-4)
    with jax.disable_jit():
        jr, jt = JV.march_volume(jb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts),
                                 jnp.float32(t_min), jnp.asarray(color), jnp.float32(scale),
                                 jnp.float32(1.0), jnp.float32(step), jnp.float32(threshold),
                                 jnp.asarray(tp), jnp.asarray(act), steps)
    jr, jt = np.asarray(jr), np.asarray(jt)
    pr, pt, lane_steps = PV.march_plain(
        pb, _triple(o), _triple(d), torch.from_numpy(ts), torch.tensor(t_min),
        torch.from_numpy(color), torch.tensor(scale), torch.tensor(1.0), torch.tensor(step),
        torch.tensor(threshold), _triple(tp), torch.from_numpy(act), steps,
        count_steps=True)
    pr, pt = torch.stack(pr, 1).numpy(), torch.stack(pt, 1).numpy()
    # The same lanes march: exactly those add radiance or change throughput.
    j_ran = (jr > 0).any(1) | (jt != tp).any(1)
    p_ran = (pr > 0).any(1) | (pt != tp).any(1)
    assert np.array_equal(p_ran, j_ran) and p_ran.sum() > 50
    assert np.abs(pr - jr).max() <= MARCH_TOL and np.abs(pt - jt).max() <= MARCH_TOL
    assert (pr[~p_ran] == 0).all() and np.array_equal(pt[~p_ran], tp[~p_ran])
    assert 0 < int(lane_steps) <= steps * int(act.sum())
    if case == "lanes die mid-march":
        died = (pt == 0).all(1)
        assert died.sum() > 20 and np.array_equal(died, (jt == 0).all(1))
    # march_volume on CPU tensors is the plain version.
    qr, qt = PV.march_volume(pb, _triple(o), _triple(d), torch.from_numpy(ts), float(t_min),
                             torch.from_numpy(color), scale, 1.0, step, threshold,
                             _triple(tp), torch.from_numpy(act), steps)
    assert torch.stack(qr, 1).numpy().tobytes() == pr.tobytes()
    assert torch.stack(qt, 1).numpy().tobytes() == pt.tobytes()


def test_march_edge_settings():
    """No step, no steps, and t_surface before each ray's entry (below
    t_min, for the rays that start inside the box): nothing marches."""
    _, pb = _grid()
    o, d, ts, tp, act = _rays(256)
    color = torch.tensor([0.4, 0.6, 1.0])
    args = (pb, _triple(o), _triple(d))
    for t_surface, step, steps in ((torch.from_numpy(ts), 0.0, 64),
                                   (torch.from_numpy(ts), 0.5, 0),
                                   (torch.full((256,), 5e-5), 0.5, 64)):
        rad, out = PV.march_volume(*args, t_surface, 1e-4, color, 5.0, 1.0, step, 0.0,
                                   _triple(tp), torch.from_numpy(act), steps)
        assert all((r == 0).all() for r in rad)
        assert all(torch.equal(a, b) for a, b in zip(out, _triple(tp)))
    with pytest.raises(ValueError, match="impl"):
        PV.march_volume(*args, torch.from_numpy(ts), 1e-4, color, 5.0, 1.0, 0.5, 0.0,
                        _triple(tp), None, 8, impl="kernel")


# ---------------------------------------------------------------------------
# Volume frames.

def _volume_pair(size, frames_settings=None):
    """(JAX renderer, flags, uniforms, px, py, volume) and the port's
    renderer on the golden volume scene: caffeine stick, nitrogen density
    at 0.8 A, volume on."""
    jl = j_load(j_mol("caffeine"), display_style="stick", volume_enabled=True,
                volume_options=dict(spacing=0.8))
    pl = load_molecule_scene(get_builtin_molecule("caffeine"), display_style="stick",
                             volume_enabled=True, volume_options=dict(spacing=0.8),
                             device="cpu")
    jv = jl.volume.to_device_buffers()
    jr = JRenderer(jl.scene, volume=jv, width=size, height=size)
    pr = Renderer(pl.scene, volume=pl.volume.to_device_buffers("cpu"), width=size,
                  height=size, device="cpu")
    for r in (jr, pr):
        r.settings.volume_enabled = True
        r.settings.tone_map = "linear"
        for k, v in (frames_settings or {}).items():
            setattr(r.settings, k, v)
    basis = jr.camera.basis()
    jf, ju = j_split(jr.settings, basis, j_lights(jr.settings.lights, basis),
                     has_env=False, has_volume=True, clip=None)
    jx, jy = jr._pixel_grids()
    return (jr, jf, ju, jx, jy, jv), pr


def test_volume_frame_matches_jax(eager_fori):
    """test_frame_matches_jax's tolerances: >= 99% of pixels within 1e-4,
    the mean of the rest within 1e-3 relative, ray counts within what the
    flipped pixels account for. 96 steps of 0.5 A march 48 A of a ray's
    segment (the 0.8 A grid spans 31 x 31 x 28 A); the eager JAX loop runs
    every step on every lane."""
    (jr, jf, ju, jx, jy, jv), pr = _volume_pair(32, dict(volume_max_steps=96))
    pf, pu, px, py = pr.frame_inputs()
    assert pf.volume_enabled and jf.volume_enabled
    assert pf.volume_max_steps == jf.volume_max_steps == 96
    with jax.disable_jit():
        jc, (jn, jo) = JI.render_batch_stats(jr.scene, None, jv, jf, ju, jx, jy,
                                             jnp.uint32(0))
    pc, (pn, po) = PI.render_batch_stats(pr.scene, pf, pu, px, py, 0, vol=pr.volume)
    jc, pc = np.asarray(jc), pc.numpy()
    assert np.isfinite(pc).all() and pc.mean() > 0
    # The volume adds emission: the frame without it is darker.
    off = dataclasses.replace(pf, volume_enabled=False, volume_max_steps=0)
    assert PI.render_batch(pr.scene, off, pu, px, py, 0).numpy().mean() < pc.mean()
    diff = np.abs(pc - jc).max(axis=1)
    flipped = np.nonzero(diff > 1e-4)[0]
    assert len(flipped) <= 0.01 * diff.size, f"flipped rays: {flipped.tolist()}"
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * jc[keep].mean()
    bounces = pf.max_bounces
    assert abs(int(pn) - int(jn)) <= bounces * len(flipped)
    assert abs(int(po) - int(jo)) <= 3 * bounces * len(flipped)


@pytest.mark.parametrize("frame", [0, 1])
def test_volume_oracle_matches_jax_oracle_bit_for_bit(frame, monkeypatch):
    monkeypatch.setenv("WRT_ORACLE_NUMPY", "1")
    (jr, jf, ju, jx, jy, jv), pr = _volume_pair(16, dict(material_mode="metallic",
                                                         volume_density=1.5))
    pf, pu, px, py = pr.frame_inputs()
    ju = jax.tree_util.tree_map(np.asarray, ju)
    jvol = jax.tree_util.tree_map(np.asarray, jv)
    want = JO.render_batch_oracle(jr.scene, None, jvol, jf, ju, np.asarray(jx),
                                  np.asarray(jy), frame)
    got = PO.render_batch_oracle(pr.scene, None, pf, pu, px, py, frame, vol=pr.volume)
    assert got.tobytes() == want.tobytes() and want.max() > 0
    plain = PO.render_batch_oracle(pr.scene, None,
                                   dataclasses.replace(pf, volume_enabled=False), pu, px,
                                   py, frame)
    assert not np.array_equal(plain, got)
    with pytest.raises(ValueError, match="no volume"):
        PO.render_batch_oracle(pr.scene, None, pf, pu, px, py, frame)


def test_volume_frame_reads_nothing_back(monkeypatch):
    """The captured frame of a volume frame (tests/test_torch_frame_loop.py
    (a)): after one warm frame, _frame runs with every host read raising."""
    _, pr = _volume_pair(24, dict(volume_max_steps=32))
    flags = pr._frame_setup()
    assert flags.volume_enabled
    pr._frame(flags)
    guard = NoHostReads(monkeypatch)
    guard.active = True
    pr._frame(flags)
    guard.active = False
    assert int(pr._fi) == 2


def test_volume_frames_take_the_permuted_transport(monkeypatch):
    """In 4 chunks a volume frame takes the permuted transport (the binned
    one is excluded), equals the whole-batch frame bit for bit with equal
    ray counts, and Renderer.render_frames equals eager frames."""
    _, pr = _volume_pair(32, dict(volume_max_steps=48, max_bounces=2))
    flags, u, px, py = pr.frame_inputs()
    assert not PI._use_binned(pr.scene, flags, 1024)
    assert PI._use_binned(pr.scene, dataclasses.replace(flags, volume_enabled=False), 1024)
    taken = []
    real_binned, real_perm = PI._binned_transport, PI._run_permuted
    monkeypatch.setattr(PI, "_binned_transport",
                        lambda *a, **k: taken.append("binned") or real_binned(*a, **k))
    monkeypatch.setattr(PI, "_run_permuted",
                        lambda *a, **k: taken.append("permuted") or real_perm(*a, **k))
    monkeypatch.setenv("WRT_CHUNKS", "4")
    chunked, rays = PI.render_batch_stats(pr.scene, flags, u, px, py, 0, vol=pr.volume)
    assert taken == ["permuted"]
    monkeypatch.setenv("WRT_CHUNKS", "1")
    whole, whole_rays = PI.render_batch_stats(pr.scene, flags, u, px, py, 0, vol=pr.volume)
    assert torch.equal(chunked, whole)
    assert tuple(map(int, rays)) == tuple(map(int, whole_rays))

    monkeypatch.setenv("WRT_CHUNKS", "4")
    frames = [PI.render_batch(pr.scene, flags, u, px, py, f, vol=pr.volume)
              for f in range(2)]
    pr.render_frames(2)
    assert torch.equal(pr._accum, (frames[0] * 1.0 + frames[1]) / 2.0)
    assert pr.frame_index == 2


def test_volume_needs_its_buffers():
    """volume_enabled without a volume: the flags stay off in the Renderer
    (has_volume), and the integrator refuses a flagged frame without one."""
    pl = load_molecule_scene(get_builtin_molecule("caffeine"), device="cpu")
    r = Renderer(pl.scene, width=8, height=8, device="cpu")
    r.settings.volume_enabled = True
    flags, u, px, py = r.frame_inputs()
    assert not flags.volume_enabled and flags.volume_max_steps == 0
    on = dataclasses.replace(StaticFlags(), volume_enabled=True, volume_max_steps=8)
    with pytest.raises(ValueError, match="no volume"):
        PI.render_batch(pl.scene, on, u, px, py, 0)


# ---------------------------------------------------------------------------
# The march kernel's operands (ops/volume.march_args) and the plain
# version's step counts: what the CPU can check of the CUDA path.

@pytest.mark.parametrize("case", list(MARCH_CASES))
def test_plain_march_counts_steps_per_lane(case):
    """count_steps="lane" gives each lane's steps: 0 where the lane does not
    march, at most max_steps, summing to count_steps=True's total, with
    the same radiance and throughput."""
    scale, step, threshold, steps = MARCH_CASES[case]
    _, pb = _grid()
    o, d, ts, tp, act = _rays(384)
    args = (pb, _triple(o), _triple(d), torch.from_numpy(ts), torch.tensor(1e-4),
            torch.tensor([0.435, 0.643, 1.0]), torch.tensor(scale), torch.tensor(1.0),
            torch.tensor(step), torch.tensor(threshold), _triple(tp), torch.from_numpy(act),
            steps)
    rad, out, total = PV.march_plain(*args, count_steps=True)
    lrad, lout, lanes = PV.march_plain(*args, count_steps="lane")
    assert lanes.dtype == torch.int64 and lanes.shape == (384,)
    assert int(lanes.sum()) == int(total) > 0 and int(lanes.max()) <= steps
    ran = ((torch.stack(rad, 1) > 0).any(1)
           | (torch.stack(out, 1) != torch.stack(_triple(tp), 1)).any(1))
    assert not bool((lanes[~torch.from_numpy(act)] != 0).any())
    assert bool((lanes[ran] > 0).all())
    for a, b in zip(rad + out, lrad + lout):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="count_steps"):
        PV.march_plain(*args, count_steps="rays")


def _march_call(n=256):
    _, pb = _grid()
    o, d, ts, tp, act = _rays(n)
    return dict(vol=pb, origin=_triple(o), direction=_triple(d),
                t_surface=torch.from_numpy(ts), t_min=torch.tensor(1e-4),
                color=torch.tensor([0.4, 0.6, 1.0]), density_scale=torch.tensor(2.0),
                opacity=torch.tensor(1.0), step_size=torch.tensor(0.5),
                threshold=torch.tensor(0.0), throughput=_triple(tp),
                active=torch.from_numpy(act), max_steps=64)


BAD_MARCH_OPERANDS = {
    "f64 origin": lambda k: dict(k, origin=(k["origin"][0].double(), *k["origin"][1:])),
    "short direction row": lambda k: dict(
        k, direction=(k["direction"][0][:-1], *k["direction"][1:])),
    "non-contiguous throughput": lambda k: dict(
        k, throughput=tuple(torch.stack(k["throughput"], 1)[:, i] for i in range(3))),
    "t_surface of two values": lambda k: dict(k, t_surface=torch.ones(2)),
    "int activity mask": lambda k: dict(k, active=k["active"].to(torch.int32)),
    "short activity mask": lambda k: dict(k, active=k["active"][:-1]),
    "f64 grid": lambda k: dict(k, vol=dataclasses.replace(k["vol"],
                                                          data=k["vol"].data.double())),
    "max_steps beyond the cap": lambda k: dict(k, max_steps=PV.MAX_STEPS + 1),
    "a t_min row": lambda k: dict(k, t_min=torch.full((256,), 1e-4)),
}


@pytest.mark.parametrize("case", list(BAD_MARCH_OPERANDS))
def test_march_kernel_refuses_operands_before_any_launch(case, monkeypatch):
    """The CUDA wrapper checks every operand it hands the kernel and raises
    before it allocates its output or launches (here on CPU tensors,
    with ops/kernels.launch replaced by a trap)."""
    from webgl_raytracer_tpu_torch.ops import kernels

    def trap(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(kernels, "launch", trap)
    k = BAD_MARCH_OPERANDS[case](_march_call())
    with pytest.raises(ValueError):
        PV._march_cuda(*k.values(), 256)


def test_march_kernel_takes_the_callers_tensors(monkeypatch):
    """Nothing is staged: the kernel gets the callers' rows and mask
    themselves (step 1), one value as a pointer with step 0 (an expanded
    origin), the params vector, the grid, and its output."""
    from webgl_raytracer_tpu_torch.ops import kernels

    calls = []
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a) or 0)
    k = _march_call()
    k["origin"] = (torch.tensor(0.5).expand(256), *k["origin"][1:])
    PV._march_cuda(*k.values(), 256)
    (entry, device, *args), = calls
    assert entry == "wrt_volume_march" and device == torch.device("cpu")
    rows = (*k["origin"], *k["direction"], k["t_surface"], *k["throughput"])
    assert all(a is b for a, b in zip(args[0:20:2], rows))
    assert args[1:20:2] == [0] + [1] * 9
    assert args[20] is k["active"] and args[21] == 256
    params, grid = args[22], args[23]
    assert params.shape == (16,) and float(params[13]) == 0.5 and grid is k["vol"].data
    assert args[24:28] == [GRID[2], GRID[1], GRID[0], 64]
    assert args[28].shape == (6, 256) and len(args) == 29


def test_march_operands_take_every_batch_a_volume_frame_marches(monkeypatch):
    """Each batch the integrator hands the march (every bounce of every
    chunk, on the cluster and the stack tracers) passes the kernel's
    operand checks as it is."""
    seen = []
    real = PV.march_plain

    def march(*a, **k):
        PV.march_args(*a, **k)
        seen.append(a[1][0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(PV, "march_plain", march)
    monkeypatch.setenv("WRT_CHUNKS", "4")
    _, pr = _volume_pair(32, dict(volume_max_steps=8, max_bounces=2))
    pr.render(1)
    pr.settings.tracer = "stack"
    pr.render(1)
    assert len(seen) >= 8 and sum(seen) > 0, seen
