"""The port's reference oracle and parity gate.

* The port's numpy oracle against the JAX package's oracle on its numpy
  path (WRT_ORACLE_NUMPY=1), bit for bit, on the same scene, environment
  buffers, flags, uniforms and pixels.
* The oracle's card trace (torch, one op per numpy op) run on CPU tensors
  against its numpy trace: rows, t and occlusion bits equal. On the card
  the same code runs with the card's IEEE sqrt; here sqrt rounds through
  float64, since torch's CPU f32 sqrt is not correctly rounded on every
  machine (the public entry refuses a CPU trace device for that reason).
* The port's CPU frames against the port's oracle under the parity gate
  (tools/parity_rmse.py), and the gate's arithmetic on made-up images.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.app.pipeline import load_molecule_scene as j_load
from webgl_raytracer_tpu.env import generate_analytic_sky, make_env_buffers
from webgl_raytracer_tpu.models import get_builtin_molecule as j_mol
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import reference_oracle as JO
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
from webgl_raytracer_tpu_torch.env import env_from_numpy
from webgl_raytracer_tpu_torch.models import get_builtin_molecule, parse_auto_detect
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import reference_oracle as PO
from webgl_raytracer_tpu_torch.render.integrator import generate_camera_rays
from webgl_raytracer_tpu_torch.scene import compile_scene, molecule_geometry
from webgl_raytracer_tpu_torch.tools import parity_rmse as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ORACLE_CASES = {
    "metallic": dict(material_mode="metallic", metallic=0.85, roughness=0.35),
    "matte": dict(material_mode="matte"),
    "sky env": dict(material_mode="metallic", env_intensity=0.4),
    "clip": dict(material_mode="metallic", clip_enabled=True),
    "dof": dict(material_mode="metallic", dof_enabled=True, dof_aperture=0.05),
    "translucent": dict(material_mode="translucent-plastic", surface_opacity=0.3),
}


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_numpy_oracle_matches_jax_oracle_bit_for_bit(case, frame, monkeypatch):
    monkeypatch.setenv("WRT_ORACLE_NUMPY", "1")
    size = 16
    jl = j_load(j_mol("caffeine"))
    pl = load_molecule_scene(get_builtin_molecule("caffeine"), device="cpu")
    je = pe = None
    if case == "sky env":
        je = make_env_buffers(generate_analytic_sky(width=64, height=32)["data"])
        pe = env_from_numpy({f.name: np.asarray(getattr(je, f.name))
                             for f in dataclasses.fields(je)}, device="cpu")
    jr = JRenderer(jl.scene, width=size, height=size, env=je)
    pr = Renderer(pl.scene, width=size, height=size, env=pe, device="cpu")
    for r in (jr, pr):
        r.settings.tone_map = "linear"
        for k, v in ORACLE_CASES[case].items():
            setattr(r.settings, k, v)
        if case == "clip":
            r.settings.clip_distance = 0.15 * r.scene_scale
    basis = jr.camera.basis()
    jf, ju = j_split(jr.settings, basis, j_lights(jr.settings.lights, basis),
                     has_env=je is not None, has_volume=False,
                     clip=jr.active_clip_plane(basis))
    jx, jy = jr._pixel_grids()
    pf, pu, px, py = pr.frame_inputs()
    assert pf.clip_enabled == (case == "clip") and pf.use_env == (je is not None)
    ju = jax.tree_util.tree_map(np.asarray, ju)
    want = JO.render_batch_oracle(jl.scene, je, None, jf, ju, np.asarray(jx),
                                  np.asarray(jy), frame)
    got = PO.render_batch_oracle(pl.scene, pe, pf, pu, px, py, frame)
    assert got.dtype == np.float32 and got.shape == (size * size, 3)
    assert got.tobytes() == want.tobytes()
    assert want.max() > 0


def _rays(scene, n, seed):
    """n rays from around the scene, each aimed at a primitive's first
    point (a sphere's or cylinder's centre, a triangle's first vertex)
    jittered by 0.3, 20% masked."""
    prims = scene.cluster_prims.reshape(-1, 12).numpy()
    points = prims[prims[:, 11] >= 0, 0:3]
    lo, hi = points.min(0), points.max(0)
    mid, ext = (lo + hi) / 2, float(np.abs(hi - lo).max())
    rng = np.random.default_rng(seed)
    o = mid + (rng.random((n, 3)) - 0.5) * ext * 1.5
    d = points[rng.integers(0, points.shape[0], n)] + rng.normal(0, 0.3, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    split = lambda a: tuple(a[:, i].astype(np.float32) for i in range(3))  # noqa: E731
    return split(o), split(d), rng.random(n) < 0.8


def _primary_rays(scene, size):
    r = Renderer(scene, width=size, height=size, device="cpu")
    flags, u, px, py = r.frame_inputs()
    _, o3, d3 = generate_camera_rays(u, flags, px, py, 0, 0)
    return (tuple(c.numpy() for c in o3), tuple(c.numpy() for c in d3),
            np.ones(px.shape[0], bool))


def _tstp():
    with open(os.path.join(REPO, "assets", "proteins", "TSTP.pdb"), encoding="utf-8") as f:
        mol = parse_auto_detect(f.read(), "TSTP.pdb")
    return load_molecule_scene(mol, display_style="cartoon", device="cpu").scene


CARD_SCENES = {
    "caffeine": lambda: compile_scene(molecule_geometry("caffeine"), device="cpu"),
    "caffeine+tris": lambda: compile_scene(molecule_geometry("caffeine"), tri_verts=TRIS,
                                           device="cpu"),
    "tstp cartoon": _tstp,
}


@pytest.mark.parametrize("clip_on", [False, True], ids=["no clip", "clip"])
@pytest.mark.parametrize("name", list(CARD_SCENES))
def test_card_trace_code_matches_numpy_trace(name, clip_on):
    """Rays aimed at primitives and 24x24 primary rays; the clip plane z =
    the median z of the primitives' first points, triangles beyond it
    clipped."""
    scene = CARD_SCENES[name]()
    prims = scene.cluster_prims.reshape(-1, 12).numpy()
    mid_z = float(np.median(prims[prims[:, 11] >= 0, 2]))
    clip = (np.array([0.0, 0.0, 1.0], np.float32), mid_z, 1.0) if clip_on else None
    sc = PO._NpScene(scene)
    cs = PO._CardScene(sc, "cpu")
    for rays, floor in ((_rays(scene, 400, 5), 50), (_primary_rays(scene, 24), 0)):
        o, d, mask = rays
        n = o[0].shape[0]
        tmin = np.full(n, np.float32(1e-4))
        lo = np.full(n, 0.01, np.float32)
        hi = np.where(np.arange(n) % 2 == 0, PO.BIG, np.float32(5.0)).astype(np.float32)
        with np.errstate(over="ignore", invalid="ignore"):
            t_np, row_np = PO.trace_closest(sc, o, d, 1e-4, clip, mask)
            any_np = PO.trace_any(sc, o, d, 1e-4, clip, lo, hi, mask)
        t_c, row_c = PO._card_closest(cs, o, d, tmin, clip, mask)
        any_c = PO._card_any(cs, o, d, tmin, clip, lo, hi, mask)
        assert (row_np >= 0).sum() >= floor
        assert np.array_equal(row_c, row_np)
        assert t_c.tobytes() == t_np.tobytes()
        assert np.array_equal(any_c, any_np)


def test_card_trace_needs_a_cuda_device():
    scene = CARD_SCENES["caffeine"]()
    r = Renderer(scene, width=4, height=4, device="cpu")
    flags, u, px, py = r.frame_inputs()
    with pytest.raises(ValueError, match="CUDA device"):
        PO.render_batch_oracle(scene, None, flags, u, px, py, 0, trace_device="cpu")
    # A volume frame needs its volume (tests/test_torch_volume.py renders one).
    with pytest.raises(ValueError, match="no volume"):
        PO.render_batch_oracle(scene, None, dataclasses.replace(flags, volume_enabled=True),
                               u, px, py, 0)


# The port's CPU frames against its oracle: caffeine at 32x32, 4 frames,
# lit by the cone lights, with the clip plane and with the density volume
# (every stream-exact row runs at 64x64 on the card in chip_smoke.py and at
# 128x128 in the tool).
GATE_ROWS = [row for row in P.rows()
             if row.name in ("caffeine-metallic", "caffeine-clip", "caffeine-volume")]


@pytest.mark.parametrize("row", GATE_ROWS, ids=[r.name for r in GATE_ROWS])
def test_port_frames_pass_the_parity_gate_against_the_oracle(row):
    res = P.run_row(row, 32, 4, "cpu")
    assert res["oracle_trace"] == "numpy" and res["frames"] == 4
    assert res["pass"] and res["rmse"] <= P.EXACT_RMSE, res
    assert "device_arithmetic_control" not in res


def test_parity_table_rows():
    names = [r.name for r in P.rows()]
    assert len(names) == 13 and len(set(names)) == 13
    assert [r.name for r in P.rows() if r.volume] == ["caffeine-volume"]
    assert [r.name for r in P.rows() if r.glass] == ["caffeine-ses-surface-glass",
                                                     "glucose-translucent"]


def test_gate_arithmetic():
    rng = np.random.default_rng(0)
    ora = rng.random((1000, 3)).astype(np.float32)
    # Raw pass.
    res = P.judge(ora + 5e-4, ora, glass=False)
    assert res["pass"] and not res["needs_control"] and res["decision_flip_fraction"] == 0
    # 3% of pixels flipped: raw fails, the exclusion passes, the control decides.
    dev = ora.copy()
    dev[:30] += 0.5
    res = P.judge(dev, ora, glass=False)
    assert res["rmse"] > P.EXACT_RMSE and res["needs_control"]
    assert abs(res["decision_flip_fraction"] - 0.03) < 1e-9
    assert res["rmse_excl_decision_flips"] == 0.0
    ctl = P.control(dev, dev, ora)
    assert ctl["pixel_agreement_at_1e-6"] == 1.0 and ctl["max_abs_formulation_diff"] == 0
    ctl = P.control(dev, ora, ora)
    assert ctl["pixel_agreement_at_1e-6"] == pytest.approx(0.97)
    # Glass: no exclusions.
    assert not P.judge(dev, ora, glass=True)["pass"]
    assert P.judge(ora + 2e-3, ora, glass=True)["pass"]


def test_run_row_takes_the_control_where_the_gate_asks(monkeypatch):
    """A row that fails raw but passes on the flip-excluded RMSE is rendered
    again by the plain traversal, and its pass then rests on the control's
    pixel agreement (here, on the CPU, both renders are the plain one)."""
    real = P.judge
    seen = []

    def judge(acc_dev, acc_ora, glass):
        res = real(acc_dev, acc_ora, glass)
        res.update(needs_control=True, rmse=2 * P.EXACT_RMSE, **{"pass": False})
        seen.append(res)
        return res

    monkeypatch.setattr(P, "judge", judge)
    row = next(r for r in P.rows() if r.name == "caffeine-matte")
    res = P.run_row(row, 16, 2, "cpu")
    assert seen and res["pass"]
    ctl = res["device_arithmetic_control"]
    assert ctl["pixel_agreement_at_1e-6"] == 1.0 and ctl["max_abs_formulation_diff"] == 0.0
    assert ctl["alt_rmse_vs_oracle"] <= P.EXACT_RMSE
