"""The port's bench entry (webgl_raytracer_tpu_torch/bench.py) against the
root bench.py, on the CPU at small sizes.

The scenes equal bench.py's bit for bit; the line's functions equal
bench.py's on the same leg dicts, apart from vs_baseline (which the port
leaves out) and detail.device (the card's name and power limit there). The
frame-0 ray counts equal the port's own render_batch_stats and the
Renderer's count exactly, and the JAX package's (run eagerly) within the
bound of tests/test_torch_render.py: one path segment and three shadow
candidates a bounce for each pixel whose colour differs by more than 1e-4.
The module itself runs on the card only: here it exits nonzero, and it
loads no JAX.
"""

import dataclasses
import math
import os
import stat
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as JB
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import integrator as JI
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu_torch import bench as PB
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.scene.compile import COUNT_FIELDS, HOST_FIELDS, TENSOR_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT = 64, 48
DEVICE = "H100, 700.00 W"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("count", [1000, 10000])
def test_random_sphere_geometry_matches_bench(count):
    a, b = JB.random_sphere_geometry(count), PB.random_sphere_geometry(count)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f.name


@pytest.mark.parametrize("spec", ["1000", "tstp"])
def test_make_scene_matches_bench(spec):
    """The compiled scene of a leg, field by field, to
    tests/test_torch_pipeline.py's standard."""
    js, ps = JB._make_scene(spec), PB._make_scene(spec, "cpu")
    assert ps.device.type == "cpu"
    for name in TENSOR_FIELDS:
        a, b = getattr(ps, name).numpy(), np.asarray(getattr(js, name), np.float32)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    for name in COUNT_FIELDS:
        assert getattr(ps, name) == int(getattr(js, name)), name
    for name, dtype in HOST_FIELDS.items():
        a, b = getattr(ps.pick_tables, name), np.asarray(getattr(js, name))
        assert a.dtype == b.dtype == dtype and np.array_equal(a, b), name
    if spec == "tstp":
        assert ps.tri_count > 10000 and ps.sphere_count == 10 and ps.cylinder_count > 0
        assert ps.num_clusters >= 64


def test_unknown_molecule_spec_raises():
    with pytest.raises(ValueError, match="unknown molecule spec"):
        PB.molecule_geometry("1stp", device="cpu")


LEG_1K = {"ms": 20.56, "path": 2204740, "occl": 252299}
LEG_10K = {"ms": 30.47, "path": 2336249, "occl": 712941}
LEG_10K_SLOW = {"ms": 90.0, "path": 2336249, "occl": 712941}
LEG_150K = {"ms": 61.2, "path": 2500000, "occl": 900000, "estimate": True}
LEG_MOL = {"ms": 23.3, "path": 2100000, "occl": 40000}
LEG_FAST = {"ms": 1e-3, "path": 2204740, "occl": 252299}
SKIPPED = {"skipped": "budget"}
ERROR = {"error": "rc=1: Traceback | RuntimeError: boom"}
# (name, headline leg, 10k, 150k, molecule)
LINES = [
    ("headline only", LEG_1K, None, None, None),
    ("10k done", LEG_1K, LEG_10K, None, None),
    ("150k estimate", LEG_1K, LEG_10K, LEG_150K, None),
    ("all legs", LEG_1K, LEG_10K, LEG_150K, LEG_MOL),
    ("10k over the ratio gate, 150k skipped, molecule failed", LEG_1K, LEG_10K_SLOW,
     SKIPPED, ERROR),
    ("10k skipped", LEG_1K, SKIPPED, ERROR, LEG_MOL),
]


@pytest.mark.parametrize("case", LINES, ids=[c[0] for c in LINES])
def test_result_line_matches_bench(case):
    _, leg_1k, leg_10k, leg_150k, leg_mol = case
    want = JB._result_line("TPU v5 lite", leg_1k, leg_10k, leg_150k, leg_mol)
    got = PB._result_line(DEVICE, JB.BUDGET_S, leg_1k, leg_10k, leg_150k, leg_mol)
    assert "vs_baseline" in want and "vs_baseline" not in got
    del want["vs_baseline"]
    assert got["detail"].pop("device") == DEVICE
    del want["detail"]["device"]
    assert got == want
    assert got["detail"]["resolution"] == "1920x1080"


@pytest.mark.parametrize("leg", [LEG_1K, LEG_10K_SLOW, LEG_150K, LEG_FAST, SKIPPED, ERROR,
                                 None, {}],
                         ids=["1k", "10k slow", "estimate", "implausible", "skipped",
                              "error", "none", "empty"])
def test_mray_and_plausible_match_bench(leg):
    assert PB._mray(leg) == JB._mray(leg)
    assert PB._plausible(leg) == JB._plausible(leg)
    assert PB._plausible(leg) == (leg is not LEG_FAST)


def test_result_line_says_when_blocks_were_redone():
    redone = {**LEG_150K, "overflowed_blocks": 3, "redone_frames": 9}
    clean = {**LEG_1K, "overflowed_blocks": 0, "redone_frames": 0}
    line = PB._result_line(DEVICE, 420.0, clean, clean, redone)
    assert "redone" not in line["detail"]
    assert "redone" not in line["detail"]["scaling"]["spheres10000"]
    assert line["detail"]["scaling"]["spheres150000"]["redone"] == {
        "overflowed_blocks": 3, "redone_frames": 9}
    line = PB._result_line(DEVICE, 420.0, redone, None, None)
    assert line["detail"]["redone"]["redone_frames"] == 9


@pytest.fixture(scope="module")
def spheres1000():
    """The port's renderer at 64x48 on the CPU under the 1000 leg's
    WRT_BIN_CAP_DIV, its _ray_counts, and render_batch_stats of its frame
    0 (colour, path rays, occlusion rays)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WRT_BIN_CAP_DIV", PB._LEG_ENV["1000"]["WRT_BIN_CAP_DIV"])
        r = Renderer(PB._make_scene("1000", "cpu"), width=WIDTH, height=HEIGHT, device="cpu")
        r.settings.tone_map = "linear"
        flags, u, px, py = r.frame_inputs()
        assert not flags.use_env and not flags.clip_enabled
        color, (npath, nocc) = PI.render_batch_stats(r.scene, flags, u, px, py, 0)
        yield r, PB._ray_counts(r), (color.numpy(), int(npath), int(nocc))


def test_ray_counts_match_render_batch_stats_and_renderer(spheres1000, monkeypatch):
    r, counts, (_, npath, nocc) = spheres1000
    assert counts == (npath, nocc)
    assert counts[0] >= WIDTH * HEIGHT and counts[1] > 0
    monkeypatch.setenv("WRT_BIN_CAP_DIV", PB._LEG_ENV["1000"]["WRT_BIN_CAP_DIV"])
    r.render_frames(1)
    assert r.ray_counts == counts


def test_ray_counts_match_jax(spheres1000):
    r, (npath, nocc), (pc, _, _) = spheres1000
    jr = JRenderer(JB._make_scene("1000"), width=WIDTH, height=HEIGHT)
    jr.settings.tone_map = "linear"
    basis = jr.camera.basis()
    jflags, ju = j_split(jr.settings, basis, j_lights(jr.settings.lights, basis),
                         has_env=False, has_volume=False, clip=None)
    jx, jy = jr._pixel_grids()
    with jax.disable_jit():
        jc, (jn, jo) = JI.render_batch_stats(jr.scene, None, None, jflags, ju, jx, jy,
                                             jnp.uint32(0))
    diff = np.abs(pc - np.asarray(jc)).max(axis=1)
    flipped = int((diff > 1e-4).sum())
    assert flipped <= 0.01 * diff.size
    bounces = jflags.max_bounces
    assert abs(npath - int(jn)) <= bounces * flipped, (npath, int(jn), flipped)
    assert abs(nocc - int(jo)) <= 3 * bounces * flipped, (nocc, int(jo), flipped)


def test_bench_scene_on_cpu(spheres1000, monkeypatch, capsys):
    _, counts, _ = spheres1000
    monkeypatch.setenv("WRT_BIN_CAP_DIV", PB._LEG_ENV["1000"]["WRT_BIN_CAP_DIV"])
    ms, npath, nocc, stats = PB.bench_scene("1000", 2, 1, width=WIDTH, height=HEIGHT,
                                            device="cpu")
    assert math.isfinite(ms) and ms > 0
    assert (npath, nocc) == counts
    assert stats == {"overflowed_blocks": 0, "redone_frames": 0}
    warm = capsys.readouterr().out.strip().splitlines()
    assert len(warm) == 1 and '"ms_warm_est"' in warm[0]


def test_leg_without_budget_starts_no_process(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a leg without budget started a process")

    monkeypatch.setattr(PB.subprocess, "Popen", refuse)
    assert PB._scene_leg("1000", 4, 2, 29.9) == {"skipped": "budget"}
    assert PB._scene_leg("150000", 3, 2, -5.0) == {"skipped": "budget"}


def _fake_python(tmp_path, monkeypatch, body):
    """Point the leg's interpreter at a shell script: it records its
    arguments and WRT_BIN_CAP_DIV, then runs `body`."""
    script = tmp_path / "python"
    script.write_text('#!/bin/sh\necho "$@" "$WRT_BIN_CAP_DIV" > "$0.args"\n' + body + "\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(PB.sys, "executable", str(script))
    monkeypatch.delenv("WRT_BIN_CAP_DIV", raising=False)
    return tmp_path / "python.args"


def test_leg_result_from_its_process(tmp_path, monkeypatch):
    args = _fake_python(tmp_path, monkeypatch,
                        'echo \'{"ms_warm_est": 30.0, "path": 10, "occl": 2}\'\n'
                        'echo \'{"ms": 25.0, "path": 10, "occl": 2, '
                        '"overflowed_blocks": 0, "redone_frames": 0}\'')
    leg = PB._scene_leg("150000", 3, 2, 60.0)
    assert leg == {"ms": 25.0, "path": 10, "occl": 2, "overflowed_blocks": 0,
                   "redone_frames": 0}
    assert args.read_text().split() == ["-m", "webgl_raytracer_tpu_torch.bench", "--leg",
                                        "150000", "3", "2", "6"]


def test_leg_failure_is_reported(tmp_path, monkeypatch):
    _fake_python(tmp_path, monkeypatch,
                 'echo \'{"ms_warm_est": 30.0, "path": 10, "occl": 2}\'\n'
                 'echo "RuntimeError: out of memory" >&2\nexit 3')
    leg = PB._scene_leg("10000", 4, 2, 60.0)
    assert leg == {"error": "rc=3: RuntimeError: out of memory"}


def test_bench_refuses_the_cpu_and_loads_no_jax():
    """Without a GPU the module exits nonzero with a message, as a leg and
    as the whole bench, and loads no module of JAX or of the JAX package."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    assert PB.main([]) == 1
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "webgl_raytracer_tpu_torch.bench", "--leg",
                          "1000", "2", "1"],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr
    assert out.stdout == ""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['bench']\n"
        "try:\n"
        "    runpy.run_module('webgl_raytracer_tpu_torch.bench', run_name='__main__')\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'webgl_raytracer_tpu'))\n"
        "print(rc, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1 []", out.stdout
    assert "no CUDA device" in out.stderr
