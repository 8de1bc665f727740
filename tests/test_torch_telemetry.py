"""The port's recorder of spans and counters (utils/telemetry.py).

On the CPU (tier-1):
  - with the recorder off, a Renderer's frames never call into the
    module, and the capture key is the one without it;
  - with it on, on CPU tensors (host clock), the device spans of a binned
    frame nest as a tree with every self time >= 0, the binned buffer's
    live lanes add up to the path rays less the primary misses, eager
    frames (vis, the over-cap redo) are rows of their own, the host spans
    nest, carry set-up's spans and, under a profiler, match its
    record_function ranges, and export round-trips;
On the card (marked cuda; the file imports no JAX):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_telemetry.py
  - the recorder's stamps captured in a CUDA graph (and timing events,
    the alternative) time each replay;
  - host stamps match the profiler's Chrome trace on the card;
  - a Renderer's captured frame with the recorder off makes the launches
    it made before, the recorder on gives the same frames bit for bit,
    and its device spans and lanes are read from the replay.
"""

import json
import os

import numpy as np
import pytest
import torch

from webgl_raytracer_tpu_torch.env import EnvironmentController
from webgl_raytracer_tpu_torch.models import Geometry
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.scene import compile_scene, random_sphere_geometry
from webgl_raytracer_tpu_torch.utils import telemetry

BINNED = {"WRT_BINNED": "1", "WRT_CHUNKS": "4"}


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off."""
    telemetry.disable()
    yield
    telemetry.disable()


@pytest.fixture
def knobs(monkeypatch):
    def set_(values):
        for k in PI.TRANSPORT_KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in values.items():
            monkeypatch.setenv(k, v)
    return set_


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        if name == "spheres300":
            _SCENES[name] = compile_scene(random_sphere_geometry(300), device="cpu")
        else:
            # 300 spheres of radius 0.8-1.2 in an 8-unit box: at 0.45 of the
            # fitted distance most of a 64x32 frame's primaries hit, more
            # than a buffer of n/64 lanes holds.
            rng = np.random.default_rng(3)
            z3, z1 = np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
            _SCENES[name] = compile_scene(Geometry(
                ((rng.random((300, 3)) - 0.5) * 8).astype(np.float32),
                (0.8 + rng.random(300) * 0.4).astype(np.float32),
                rng.random((300, 3)).astype(np.float32), z3, z3, z1, z3), device="cpu")
    return _SCENES[name]


def _renderer(sky=True, device="cpu", scene=None, size=(64, 32)):
    env = (EnvironmentController(device=device).load_analytic_sky(width=64, height=32)
           if sky else None)
    r = Renderer(scene or _scene("spheres300"), env=env, width=size[0], height=size[1],
                 device=device)
    r.settings.env_intensity = 0.4
    return r


def _check_tree(layout, times):
    """Each span inside its parent, siblings in order and apart, self >= 0."""
    dur = [times[e] - times[s] for _, _, s, e in layout]
    own = list(dur)
    for i, (name, parent, s, e) in enumerate(layout):
        assert e is not None and e >= s, name
        if parent >= 0:
            _, _, ps, pe = layout[parent]
            assert ps <= s and e <= pe, (name, layout[parent][0])
            own[parent] -= dur[i]
    children = {}
    for name, parent, s, e in layout:
        children.setdefault(parent, []).append((s, e))
    for spans in children.values():
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            assert e0 <= s1
    assert min(own) >= -1e-9
    return own


# -- off -----------------------------------------------------------------


def test_off_renderer_never_calls_the_recorder(monkeypatch, knobs):
    """With the recorder off no function of the module and no method of
    its classes runs while a Renderer renders, eagerly or on the over-cap
    redo, and the capture key is the one without it."""
    knobs({**BINNED, "WRT_BIN_CAP_DIV": "64"})
    r = _renderer()
    dense = _renderer(sky=False, scene=_scene("dense"))
    dense.camera.distance *= 0.45
    dense.settings.max_bounces = 2
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("enable", "disable", "export", "host_span", "profiling"):
        monkeypatch.setattr(telemetry, name, spy(name, getattr(telemetry, name)))
    for cls in (telemetry.Recorder, telemetry._Plan, telemetry._HostSpan,
                telemetry._Call, telemetry._EagerFrame):
        for name, fn in list(vars(cls).items()):
            if callable(fn):
                monkeypatch.setattr(cls, name, spy(f"{cls.__name__}.{name}", fn))
    r.render_frames(2)
    r.settings.vis_mode = 1
    r.render_frame()
    before = dense.stats["redone_frames"]
    dense.render_frame()
    assert dense.stats["redone_frames"] == before + 1
    assert calls == []
    flags = r._frame_setup()
    assert r._capture_key(flags) == (
        flags, r.width, r.height, id(r.scene), id(r.env), id(r.volume), r.impl,
        tuple(os.environ.get(k) for k in PI.TRANSPORT_KNOBS))
    telemetry.enable()
    assert r._capture_key(flags)[-1] == "telemetry"


# -- on, CPU tensors ---------------------------------------------------------


def test_binned_frame_spans_nest(knobs):
    """A binned frame under the sky: the device spans are the transport's
    stages as a tree, with the hand kernels' spans absent on the CPU (the
    plain traces are not launches), and every self time >= 0."""
    knobs(BINNED)
    r = _renderer()
    rec = telemetry.enable()
    flags = r._frame_setup()
    plan = r._frame(flags)
    layout, (marks, lanes) = plan.layout, plan.read()
    times = [(m - marks[0]) * 1e-6 for m in marks]
    own = _check_tree(layout, times)
    names = [s[0] for s in layout]
    assert names[0] == "frame" and layout[0][1] == -1
    top = [s[0] for s in layout if s[1] == 0]
    assert top == ["frame.head"] + [f"bounce[{b}]" for b in range(4)] + ["frame.tail"]
    head = names.index("frame.head")
    assert [s[0] for s in layout if s[1] == head] == ["env.miss", "pack"]
    for b in range(4):
        i = names.index(f"bounce[{b}]")
        parts = [s[0] for s in layout if s[1] == i]
        assert parts == (["extend"] if b else []) + [
            "env.miss", "shade", "env.nee", "sample"] + (["repack"] if b < 3 else [])
        assert layout[i][2] == layout[names.index(parts[0], i)][2]   # one mark opens both
    assert abs(sum(own) - (times[layout[0][3]] - times[layout[0][2]])) < 1e-6
    assert plan.lanes_run == [plan.lanes_run[0]] * 4 and len(lanes) == 4
    assert rec._rows == []          # a frame outside render_frames is no row


def test_live_lanes_are_the_path_rays_less_primary_misses(knobs):
    """Σ live lanes over the bounces of a binned frame = the frame's path
    rays (render_batch_flagged) less its primary misses."""
    knobs(BINNED)
    r = _renderer()
    flags, u, px, py = r.frame_inputs()
    rec = telemetry.enable()
    with rec.call(None, 1):
        with rec.eager_frame("cpu"):
            _, (paths, _), overflow = PI.render_batch_flagged(
                r.scene, flags, u, px, py, 0, env=r.env)
    row = rec.frames()[-1]
    assert int(overflow) == 0
    _, origin, direction = PI.generate_camera_rays(u, flags, px, py, 0, 0)
    rec0 = PI._closest_hit(r.scene, flags, origin, direction, u.t_min, None,
                           full_record=False)
    misses = int((rec0.prim_slot < 0).sum())
    assert 0 < misses < px.shape[0]
    assert sum(row["lanes"]) == int(paths) - misses
    assert row["lanes"][0] == px.shape[0] - misses
    assert len(row["lanes_run"]) == flags.max_bounces


def test_rows_of_render_frames_eager_and_redo(knobs):
    """One row a render_frames call with its host spans; a vis frame and a
    redone over-cap block are rows too."""
    knobs({**BINNED, "WRT_BIN_CAP_DIV": "64"})
    r = _renderer()
    dense = _renderer(sky=False, scene=_scene("dense"))
    dense.camera.distance *= 0.45
    dense.settings.max_bounces = 2
    rec = telemetry.enable()
    r.render_frames(2)
    r.settings.vis_mode = 3
    r.render_frame()
    dense.render_frame()
    rows = rec.frames()
    assert [row["frames"] for row in rows] == [2, 1, 1]
    two, vis, redo = rows
    assert two["timed_frames"] == 2 and not two["redone"] and not two["profiler"]
    assert set(two["host_ms"]) == {"frame.setup", "frame.launch", "frame.wait"}
    assert two["call_ns"] <= two["return_ns"]
    assert two["spans"]["frame"][0] == 2 and two["spans"]["bounce[3]"][0] == 2
    assert sum(ms for ms in two["host_ms"].values()) <= (
        two["return_ns"] - two["call_ns"]) * 1e-6
    assert set(vis["spans"]) == {"frame"} and "lanes" not in vis
    assert redo["redone"] and "frame.redo" in redo["host_ms"]
    assert redo["timed_frames"] == 2        # the binned frame and its redo
    assert rows[0]["frame_ms"] == pytest.approx(rows[0]["spans"]["frame"][1])
    totals = rec.summary()["spans"]
    assert totals["frame"]["count"] == 5 and totals["frame"]["clock"] == "device"
    assert totals["frame.setup"]["clock"] == "host" and totals["frame.setup"]["count"] == 3
    for t in totals.values():
        assert t["min_ms"] <= t["sum_ms"] / t["count"] <= t["max_ms"]


def test_host_spans_nest_and_carry_set_up(knobs):
    """scene.compile holds the host BVH, the clusters and the upload;
    env.sky is its own; frame.capture is absent on the CPU."""
    knobs(BINNED)
    rec = telemetry.enable()
    r = _renderer(scene=compile_scene(random_sphere_geometry(200, seed=4), device="cpu"))
    r.render_frame()
    spans = rec.summary()["host_spans"]
    parents = {name: parent for name, parent, _, _ in spans}
    assert parents["scene.compile"] is None and parents["env.sky"] is None
    assert parents["scene.clusters"] == "scene.compile"
    assert parents["scene.upload"] == "scene.compile"
    assert parents["scene.bvh"] == "scene.clusters"
    assert "frame.capture" not in parents
    by_name = {name: (s, e) for name, _, s, e in spans}
    for name, parent, s, e in spans:
        assert s <= e
        if parent is not None:
            ps, pe = by_name[parent]
            assert ps <= s and e <= pe


def test_host_spans_are_profiler_ranges_on_its_clock(knobs, tmp_path):
    """Under torch.profiler each host span is a record_function range on the
    clock of its Chrome trace: the range holds the stored span (to 50 us of
    clock rounding) and starts and ends within 20 ms of it, since the
    test processes share the cores (the card test below holds them to
    0.1 ms). The row says a profiler was active."""
    from torch.profiler import ProfilerActivity, profile

    knobs(BINNED)
    r = _renderer()
    rec = telemetry.enable()
    for _ in range(2):      # the first range of a process pays the profiler's start-up
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            r.render_frame()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    for start_gap, end_gap in _profiler_gaps(rec, path):
        assert -50e3 < start_gap < 20e6 and -50e3 < end_gap < 20e6


def _profiler_gaps(rec, path):
    """(stored start - range start, range end - stored end) in ns of the
    three frame-loop host spans of the last frame."""
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    assert rec.frames()[-1]["profiler"]
    gaps = []
    for name, _, start, end in rec.summary()["host_spans"][-3:]:
        assert name in ("frame.setup", "frame.launch", "frame.wait")
        e = ranges[name]
        gaps.append((start - (e["ts"] * 1e3 + base), (e["ts"] + e["dur"]) * 1e3 + base - end))
    return gaps


def test_export_round_trips(knobs, tmp_path):
    knobs(BINNED)
    r = _renderer()
    rec = telemetry.enable()
    r.render_frames(1)
    r.render_frame()
    data = telemetry.export(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == data
    assert data == rec.summary()
    assert len(data["frames"]) == 2 and data["frames"][1]["captures"] == r.stats["captures"]
    assert "trace_closest" in data["kernels"]
    telemetry.disable()
    with pytest.raises(RuntimeError):
        telemetry.export(tmp_path / "off.json")


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_marks_time_each_replay(device):
    """Two torch.cuda._sleep spans of 2 and 5 ms in one captured graph,
    between the recorder's stamps and, as the alternative measured against
    them, between external timing events: every replay reads both spans
    within 10% either way. The recorder stamps: an event's record node and
    its elapsed_time read cost several times more (utils/telemetry.py)."""
    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    per_ms = 20_000_000 / a.elapsed_time(b)
    rec = telemetry.enable()
    stream = torch.cuda.Stream(device)
    events = [torch.cuda.Event(enable_timing=True, external=True) for _ in range(3)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        rec.begin_frame(device)
        rec.stage("two", 1)
        events[0].record()
        torch.cuda._sleep(int(2.0 * per_ms))
        events[1].record()
        rec.stage("five", 1)
        torch.cuda._sleep(int(5.0 * per_ms))
        events[2].record()
        plan = rec.end_frame()
    assert [s[0] for s in plan.layout] == ["frame", "two", "five"]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        t, _ = plan.read()
        spans = {name: (t[e] - t[s]) * 1e-6 for name, _, s, e in plan.layout}
        assert spans["two"] == pytest.approx(2.0, rel=0.1)
        assert spans["five"] == pytest.approx(5.0, rel=0.1)
        assert events[0].elapsed_time(events[1]) == pytest.approx(2.0, rel=0.1)
        assert events[1].elapsed_time(events[2]) == pytest.approx(5.0, rel=0.1)


@pytest.mark.cuda
def test_host_stamps_match_the_profiler_on_the_card(device, monkeypatch, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    for k in PI.TRANSPORT_KNOBS:
        monkeypatch.delenv(k, raising=False)
    scene = compile_scene(random_sphere_geometry(1000), device=device)
    r = Renderer(scene, width=256, height=256, device=device)
    rec = telemetry.enable()
    r.render_frame()
    for _ in range(2):      # the first range of a process pays the profiler's start-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r.render_frame()
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    for start_gap, end_gap in _profiler_gaps(rec, path):
        assert abs(start_gap) < 1e5 and abs(end_gap) < 1e5


@pytest.mark.cuda
@pytest.mark.parametrize("sky", [False, True], ids=["ambient", "sky"])
def test_recorded_capture_is_the_frame_without_it(device, monkeypatch, sky):
    """Off, the capture's launches a replay and key are those without the
    recorder; on, the frames are the same bit for bit, the replay's device
    spans are read with a kernel span for every launch of the replay, and
    its lanes add up to the path rays less the primary misses."""
    for k in PI.TRANSPORT_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WRT_BIN_CAP_DIV", "4")     # no block overflows: no redo
    scene = compile_scene(random_sphere_geometry(1000), device=device)
    env = (EnvironmentController(device=device).load_analytic_sky(width=256, height=128)
           if sky else None)
    images, graphs = [], []
    for on in (False, True):
        rec = telemetry.enable() if on else None
        if not on:
            telemetry.disable()
        r = Renderer(scene, env=env, width=512, height=512, device=device)
        r.settings.env_intensity = 0.4
        r.render_frames(3)
        paths = r.ray_counts[0]
        r.render_frame()
        paths = r.ray_counts[0] - paths
        images.append(r.accumulated())
        graphs.append(r._graph)
        assert r.stats["redone_frames"] == 0
    off, on = graphs
    assert off.launches == on.launches and off.plan is None and on.plan is not None
    assert on.key == off.key + ("telemetry",)
    np.testing.assert_array_equal(images[0], images[1])
    row = rec.frames()[-1]
    kernels = {k: v for k, v in row["spans"].items() if k in off.launches}
    assert {k: v[0] for k, v in kernels.items()} == {
        k: n for k, n in off.launches.items() if n}
    assert 0.0 < sum(v[1] for v in kernels.values()) < row["frame_ms"]
    assert row["timed_frames"] == 1 and row["frames"] == 1
    assert ("env.nee" in row["spans"]) == sky
    assert row["lanes_run"] == [row["lanes_run"][0]] * 4
    misses = 512 * 512 - row["lanes"][0]
    assert 0 < misses < 512 * 512
    assert sum(row["lanes"]) == paths - misses
    assert row["host_ms"].keys() == {"frame.setup", "frame.launch", "frame.wait"}
    assert rec.summary()["spans"]["frame.capture"]["count"] == 1
