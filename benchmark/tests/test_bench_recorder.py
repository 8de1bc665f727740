"""The per-layer metrics that read the program's recorder
(harness/recorder.py, webgl_raytracer_tpu_torch/utils/telemetry.py): on a
synthetic summary, and on the summary of a run of each cell on the CPU at
a small size with the recorder on."""

import time

import pytest

from benchmark.harness import cells as CELLS
from benchmark.harness import main as MAIN
from webgl_raytracer_tpu_torch.utils import telemetry

RECORDER_METRICS = ("transport_self_ms", "trace_span_ms", "env_ms", "repack_ms",
                    "lane_use_pct", "graph_idle_pct", "host_dispatch_ms",
                    "scene_compile_s", "graph_capture_s")


def _row(call_ms, profiler, sky=True, frame=10.0, kernel=2.0):
    spans = {"frame": [1, frame, 0.5], "frame.head": [1, 2.0, 1.0], "pack": [1, 0.25, 0.25],
             "repack": [3, 0.75, 0.75], "env.miss": [5, 1.5, 1.5],
             "trace_closest": [4, kernel, kernel]}
    if sky:
        spans["env.nee"] = [4, 2.0, 1.0]
        spans["trace_any"] = [4, 1.0, 1.0]
    return {"call_ns": int(call_ms * 1e6), "return_ns": int((call_ms + 11.0) * 1e6),
            "frames": 1, "profiler": profiler, "captures": 1, "redone": False,
            "host_ms": {"frame.setup": 0.125, "frame.launch": 0.25, "frame.wait": 8.0},
            "timed_frames": 1, "frame_ms": frame, "spans": spans,
            "lanes": [100, 50, 25, 5], "lanes_run": [200, 200, 200, 200]}


def _summary(sky=True):
    rows = [_row(0.0, False, sky), _row(20.0, True, sky, frame=30.0, kernel=9.0),
            _row(60.0, True, sky, frame=30.0, kernel=9.0)]
    rows += [_row(80.0 + 12.5 * i, False, sky) for i in range(3)]
    return {"kernels": ["trace_any", "trace_closest"], "frames": rows,
            "host_spans": [["scene.compile", None, 0, 1_500_000_000],
                           ["frame.capture", None, 2_000_000_000, 2_250_000_000],
                           ["frame.capture", None, 3_000_000_000, 4_000_000_000]]}


def _ctx(telemetry_summary):
    ctx = MAIN.Context(stats={"captures": 0})
    ctx.telemetry = telemetry_summary
    return ctx


def _read(name, ctx):
    return CELLS.load_reader(name)(ctx)


@pytest.mark.parametrize("sky", [True, False], ids=["sky", "ambient"])
def test_readers_on_a_synthetic_summary(sky):
    ctx = _ctx(_summary(sky))
    kernels = 3.0 if sky else 2.0
    # The three rows after the last profiled one, one frame each.
    assert _read("trace_span_ms", ctx) == pytest.approx(kernels)
    assert _read("transport_self_ms", ctx) == pytest.approx(10.0 - kernels)
    assert _read("repack_ms", ctx) == pytest.approx(1.0)
    assert _read("lane_use_pct", ctx) == pytest.approx(100.0 * 180 / 800)
    # Frames 10 ms of device time each, calls 12.5 ms apart.
    assert _read("graph_idle_pct", ctx) == pytest.approx(20.0)
    assert _read("host_dispatch_ms", ctx) == pytest.approx(0.375)
    assert _read("recaptures", ctx) == 0
    assert _read("scene_compile_s", ctx) == pytest.approx(1.5)
    assert _read("graph_capture_s", ctx) == pytest.approx(0.25)
    if sky:
        assert _read("env_ms", ctx) == pytest.approx(2.5)
    else:
        assert _read("env_ms", ctx) is None


def test_readers_find_nothing_without_the_recorder():
    bare = MAIN.Context()
    for name in RECORDER_METRICS:
        assert _read(name, bare) is None, name
    s = _summary()
    for row in s["frames"]:
        row["profiler"] = False              # no profiled frames: no window to read
    for name in RECORDER_METRICS[:7]:
        assert _read(name, _ctx(s)) is None, name
    assert _read("recaptures", bare) is None


@pytest.mark.parametrize("name", ["spheres1000.sky", "spheres1000.ambient"])
def test_readers_on_a_recorded_run(name, monkeypatch):
    """A run on the CPU with the recorder on, its first two window frames
    taken as the profiled ones: every reader finds its number, env_ms only
    under the sky, and the set-up spans are those of the run."""
    spec = CELLS.load_spec()
    cell = CELLS.load_cell(name, spec)
    for key, value in cell.program_env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("WRT_BINNED", "1")   # at 64x64, the binned transport in 4 chunks
    monkeypatch.setenv("WRT_CHUNKS", "4")
    rec = telemetry.enable()
    try:
        MAIN.run_cell(cell, spec, 2**31 + 7, 1e9, False, "cpu", time.perf_counter(),
                      size=(64, 64), max_frames=5)
        summary = rec.summary()
    finally:
        telemetry.disable()
    rows = summary["frames"]
    assert len(rows) >= 7                    # two warm frames, the window, the check's
    for row in rows[:4]:
        row["profiler"] = True
    ctx = _ctx(summary)
    values = {n: _read(n, ctx) for n in RECORDER_METRICS}
    sky = cell.traffic["sky"] is not None
    assert (values["env_ms"] is not None) == sky
    assert values.pop("graph_capture_s") is None      # the CPU runs its frames eagerly
    for n, v in values.items():
        if n != "env_ms" or sky:
            assert v is not None and v >= 0.0, n
    assert 0.0 < values["lane_use_pct"] <= 100.0
    assert values["scene_compile_s"] > 0.0
