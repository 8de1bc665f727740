"""The traced window's reduction on a synthetic profiler timeline: busy and
idle time, the per-frame kernel sums by group, the breakdown's gaps named
by what the host was doing."""

import pytest

from benchmark.harness import cells as CELLS
from benchmark.harness.main import Context
from benchmark.harness.trace import WINDOW_MARK, parse_chrome_trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.fixture
def profile():
    # A 100 us window of 2 frames. Device: a hand kernel 10-30, a PyTorch
    # kernel 25-45 (overlapping it), a copy 60-70, a kernel 90-120 that
    # runs past the window's end; nothing at 0-10, 45-60, 70-90.
    events = [
        _x(WINDOW_MARK, "user_annotation", 0, 100),
        _x("cudaGraphLaunch", "cuda_runtime", 2, 6),
        _x("aten::item", "cpu_op", 44, 20),
        _x("cudaMemcpyAsync", "cuda_runtime", 46, 10),
        _x("void trace_closest_kernel<true>(float const*)", "kernel", 10, 20),
        _x("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", "kernel", 25, 20),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 60, 10),
        _x("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", "kernel", 90, 30),
        _x("void trace_any3_kernel(float const*)", "kernel", 150, 5),   # outside
        {"ph": "i", "name": "marker", "cat": "cpu_instant_event", "ts": 5},
    ]
    return parse_chrome_trace({"traceEvents": events}, frames=2)


def _ctx(profile):
    return Context(profile=profile, hand_kernels=("trace_closest", "trace_any3"),
                   spans={"scene_build_s": 1.5}, stats={"redone_frames": 0})


def test_busy_and_idle(profile):
    assert profile.window_s == pytest.approx(100e-6)
    # busy: [10, 45] + [60, 70] + [90, 100] = 55 us
    assert profile.busy_s() == pytest.approx(55e-6)
    assert CELLS.load_reader("idle_pct")(_ctx(profile)) == pytest.approx(45.0)


def test_per_frame_sums(profile):
    ctx = _ctx(profile)
    assert CELLS.load_reader("trace_kernel_ms")(ctx) == pytest.approx(20e-3 / 2)
    # PyTorch kernels 20 + 10 (clipped) us, the copy 10 us, over 2 frames
    assert CELLS.load_reader("torch_op_ms")(ctx) == pytest.approx(40e-3 / 2)
    assert CELLS.load_reader("kernels_per_frame")(ctx) == pytest.approx(3 / 2)
    assert CELLS.load_reader("redone_frames")(ctx) == 0
    assert CELLS.load_reader("scene_build_s")(ctx) == 1.5
    assert CELLS.load_reader("capture_s")(ctx) is None


def test_breakdown_names_the_host_in_each_gap(profile):
    b = profile.breakdown()
    names = [n for n, _ in b["device_ops"]]
    assert names[0].startswith("void at::native::vectorized_elementwise_kernel")
    gaps = b["idle_gaps"]
    assert [round(s * 1e6) for _, s in gaps] == [20, 15, 10]
    # 70-90: aten::item (44-64) has ended, nothing else runs; 45-60: the
    # copy call inside aten::item; 0-10: the graph launch.
    assert [n for n, _ in gaps] == ["host idle", "cudaMemcpyAsync", "cudaGraphLaunch"]


def test_readers_find_nothing_without_a_trace():
    ctx = Context()
    for name in ("idle_pct", "trace_kernel_ms", "torch_op_ms", "kernels_per_frame"):
        assert CELLS.load_reader(name)(ctx) is None


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        parse_chrome_trace({"traceEvents": [_x("k", "kernel", 0, 1)]}, frames=1)
