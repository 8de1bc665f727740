"""Where the time of a 1080p frame goes, on a GPU, eager and captured.

    python -m webgl_raytracer_tpu_torch.profile_frame

For each of five frames — the 1000-sphere main path (default settings,
ambient light), the same scene under the default analytic sky (1024x512,
env_intensity 0.4; the frame whose env NEE takes trace_any), the
10k-sphere scene under that sky (the per-ray kernels), the TSTP protein
cartoon (assets/proteins/TSTP.pdb through app/pipeline, ambient light;
triangles, spheres and cylinders, so the block kernels) and the bench's
150k-sphere scene (ambient light, K = 1976, under the bench's
WRT_BIN_CAP_DIV for it: its primary hits overflow the default buffer) —
each of two transports — the binned one that 1080p frames take by
default, and the whole batch (WRT_CHUNKS=1) — and each of two modes —
eager (the frame function run op by op: integrator.render_batch_stats
and the running mean) and graph (Renderer.render_frame: one replay of
the captured frame and the block's host read) — it renders at 1920x1080
one warm frame (for
the graph, the capture), TIMED_FRAMES frames timed one by one, then one
frame under torch.profiler, and prints one JSON line: the timed frames'
wall milliseconds (mean and each), the profiled frame's, its device busy
time (sum of kernel times), the idle share against the profiled wall and
against the timed frames' mean (an estimate: busy and wall time come from
different frames of one run), the kernels executed in the frame, the
trace kernels' time and launches (the recorder's kernel spans,
utils/telemetry.py: one a launch through ops/kernels.launch), the
recorder's device ms by stage, the top kernels by device time, and the
peak device memory of the mode's frames (max_memory_allocated; for the
graph also what its private pool keeps reserved after the capture). The
recorder is on in every frame of the tool.
For the graph it also times TIMED_FRAMES frames in one render_frames
call.

Then the CHUNK_TARGET race: graph frames of the 1000-sphere scene at
256x256 and 512x512, whole batch against binned (256x256 in 4 chunks;
512x512 is 2 x CHUNK_TARGET rays, so 2 chunks by default), each timed as
RACE_FRAMES frames in one render_frames call, in the order whole,
binned, binned, whole.

The first line is the card's name and power limit as nvidia-smi gives
them.
"""

from __future__ import annotations

import json
import os
import time

from .utils import telemetry

WIDTH, HEIGHT = 1920, 1080
PROTEIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "proteins", "TSTP.pdb")
TOP_KERNELS = 12
TIMED_FRAMES = 5
RACE_FRAMES = 20
TRANSPORTS = (("binned", {}), ("whole batch", {"WRT_CHUNKS": "1"}))
MODES = ("eager", "graph")


class knobs_set:
    """Set environment knobs inside the block and restore them after."""

    def __init__(self, knobs):
        self.knobs = knobs

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.knobs}
        os.environ.update(self.knobs)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def eager_frame(r, state):
    """One frame of `r` run op by op: render_batch_stats (one host read
    of the overflow flag), then the running mean into state["accum"]; a
    row of the recorder."""
    import torch

    from .render.frame import running_mean
    from .render.integrator import render_batch_stats

    flags, u, px, py = state["inputs"]
    f = state["frame"]
    rec = telemetry.recorder
    with rec.call(None, 1), rec.eager_frame(r.device):
        color, _ = render_batch_stats(r.scene, flags, u, px, py, f, env=r.env)
        if state.get("accum") is None:
            state["accum"] = torch.empty_like(color)
        running_mean(state["accum"], color, torch.full((), f, dtype=torch.int64,
                                                       device=color.device))
    state["frame"] = f + 1


def _profile(name, r, transport, mode) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .ops.kernels import launches

    rec = telemetry.enable()
    r.settings.tone_map = "linear"
    r.reset_accumulation()
    state = {"inputs": r.frame_inputs(), "frame": 0}
    frame = r.render_frame if mode == "graph" else (lambda: eager_frame(r, state))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    frame()                                   # the warm frame; the graph's capture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()                  # what stays reserved is the graph's pool
    pool_bytes = torch.cuda.memory_reserved() - reserved
    walls = []
    for _ in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000.0)
    plain_wall_ms = sum(walls) / len(walls)
    block_ms = None
    if mode == "graph":
        t0 = time.perf_counter()
        r.render_frames(TIMED_FRAMES)
        torch.cuda.synchronize()
        block_ms = (time.perf_counter() - t0) * 1000.0 / TIMED_FRAMES
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0

    rows = []
    for e in prof.key_averages():
        # Kernel rows only: operator rows repeat their kernels' time.
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.key, e.self_device_time_total / 1000.0, e.count))
    rows.sort(key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in rows)
    spans = rec.frames()[-1]["spans"]
    telemetry.disable()
    traces = {k: [ms, n] for k, (n, ms, _) in spans.items() if k in launches}
    out = {
        "scene": name, "transport": transport, "mode": mode,
        "device": torch.cuda.get_device_name(0),
        "size": f"{r.width}x{r.height}",
        "wall_ms": wall_ms, "unprofiled_wall_ms": plain_wall_ms,
        "unprofiled_wall_ms_each": walls,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_idle_share_unprofiled_est": max(0.0, 1.0 - busy_ms / plain_wall_ms),
        "trace_kernels_ms": sum(v[0] for v in traces.values()),
        "trace_kernels_ms_calls": traces,
        "stage_ms": {k: ms for k, (_, ms, _) in spans.items() if k not in launches},
        "kernel_launches": sum(c for _, _, c in rows),
        "peak_memory_bytes": peak,
        "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                for k, ms, c in rows[:TOP_KERNELS]]}
    if mode == "graph":
        out["block_wall_ms_per_frame"] = block_ms
        out["graph_pool_reserved_bytes"] = pool_bytes
        out["renderer_stats"] = dict(r.stats)
    return out


def chunk_race(scene, device) -> list:
    """Graph frames at 256x256 and 512x512, whole batch against binned:
    ms a frame over RACE_FRAMES frames in one render_frames call."""
    import torch

    from .render import Renderer

    lines = []
    for size, binned in ((256, {"WRT_CHUNKS": "4"}), (512, {})):
        legs = (("whole batch", {"WRT_CHUNKS": "1"}), ("binned", binned))
        for transport, knobs in (legs[0], legs[1], legs[1], legs[0]):
            with knobs_set(knobs):
                r = Renderer(scene, width=size, height=size, device=device)
                r.settings.max_frames = 0
                r.render_frames(2)                # capture, and one warm replay
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.render_frames(RACE_FRAMES)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1000.0 / RACE_FRAMES
            lines.append({"race": "CHUNK_TARGET", "size": f"{size}x{size}",
                          "transport": transport, "knobs": knobs, "frames": RACE_FRAMES,
                          "graph_ms_per_frame": ms, "stats": dict(r.stats),
                          "device": torch.cuda.get_device_name(0)})
    return lines


def main() -> int:
    import torch

    from .app.pipeline import load_molecule_scene
    from .bench import _LEG_ENV
    from .device import card_line
    from .env import EnvironmentController
    from .models import parse_auto_detect
    from .render import Renderer
    from .scene import compile_scene, random_sphere_geometry

    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    device = torch.device("cuda", 0)
    print(card_line(device), flush=True)
    sky = EnvironmentController(device=device).load_analytic_sky()
    spheres1000 = compile_scene(random_sphere_geometry(1000), device=device)
    with open(PROTEIN, encoding="utf-8") as f:
        tstp = load_molecule_scene(parse_auto_detect(f.read(), "TSTP.pdb"),
                                   display_style="cartoon", device=device).scene

    def lit(scene):
        r = Renderer(scene, env=sky, width=WIDTH, height=HEIGHT, device=device)
        r.settings.env_intensity = 0.4
        return r

    # (name, renderer, the frame's own knobs)
    frames = (("spheres1000", Renderer(spheres1000, width=WIDTH, height=HEIGHT, device=device),
               {}),
              ("spheres1000 analytic sky", lit(spheres1000), {}),
              ("spheres10k analytic sky",
               lit(compile_scene(random_sphere_geometry(10000), device=device)), {}),
              ("tstp cartoon", Renderer(tstp, width=WIDTH, height=HEIGHT, device=device), {}),
              ("spheres150k", Renderer(compile_scene(random_sphere_geometry(150000),
                                                     device=device),
                                       width=WIDTH, height=HEIGHT, device=device),
               _LEG_ENV["150000"]))
    for name, r, frame_knobs in frames:
        r.settings.max_frames = 0
        for transport, knobs in TRANSPORTS:
            for mode in MODES:
                run_knobs = {**frame_knobs, **knobs}
                with knobs_set(run_knobs):
                    print(json.dumps({**_profile(name, r, transport, mode),
                                      "knobs": run_knobs}), flush=True)
    for line in chunk_race(spheres1000, device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
