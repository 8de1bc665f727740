"""Where the time of a 1080p frame goes, on a GPU.

    python -m webgl_raytracer_tpu_torch.profile_frame

For each of four frames — the 1000-sphere main path (default settings,
ambient light), the same scene under the default analytic sky (1024x512,
env_intensity 0.4; the frame whose env NEE takes trace_any), the
10k-sphere scene under that sky (the per-ray kernels) and the TSTP protein
cartoon (assets/proteins/TSTP.pdb through app/pipeline, ambient light;
triangles, spheres and cylinders, so the block kernels) — and each of two
transports — the binned one that 1080p frames take by default, and the
whole batch (WRT_CHUNKS=1) for comparison — renders at 1920x1080 one warm frame, TIMED_FRAMES frames
timed one by one, then one frame under torch.profiler, and prints one
JSON line: the timed frames' wall milliseconds (mean and each), the
profiled frame's, its device busy time (sum of kernel times), the idle
share against the profiled wall and against the timed frames' mean (an
estimate: busy and wall time come from different frames of one run), the
trace kernels' time and launches, and the top kernels by device time.
The first line is the card's name and power limit as nvidia-smi gives
them.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

WIDTH, HEIGHT = 1920, 1080
PROTEIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "proteins", "TSTP.pdb")
TOP_KERNELS = 12
TIMED_FRAMES = 5
TRACE_KERNELS = ("trace_closest_kernel", "trace_any3_kernel", "trace_any3_raymajor_kernel",
                 "trace_any_kernel", "trace_any_raymajor_kernel",
                 "trace_closest_perray_kernel", "trace_any_perray_kernel",
                 "trace_closest_attrs_kernel")
TRANSPORTS = (("binned", {}), ("whole batch", {"WRT_CHUNKS": "1"}))


def profile_scene(name, r, transport, knobs) -> dict:
    """Profile one frame of `r` with the environment knobs set."""
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        return _profile(name, r, transport)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _profile(name, r, transport) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r.settings.tone_map = "linear"
    r.render_frame()
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000.0)
    plain_wall_ms = sum(walls) / len(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0

    rows = []
    for e in prof.key_averages():
        # Kernel rows only: operator rows repeat their kernels' time.
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.key, e.self_device_time_total / 1000.0, e.count))
    rows.sort(key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in rows)
    def is_(t, key):
        # Mangled ("...16trace_any_kernelEPKf...") or demangled ("trace_any_kernel(").
        return t + "E" in key or t + "(" in key

    traces = {t: [sum(ms for k, ms, _ in rows if is_(t, k)),
                  sum(c for k, _, c in rows if is_(t, k))] for t in TRACE_KERNELS}
    return {
        "scene": name, "transport": transport,
        "device": torch.cuda.get_device_name(0),
        "size": f"{WIDTH}x{HEIGHT}",
        "wall_ms": wall_ms, "unprofiled_wall_ms": plain_wall_ms,
        "unprofiled_wall_ms_each": walls,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_idle_share_unprofiled_est": max(0.0, 1.0 - busy_ms / plain_wall_ms),
        "trace_kernels_ms": sum(v[0] for v in traces.values()),
        "trace_kernels_ms_calls": traces,
        "kernel_launches": sum(c for _, _, c in rows),
        "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                for k, ms, c in rows[:TOP_KERNELS]]}


def main() -> int:
    import torch

    from .app.pipeline import load_molecule_scene
    from .env import EnvironmentController
    from .models import parse_auto_detect
    from .render import Renderer
    from .scene import compile_scene, random_sphere_geometry

    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    device = torch.device("cuda", 0)
    nvsmi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(nvsmi, flush=True)
    sky = EnvironmentController(device=device).load_analytic_sky()
    spheres1000 = compile_scene(random_sphere_geometry(1000), device=device)
    with open(PROTEIN, encoding="utf-8") as f:
        tstp = load_molecule_scene(parse_auto_detect(f.read(), "TSTP.pdb"),
                                   display_style="cartoon", device=device).scene

    def lit(scene):
        r = Renderer(scene, env=sky, width=WIDTH, height=HEIGHT, device=device)
        r.settings.env_intensity = 0.4
        return r

    frames = (("spheres1000", Renderer(spheres1000, width=WIDTH, height=HEIGHT, device=device)),
              ("spheres1000 analytic sky", lit(spheres1000)),
              ("spheres10k analytic sky",
               lit(compile_scene(random_sphere_geometry(10000), device=device))),
              ("tstp cartoon", Renderer(tstp, width=WIDTH, height=HEIGHT, device=device)))
    for name, r in frames:
        for transport, knobs in TRANSPORTS:
            print(json.dumps(profile_scene(name, r, transport, knobs)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
