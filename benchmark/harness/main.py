"""One run of one cell: set-up, the measured window, the check, the line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from the start of run.py to the first timed
frame): the program's import and kernel library, the scene drawn from the
seed and built by the configuration's scene kind (its generator module,
benchmark/generators/<generator>.py: span scene_build_s), the sky where
the traffic has one, the Renderer with the kind's volume and the
configuration's settings, the first view, and two warm frames (the first
captures the frame: span capture_s). Then the window: frames through
Renderer.render_frame() one at a time, the camera turning to the next view
of the seeded orbit after every frames_per_view frames, until --seconds
have passed. With --trace 1 the window's first profile_frames frames run
under torch.profiler and the line carries the per-layer metrics instead of
the end-to-end ones.

After the window: the device's peak memory is read, the view shown at
the close is rendered on to its frames_per_view frames (uncounted), the
image is read back, the program's state is freed, and the kind's plain
reference scene renders the sampled pixels of that view's frames
(harness/check.py).

The last stdout line is the JSON result; the check's numbers and limits
are the last lines on stderr and the last key of the line.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from ..reference import camera as CAM
from . import cells as CELLS
from . import check as CHECK
from . import traffic as TRAFFIC
from .trace import Tracer
from .window import run_window

BANNED = ("jax", "jaxlib", "flax", "webgl_raytracer_tpu")
CACHE_DIR = CELLS.ROOT / ".benchmark_cache"


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    profile: object = None                         # trace.Profile, or None
    hand_kernels: tuple = ()                       # the program's kernel names
    spans: dict = field(default_factory=dict)      # seconds of the benchmark's spans
    stats: dict = field(default_factory=dict)      # Renderer.stats over the window

    def is_hand_kernel(self, name: str) -> bool:
        return any(k in name for k in self.hand_kernels)


def banned_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read: {exc}"
    return " | ".join(smi.stdout.strip().splitlines()) or f"nvidia-smi rc {smi.returncode}"


def set_program_env(cell: CELLS.Cell) -> None:
    """The cell's knobs, and every kernel cache inside the checkout."""
    os.environ.update(cell.program_env)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")


def _apply_settings(settings, values: dict) -> None:
    for key, value in values.items():
        if key == "lights":
            for light, cfg in zip(settings.lights, value):
                for k, v in cfg.items():
                    setattr(light, k, tuple(v) if isinstance(v, list) else v)
        else:
            setattr(settings, key, tuple(value) if isinstance(value, list) else value)


def _set_view(renderer, view: dict) -> None:
    """Turn the camera to `view` and restart accumulation, as the viewer's
    drag does."""
    renderer.camera.target = view["target"]
    renderer.camera.distance = view["distance"]
    renderer.camera.rotation = view["rotation"]
    renderer.camera.fov = view["fov"]
    renderer.reset_accumulation()


@dataclass
class Program:
    """The program under test, set up for one cell and seed."""
    renderer: object
    geo: object         # what the kind's generate drew from the seed
    orbit: object       # the seeded views after the first
    first: dict         # the first view
    spans: dict


def set_up(cell: CELLS.Cell, seed: int, device: str, size=None) -> Program:
    """The scene drawn from the seed and built by the cell's scene kind,
    the sky, the Renderer with the kind's volume and the configuration's
    settings at the first view, and two warm frames (the first captures),
    accumulation restarted."""
    from webgl_raytracer_tpu_torch.env import EnvironmentController
    from webgl_raytracer_tpu_torch.render import Renderer

    cfg, trf, kind = cell.config, cell.traffic, cell.kind
    width, height = size or (int(cfg["width"]), int(cfg["height"]))

    def sync():
        if device.startswith("cuda"):
            torch.cuda.synchronize()

    spans = {}
    geo = kind.generate(cfg, seed)
    t = time.perf_counter()
    scene, volume = kind.program_scene(geo, cfg, device)
    sync()
    spans["scene_build_s"] = time.perf_counter() - t
    env = None
    if trf["sky"] is not None:
        env = EnvironmentController(device=device).load_analytic_sky(dict(trf["sky"]))
    renderer = Renderer(scene, env=env, volume=volume, width=width, height=height,
                        device=device)
    _apply_settings(renderer.settings, cfg["settings"])
    lo, hi = kind.bounds(geo)
    orbit = TRAFFIC.views(trf, float(cfg["fov"]), lo, hi, seed)
    first = next(orbit)
    _set_view(renderer, first)
    t = time.perf_counter()
    renderer.render_frame()
    sync()
    spans["capture_s"] = time.perf_counter() - t
    renderer.render_frame()
    _set_view(renderer, first)
    sync()
    return Program(renderer, geo, orbit, first, spans)


def run_cell(cell: CELLS.Cell, spec: dict, seed: int, seconds: float, trace: bool,
             device: str, t0: float, size=None, max_frames=None) -> dict:
    """One run; returns the result line's dict. size (width, height) and
    max_frames shrink a run for the CPU tests: the window stops after
    max_frames frames, and the check compares at most that many."""
    from webgl_raytracer_tpu_torch.ops.kernels import SOURCES, launches

    trf = cell.traffic
    cuda = device.startswith("cuda")
    prog = set_up(cell, seed, device, size)
    renderer = prog.renderer
    width, height = renderer.width, renderer.height
    stats0 = dict(renderer.stats)
    setup_s = time.perf_counter() - t0
    shown = {"view": prog.first}

    def turn():
        shown["view"] = next(prog.orbit)
        _set_view(renderer, shown["view"])

    tracer = None
    if trace:
        tracer = Tracer(int(trf["profile_frames"]))
        tracer.prime(device)
    window = run_window(renderer.render_frame, turn, int(trf["frames_per_view"]), seconds,
                        max_frames=max_frames, on_frame=tracer.step if tracer else None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = {k: renderer.stats[k] - stats0[k] for k in stats0}
    frames_in_view = renderer.frame_index
    check_frames = min(int(trf["frames_per_view"]), max_frames or math.inf)
    while renderer.frame_index < check_frames and renderer.render_frame():
        pass
    frames_shown = renderer.frame_index
    image = renderer.accumulated()
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    profile = tracer.profile() if tracer else None
    geo, first, spans = prog.geo, prog.first, prog.spans
    del prog, renderer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_scene(cell, geo, device)
    rows, cols = sample_pixels(cell, ref, shown["view"], width, height, seed)
    expected = reference_means(cell, ref, shown["view"], width, height, rows, cols,
                               [frames_shown])[0]
    numbers = CHECK.compare(image[rows, cols], expected)
    share = warm_hit_share(cell, ref, first, width, height, seed)
    print(f"primary hit share of the warm frame's view: {100 * share:.4f}% of the centre "
          f"rays of {min(int(trf['check_candidates']), width * height)} seeded pixels "
          f"(reference); program knobs {cell.program_env}", file=sys.stderr)
    result = {"correct": CHECK.verdict(numbers, cell.limits),
              "attempted": len(window.frame_s), "failed": window.failed}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    if not trace:
        values = {"frame_ms": window.frame_ms(), "frame_p95_ms": window.p95_ms(),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    else:
        ctx = Context(profile=profile, hand_kernels=tuple(launches) + tuple(
            s.rsplit(".", 1)[0] for s in SOURCES), spans=spans, stats=stats)
        metrics = {}
        for m in spec["per_layer"]:
            value = CELLS.load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = profile.busy_s()
        device_info["window_s"] = profile.window_s
        result["breakdown"] = profile.breakdown()
    result["metrics"] = metrics
    result["device"] = device_info
    result["window"] = {"seconds": window.seconds, "frames": len(window.frame_s),
                        "views": window.views, "frames_in_last_view": frames_in_view,
                        "check_frames": frames_shown,
                        "view_ms": window.view_ms(int(trf["frames_per_view"]))}
    result["check"] = {k: {"value": _finite(v), "limit": cell.limits.get(k, "not compared")}
                       for k, v in numbers.items()}
    return result


def reference_scene(cell: CELLS.Cell, geo, device: str, dtype=torch.float32):
    """The kind's reference scene of `geo` under the traffic's sky, in
    `dtype`."""
    return cell.kind.reference_scene(geo, cell.config, cell.traffic["sky"], device, dtype)


def _view(cell, ref, view, width, height):
    return CAM.make_view(cell.config["settings"], view, width, height, ref.lo, ref.hi)


def sample_pixels(cell, ref, view, width, height, seed):
    """(rows, cols) the check compares at `view`."""
    trf = cell.traffic
    rows, cols, _ = CHECK.choose_pixels(ref, _view(cell, ref, view, width, height), width,
                                        height, seed, int(trf["check_pixels"]),
                                        int(trf["check_candidates"]))
    return rows, cols


def warm_hit_share(cell, ref, view, width, height, seed) -> float:
    return CHECK.choose_pixels(ref, _view(cell, ref, view, width, height), width, height,
                               seed, 0, int(cell.traffic["check_candidates"]))[2]


def reference_means(cell, ref, view, width, height, rows, cols, counts) -> list:
    """The reference's running means at the pixels after each frame count
    in `counts`."""
    return CHECK.reference_means(ref, cell.config["settings"],
                                 _view(cell, ref, view, width, height),
                                 width, height, rows, cols, counts)


def _finite(v: float):
    return v if math.isfinite(v) else str(v)


def main(argv=None, t0=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = CELLS.load_spec()
    cell = CELLS.load_cell(args.workload, spec)
    set_program_env(cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result = run_cell(cell, spec, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = banned_modules()
    if found:
        print(f"benchmark: modules loaded that the benchmark must not load: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
