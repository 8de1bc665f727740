"""The port's headline benchmark: Mray/s at 1920x1080 on one GPU.

    python -m webgl_raytracer_tpu_torch.bench [FRAMES]

Counterpart of the repository's root bench.py, with its legs, its ray
definition, its output line and its gates. It runs on the card only:
without a CUDA device it exits nonzero with a message, and it has no CPU
fallback. The kernels build at first use from csrc/ into _build/, as at
every entry point of the port, so the first leg's process pays for that.

Legs, each in a process of its own (python -m webgl_raytracer_tpu_torch.bench
--leg SPEC FRAMES REPS), the headline first:
  1000    the headline: 1000 random spheres (seed 12345), ambient light
  10000   the 10k scaling scene
  150000  the 150k scaling scene (1976 clusters: the two-level per-ray walk)
  tstp    the TSTP cartoon (assets/proteins/TSTP.pdb); "tstp_ses" (with its
          SES) is accepted as a --leg spec but not run by main, as in bench.py
WRT_BIN_CAP_DIV is set per leg (_LEG_ENV) unless the caller sets it.

Rays (the Mray/s numerator): every traversal query of frame 0, the
closest-hit path segments (camera rays and surviving bounce rays) plus the
any-hit occlusion candidates (shadow rays, and env-NEE rays where an
environment is lit), counted by render_batch_stats (_ray_counts).
Timing: a warm block of FRAMES graph frames (Renderer.render_frames), which
captures the frame, then the best of REPS blocks, each timed between
torch.cuda.synchronize() calls. A leg whose binned buffer overflowed has
its blocks redone eagerly (render/frame.py), is timed as such, and says so
in the line ("redone").

Output: after each leg one JSON line, bench.py's without vs_baseline (that
divides by a TPU target; the port sets no baseline), detail.device the
card's name and power limit as nvidia-smi gives them. The last line on
stdout is always the most complete; it is mirrored to
BENCH_PARTIAL_TORCH.json at the repository root after every leg, and
SIGTERM or SIGINT re-print it (and stop the running leg) before exiting.
WRT_BENCH_BUDGET_S (default 420) bounds the run: each leg's timeout comes
from what remains, a leg that cannot get 30 s records {"skipped":
"budget"}, one cut after its warm block records its warm estimate. Unlike
bench.py it keeps no ray-count cache on disk (one eager frame is the whole
cost) and retries no leg: a leg that fails is reported as failed.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import torch

from .app.pipeline import load_molecule_scene
from .device import card_line, resolve_device
from .models import parse_auto_detect
from .render import Renderer
from .render.config import split_settings
from .render.integrator import render_batch_stats
from .render.lights import light_dirs_for_camera
from .scene import compile_scene, random_sphere_geometry

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTEIN = os.path.join(REPO_DIR, "assets", "proteins", "TSTP.pdb")
PARTIAL_PATH = os.path.join(REPO_DIR, "BENCH_PARTIAL_TORCH.json")
WIDTH, HEIGHT = 1920, 1080
DEFAULT_BUDGET_S = 420.0
MOLECULE_SPECS = ("tstp", "tstp_ses")
# No leg can exceed this rate on one card: a higher one means the timed
# blocks did not render.
MAX_MRAY_S = 1000.0

# WRT_BIN_CAP_DIV a leg: the binned buffer must hold the scene's primary
# hits, or every block is redone through the permuted transport.
_LEG_ENV = {
    "1000": {"WRT_BIN_CAP_DIV": "16"},
    "10000": {"WRT_BIN_CAP_DIV": "12"},
    "150000": {"WRT_BIN_CAP_DIV": "6"},
}


def molecule_geometry(spec: str, device=None):
    """The compiled TSTP cartoon: "tstp", or "tstp_ses" with its SES
    surface, through the port's molecule pipeline."""
    if spec not in MOLECULE_SPECS:
        raise ValueError(f"unknown molecule spec {spec!r}: one of {MOLECULE_SPECS}")
    with open(PROTEIN, encoding="utf-8") as f:
        mol = parse_auto_detect(f.read(), "TSTP.pdb")
    return load_molecule_scene(mol, display_style="cartoon",
                               show_surface=spec.endswith("ses"), device=device).scene


def _make_scene(spec: str, device=None):
    """A leg's compiled scene on `device` (None: cuda:0): a sphere count
    or a molecule spec."""
    device = resolve_device(device)
    if spec.isdigit():
        return compile_scene(random_sphere_geometry(int(spec)), device=device)
    return molecule_geometry(spec, device)


def _ray_counts(renderer) -> tuple[int, int]:
    """(path rays, occlusion rays) of frame 0 at the renderer's size,
    camera and settings, ambient and unclipped, through render_batch_stats."""
    r = renderer
    basis = r.camera.basis()
    flags, uniforms = split_settings(
        r.settings, basis, light_dirs_for_camera(r.settings.lights, basis),
        has_env=False, has_volume=False, clip=None, device=r.device)
    px, py = r._pixel_grids()
    _, (npath, noccl) = render_batch_stats(r.scene, flags, uniforms, px, py, 0)
    return int(npath), int(noccl)


def bench_scene(spec: str, frames: int, reps: int, width: int = WIDTH,
                height: int = HEIGHT, device=None):
    """Best-of-reps graph-frame timing of one scene.

    Returns (frame ms, path rays, occlusion rays, {"overflowed_blocks",
    "redone_frames"} over every block of the leg). Prints a
    {"ms_warm_est": ...} line after the warm block, so that a parent that
    times the leg out still has an estimate."""
    device = resolve_device(device)
    r = Renderer(_make_scene(spec, device), width=width, height=height, device=device)
    r.settings.tone_map = "linear"
    path_rays, occl_rays = _ray_counts(r)
    r.settings.max_frames = 10 ** 9

    def block_ms() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        r.render_frames(frames)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1000.0 / frames

    warm = block_ms()
    print(json.dumps({"ms_warm_est": warm, "path": path_rays, "occl": occl_rays}),
          flush=True)
    ms = min(block_ms() for _ in range(reps))
    stats = {k: r.stats[k] for k in ("overflowed_blocks", "redone_frames")}
    return ms, path_rays, occl_rays, stats


def _scene_leg(spec: str, frames: int, reps: int, timeout_s: float,
               running: list | None = None) -> dict:
    """One leg in a process of its own. Returns {"ms", "path", "occl",
    "overflowed_blocks", "redone_frames"}, or {"ms", "path", "occl",
    "estimate": True} when only the warm block finished before the
    timeout, or {"skipped" or "error": reason}. The child is listed in
    `running` while it runs."""
    if timeout_s < 30.0:
        return {"skipped": "budget"}
    env = dict(os.environ)
    for k, v in _LEG_ENV.get(spec, {}).items():
        env.setdefault(k, v)
    cmd = [sys.executable, "-m", "webgl_raytracer_tpu_torch.bench", "--leg", spec,
           str(frames), str(reps)]
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, env=env, cwd=REPO_DIR) as proc:
        if running is not None:
            running.append(proc)
        try:
            stdout, stderr = proc.communicate(timeout=timeout_s)
            timed_out = False
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            timed_out = True
        finally:
            if running is not None:
                running.remove(proc)
    if not timed_out and proc.returncode != 0:
        tail = stderr.strip().splitlines()[-3:]
        return {"error": f"rc={proc.returncode}: " + " | ".join(tail)}
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    if not lines:
        return {"skipped": "timeout before warmup"}
    d = json.loads(lines[-1])
    if "ms" in d:
        return d
    return {"ms": d["ms_warm_est"], "path": d["path"], "occl": d["occl"],
            "estimate": True}


def _mray(leg) -> float | None:
    if not leg or "ms" not in leg:
        return None
    return (leg["path"] + leg["occl"]) / (leg["ms"] / 1000.0) / 1e6


def _plausible(leg) -> bool:
    rate = _mray(leg)
    return rate is None or rate <= MAX_MRAY_S


def _redone(leg) -> dict:
    """{"redone": ...} for a leg whose blocks overflowed and were redone
    eagerly, else {}."""
    if not leg.get("overflowed_blocks"):
        return {}
    return {"redone": {"overflowed_blocks": leg["overflowed_blocks"],
                       "redone_frames": leg["redone_frames"]}}


def _result_line(device: str, budget_s: float, leg_1k, leg_10k, leg_150k,
                 leg_mol=None) -> dict:
    scaling = {}
    for name, leg in (("spheres10000", leg_10k), ("spheres150000", leg_150k),
                      ("molecule_tstp_cartoon", leg_mol)):
        if leg is None:
            scaling[name] = {"skipped": "pending"}
        elif "ms" in leg:
            entry = {"frame_ms": round(leg["ms"], 1),
                     "mray_s": round(_mray(leg), 2), **_redone(leg)}
            if leg.get("estimate"):
                entry["estimate"] = "warmup-only (leg timed out)"
            scaling[name] = entry
        else:
            scaling[name] = leg
    if leg_10k and "ms" in leg_10k and "ms" in leg_1k:
        ratio = leg_10k["ms"] / leg_1k["ms"]
        # bench.py's gate: it catches a large-scene cliff, not the ratio of
        # two differently tuned paths.
        scaling["ratio_10k_vs_1k"] = round(ratio, 2)
        scaling["ratio_10k_vs_1k_ok"] = bool(ratio <= 4.0)
    total_mray = _mray(leg_1k)
    return {
        "metric": "Mrays/sec/chip @1080p, 1000-sphere scene, 4 bounces, "
                  "3-light NEE; rays = closest-hit path segments + any-hit "
                  "shadow/NEE occlusion candidates",
        "value": round(total_mray, 2),
        "unit": "Mray/s",
        "detail": {
            "frame_ms": round(leg_1k["ms"], 1),
            "path_rays_per_frame": leg_1k["path"],
            "occl_rays_per_frame": leg_1k["occl"],
            "path_mray_s": round(
                leg_1k["path"] / (leg_1k["ms"] / 1000.0) / 1e6, 2),
            "resolution": f"{WIDTH}x{HEIGHT}",
            "device": device,
            "budget_s": budget_s,
            **_redone(leg_1k),
            "scaling": scaling,
        },
    }


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("webgl_raytracer_tpu_torch.bench: no CUDA device; the bench runs on "
              "the card only and has no CPU fallback", file=sys.stderr)
        return 1
    if argv[:1] == ["--leg"]:
        spec, frames, reps = argv[1], int(argv[2]), int(argv[3])
        ms, path, occl, stats = bench_scene(spec, frames, reps)
        print(json.dumps({"ms": ms, "path": path, "occl": occl, **stats}), flush=True)
        return 0

    budget_s = float(os.environ.get("WRT_BENCH_BUDGET_S", DEFAULT_BUDGET_S))
    t0 = time.monotonic()

    def remaining() -> float:
        return budget_s - (time.monotonic() - t0)

    device = card_line() or torch.cuda.get_device_name(0)
    state = {"line": None}
    running: list = []

    def emit(leg_1k, leg_10k, leg_150k, leg_mol=None):
        state["line"] = _result_line(device, budget_s, leg_1k, leg_10k, leg_150k, leg_mol)
        print(json.dumps(state["line"]), flush=True)
        try:
            with open(PARTIAL_PATH, "w", encoding="utf-8") as f:
                json.dump(state["line"], f, indent=1)
                f.write("\n")
        except OSError as exc:
            print(f"could not write {PARTIAL_PATH}: {exc}", file=sys.stderr)

    def on_term(signum, frame):
        for proc in running:
            proc.kill()
        if state["line"] is not None:
            print(json.dumps(state["line"]), flush=True)
        os._exit(1)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    frames = int(argv[0]) if argv else 12
    # The headline leg first, with at most half the budget.
    leg_1k = _scene_leg("1000", frames, 4, max(remaining() / 2 - 10.0, 30.0), running)
    if "ms" not in leg_1k or not _plausible(leg_1k):
        print(f"headline leg failed: {leg_1k}", file=sys.stderr)
        return 1
    emit(leg_1k, None, None)

    implausible = {"error": "implausible timing (timed reps did not render)"}
    leg_10k = _scene_leg("10000", max(frames // 2, 4), 2,
                         min(remaining() - 240.0, 120.0), running)
    leg_10k = leg_10k if _plausible(leg_10k) else implausible
    emit(leg_1k, leg_10k, None)

    leg_150k = _scene_leg("150000", 3, 2, remaining() - 75.0, running)
    leg_150k = leg_150k if _plausible(leg_150k) else implausible
    emit(leg_1k, leg_10k, leg_150k)

    leg_mol = _scene_leg("tstp", max(frames // 2, 4), 2, remaining() - 5.0, running)
    leg_mol = leg_mol if _plausible(leg_mol) else implausible
    emit(leg_1k, leg_10k, leg_150k, leg_mol)
    return 0


if __name__ == "__main__":
    sys.exit(main())
