"""What the program's recorder costs when on, frame for frame, on the chip.

    python benchmark/tools/recorder_cost.py --workload <cell> --seed <n> --seconds <s>

Two programs of the cell in one process, set up as a run sets one up: the
first with the recorder (webgl_raytracer_tpu_torch/utils/telemetry.py)
off, the second with it on, each with its own captured frame. Their
frames then alternate off, on, on, off through Renderer.render_frame(),
with the recorder on only around the second's, both turning to the next
view of the orbit together, for --seconds. So both see the same slow
start, views and clocks. Then each side's captured frame is replayed 20
times alone, synchronised, to time the host's replay call. Prints one JSON
line: each side's mean and median call-to-return ms a frame, their ratio,
the recorded side's device frame ms and each side's median replay call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.harness import cells as CELLS  # noqa: E402
from benchmark.harness import main as MAIN  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()
    spec = CELLS.load_spec()
    cell = CELLS.load_cell(args.workload, spec)
    MAIN.set_program_env(cell)
    if not torch.cuda.is_available():
        print("recorder_cost: no CUDA device", file=sys.stderr)
        return 2
    from webgl_raytracer_tpu_torch.utils import telemetry

    off = MAIN.set_up(cell, args.seed, "cuda")
    rec = telemetry.enable()
    on = MAIN.set_up(cell, args.seed, "cuda")
    telemetry.disable()
    per_view = int(cell.traffic["frames_per_view"])
    ms = {"off": [], "on": []}
    start, frames = time.perf_counter(), 0
    while time.perf_counter() - start < args.seconds:
        for side in ("off", "on", "on", "off"):
            prog = off if side == "off" else on
            telemetry.recorder = rec if side == "on" else None
            t0 = time.perf_counter()
            prog.renderer.render_frame()
            ms[side].append((time.perf_counter() - t0) * 1e3)
        telemetry.disable()
        frames += 2
        if frames % per_view == 0:
            view = next(off.orbit)
            next(on.orbit)
            MAIN._set_view(off.renderer, view)
            MAIN._set_view(on.renderer, view)
    replay_ms = {}
    for side, prog in (("off", off), ("on", on)):
        calls = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog.renderer._graph.graph.replay()
            calls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        replay_ms[side] = statistics.median(calls)
    rows = [row for row in rec.frames() if row["frames"] == 1][2:]
    out = {"cell": cell.name, "seed": args.seed, "card": MAIN.card_line(),
           "frames_each": len(ms["off"]),
           "off_ms": statistics.fmean(ms["off"]), "on_ms": statistics.fmean(ms["on"]),
           "off_median_ms": statistics.median(ms["off"]),
           "on_median_ms": statistics.median(ms["on"]),
           "on_device_frame_ms": statistics.fmean(row["frame_ms"] for row in rows)}
    out["on_over_off"] = out["on_ms"] / out["off_ms"]
    out["replay_call_ms"] = replay_ms
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
