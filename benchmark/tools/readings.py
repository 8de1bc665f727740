"""The readings that the check's limits are set from, on the chip.

    python benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--counts 1,10,100] [--out FILE]

For each seed, in one process: the cell's program set up as a run sets it
up, the first view's frames rendered one at a time through
Renderer.render_frame() as the window renders them, and the image read at
the sampled pixels after each frame count in --counts. Then, with the
program freed, the reference scene of the cell's scene kind
(main.reference_scene) renders the same pixels and frames, and the check's
numbers are taken at each count: the program's readings. The witness, a
sound float32 render that rounds otherwise (the reference with its camera
origin one ulp away, so that paths part within a few bounces as they would
in a program that rounds otherwise), is put in the program's place and
read the same way on every seed. For the control seeds the control, the
kind's reference scene computed in bfloat16, is read the same way. Two
faults are read from the program's data: the image left at its first
frame ("unchanged") and every frame's red channel 5% high ("gain").

One JSON line a seed on stdout and, with --out, in that file.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import cells as CELLS  # noqa: E402
from benchmark.harness import check as CHECK  # noqa: E402
from benchmark.harness import main as MAIN  # noqa: E402


def read_seed(cell, seed: int, counts: list, control: bool) -> dict:
    t0 = time.perf_counter()
    prog = MAIN.set_up(cell, seed, "cuda")
    r = prog.renderer
    width, height = r.width, r.height
    ref = MAIN.reference_scene(cell, prog.geo, "cuda")
    rows, cols = MAIN.sample_pixels(cell, ref, prog.first, width, height, seed)
    images = {}
    for k in range(1, max(counts) + 1):
        r.render_frame()
        if k in counts:
            images[k] = r.accumulated()[rows, cols]
    stats = dict(r.stats)
    geo, first = prog.geo, prog.first
    del prog, r
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    expected = MAIN.reference_means(cell, ref, first, width, height, rows, cols, counts)
    t_ref = time.perf_counter() - t1
    view = MAIN._view(cell, ref, first, width, height)
    view = dataclasses.replace(view, origin=np.nextafter(view.origin, np.float32(np.inf)))
    witness = CHECK.reference_means(ref, cell.config["settings"], view, width, height,
                                    rows, cols, counts)
    out = {"cell": cell.name, "seed": seed, "pixels": len(rows), "stats": stats,
           "reference_s": t_ref, "program": {}, "witness": {},
           "faults": {"unchanged": {}, "gain": {}}}
    gain = np.array([1.05, 1.0, 1.0], np.float32)
    for k, exp, wit in zip(counts, expected, witness):
        out["program"][k] = CHECK.compare(images[k], exp)
        out["witness"][k] = CHECK.compare(wit.mean, exp)
        out["faults"]["gain"][k] = CHECK.compare(images[k] * gain, exp)
        if k > 1:
            out["faults"]["unchanged"][k] = CHECK.compare(images[min(counts)], exp)
    if control:
        del ref
        low = MAIN.reference_scene(cell, geo, "cuda", torch.bfloat16)
        lowered = MAIN.reference_means(cell, low, first, width, height, rows, cols, counts)
        out["control"] = {k: CHECK.compare(v.mean, exp)
                          for k, v, exp in zip(counts, lowered, expected)}
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--counts", default="1,10,100")
    p.add_argument("--out")
    args = p.parse_args()
    spec = CELLS.load_spec()
    cell = CELLS.load_cell(args.workload, spec)
    MAIN.set_program_env(cell)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {MAIN.card_line()}", file=sys.stderr)
    counts = sorted(int(c) for c in args.counts.split(","))
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(read_seed(cell, seed, counts, seed in control))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
