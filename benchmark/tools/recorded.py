"""One run of one cell with the program's recorder on, the harness otherwise
as run.py runs it.

    python benchmark/tools/recorded.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--export FILE]

The recorder (webgl_raytracer_tpu_torch/utils/telemetry.py) is turned on
before set-up and handed to the readers as Context.telemetry (its
summary); the line of a --trace 1 run also carries the metrics that read
it (RECORDER_METRICS: benchmark/metrics/ and harness/recorder.py). The
recorder's export goes to --export, by default
.benchmark_cache/telemetry.<cell>.<seed>.json. A --trace 0 run's line has
the end-to-end metrics: the frame time with the recorder on. This is the
run that run_cell makes once it turns the recorder on in --trace 1 runs
(PERF.md, Open questions); run.py's runs leave it off.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.harness import cells as CELLS  # noqa: E402
from benchmark.harness import main as MAIN  # noqa: E402

# (name, unit) of the per-layer metrics that read the recorder.
RECORDER_METRICS = (("transport_self_ms", "ms"), ("trace_span_ms", "ms"), ("env_ms", "ms"),
                    ("repack_ms", "ms"), ("lane_use_pct", "%"), ("graph_idle_pct", "%"),
                    ("host_dispatch_ms", "ms"), ("recaptures", "captures"),
                    ("scene_compile_s", "s"), ("graph_capture_s", "s"))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--export")
    args = p.parse_args()
    spec = CELLS.load_spec()
    cell = CELLS.load_cell(args.workload, spec)
    MAIN.set_program_env(cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"recorded: cell {cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    print(f"card: {MAIN.card_line()}", file=sys.stderr)
    from webgl_raytracer_tpu_torch.utils import telemetry

    rec = telemetry.enable()

    class RecordedContext(MAIN.Context):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.telemetry = rec.summary()

    MAIN.Context = RecordedContext
    names = {m["name"] for m in spec["per_layer"]}
    spec["per_layer"] = spec["per_layer"] + [{"name": n, "unit": u}
                                             for n, u in RECORDER_METRICS if n not in names]
    result = MAIN.run_cell(cell, spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    path = args.export or MAIN.CACHE_DIR / f"telemetry.{cell.name}.{args.seed}.json"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    telemetry.export(path)
    result["telemetry_export"] = str(path)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
