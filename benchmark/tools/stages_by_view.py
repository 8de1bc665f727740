"""Device ms a frame of each span of the program's recorder, view by view:
where a run's frames slow (the slow start) or speed up.

    python benchmark/tools/stages_by_view.py EXPORT [--per-view 100] [--top 12]

EXPORT is a recorder export (benchmark/tools/recorded.py writes one, plain
or gzipped). The rows after the last profiled one are taken in groups of
--per-view (the traffic's frames_per_view), and each group's mean device
ms a frame of every span name is printed, one JSON line a view, with the
view's host ms a frame (call to call), then one line with the spans'
slowest-minus-fastest view, largest first.
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys


def load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def views(summary: dict, per_view: int) -> list:
    rows = summary["frames"]
    last = max((i for i, row in enumerate(rows) if row["profiler"]), default=-1)
    rows = rows[last + 1:]
    out = []
    for v in range(0, len(rows) - per_view + 1, per_view):
        group = rows[v:v + per_view]
        frames = sum(row["timed_frames"] for row in group)
        ms = {}
        for row in group:
            for name, (_, dur, _) in row["spans"].items():
                ms[name] = ms.get(name, 0.0) + dur / frames
        wall = (group[-1]["call_ns"] - group[0]["call_ns"]) * 1e-6 / (len(group) - 1)
        out.append({"view": v // per_view, "host_ms": wall,
                    "t_s": (group[0]["call_ns"] - rows[0]["call_ns"]) * 1e-9, "ms": ms})
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("export")
    p.add_argument("--per-view", type=int, default=100)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args()
    vs = views(load(args.export), args.per_view)
    for v in vs:
        print(json.dumps(v))
    if vs:
        names = set().union(*(v["ms"] for v in vs))
        spread = {n: max(v["ms"].get(n, 0.0) for v in vs) - min(v["ms"].get(n, 0.0) for v in vs)
                  for n in names}
        top = sorted(spread.items(), key=lambda kv: -kv[1])[:args.top]
        print(json.dumps({"slowest_minus_fastest_view_ms": dict(top)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
