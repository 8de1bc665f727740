"""What the per-layer metrics read of the program's recorder
(webgl_raytracer_tpu_torch/utils/telemetry.py): its summary, held as
`telemetry` by the run's Context when the run recorded one (the
recorder's summary() or its export). A run without it reads None.

A row of the summary is one Renderer.render_frames call: host stamps
(call_ns, return_ns), host ms by span, device spans by name ([count, ms,
self ms]) over its timed frames, the binned buffer's live lanes and lanes
run per bounce, and whether a profiler was active. The metrics read the
rows after the last profiled one: the window's frames that ran without
the profiler.
"""

from __future__ import annotations


def summary(ctx):
    return getattr(ctx, "telemetry", None)


def unprofiled(ctx):
    """The rows after the last row a profiler was active in; None where
    there is no summary, no profiled row or no row after it."""
    t = summary(ctx)
    if not t:
        return None
    rows = t["frames"]
    last = max((i for i, row in enumerate(rows) if row["profiler"]), default=None)
    if last is None or last + 1 >= len(rows):
        return None
    return rows[last + 1:]


def kernels(ctx) -> set:
    """The names of the hand kernels' spans."""
    return set(summary(ctx)["kernels"])


def timed(rows) -> int:
    """The frames whose device spans the rows hold."""
    return sum(row["timed_frames"] for row in rows)


def span_ms(rows, names, column: int = 1) -> float:
    """Σ ms (column 1) or self ms (column 2) of the spans named `names`."""
    return sum(row["spans"][n][column] for row in rows for n in names if n in row["spans"])


def has_span(rows, name) -> bool:
    return any(name in row["spans"] for row in rows)


def first_host_s(ctx, name):
    """Seconds of the first host span `name`, or None."""
    t = summary(ctx)
    if not t:
        return None
    for span, _, start, end in t["host_spans"]:
        if span == name:
            return (end - start) * 1e-9
    return None
