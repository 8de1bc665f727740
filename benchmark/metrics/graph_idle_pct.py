"""graph_idle_pct: % of the host's wall time, from one render_frames call to
the next, in which the device was not inside a `frame` span: 100 x (1 -
Σ device frame ms / Σ call-to-call ms) over consecutive frames after the
profiled ones, without the profiler's cost."""

from benchmark.harness import recorder as R


def read(ctx):
    rows = R.unprofiled(ctx)
    if rows is None or len(rows) < 2:
        return None
    busy = sum(row["frame_ms"] for row in rows[:-1])
    wall = (rows[-1]["call_ns"] - rows[0]["call_ns"]) * 1e-6
    return 100.0 * (1.0 - busy / wall) if wall > 0.0 else None
