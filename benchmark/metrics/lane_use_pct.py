"""lane_use_pct: % of the binned buffer's lanes that were live, 100 x the
live lanes over the lanes run, summed over the bounces of the frames after
the profiled ones (the program's counter); None without binned frames."""

from benchmark.harness import recorder as R


def read(ctx):
    rows = R.unprofiled(ctx)
    rows = [row for row in rows or () if "lanes" in row]
    run = sum(sum(row["lanes_run"]) for row in rows)
    if not run:
        return None
    return 100.0 * sum(sum(row["lanes"]) for row in rows) / run
