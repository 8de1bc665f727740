"""env_ms: device ms a frame of the environment's own work, the self time
of the env.miss spans (the misses' lookups and MIS pdf) and the env.nee
spans (direction sampling, the CDF bisection, the BRDF evaluation, the
clamp; its any-hit kernel is a child), over the frames after the profiled
ones; None where no frame has an env.nee span (no environment)."""

from benchmark.harness import recorder as R


def read(ctx):
    rows = R.unprofiled(ctx)
    if rows is None or not R.has_span(rows, "env.nee"):
        return None
    return R.span_ms(rows, ["env.miss", "env.nee"], column=2) / R.timed(rows)
