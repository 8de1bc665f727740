"""idle_pct: % of the profiled frames' wall time in which nothing runs on
the device (no kernel, copy or fill), from the one traced timeline."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0.0 or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
