"""trace_kernel_ms: device ms a frame of the program's hand-written
kernels, matched by the names the program gives them (its launch counters'
names and its CUDA sources' stems), over the profiled frames."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.frames:
        return None
    us = sum(t - s for e, s, t in p.clipped()
             if e.cat == "kernel" and ctx.is_hand_kernel(e.name))
    return us * 1e-3 / p.frames if us > 0.0 else None
