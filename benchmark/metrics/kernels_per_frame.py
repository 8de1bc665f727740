"""kernels_per_frame: device kernels executed a frame (copies and fills
not counted), over the profiled frames."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.frames:
        return None
    n = sum(1 for e, _, _ in p.clipped() if e.cat == "kernel")
    return n / p.frames if n else None
