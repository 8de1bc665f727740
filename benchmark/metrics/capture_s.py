"""capture_s: seconds of the benchmark's span around the first frame, which
builds the kernels' operands and captures the frame as a CUDA graph."""


def read(ctx):
    return ctx.spans.get("capture_s")
