"""graph_capture_s: seconds of the program's first frame.capture span (the
warm frame, which builds the kernels and the scene's operands, and the
capture)."""

from benchmark.harness import recorder as R


def read(ctx):
    return R.first_host_s(ctx, "frame.capture")
