"""transport_self_ms: device ms a frame in the program's `frame` spans less
its hand-kernel spans (the transport's PyTorch work, copies and gaps inside
the frame), over the frames after the profiled ones (the program's
recorder, harness/recorder.py)."""

from benchmark.harness import recorder as R


def read(ctx):
    rows = R.unprofiled(ctx)
    if rows is None:
        return None
    return (R.span_ms(rows, ["frame"]) - R.span_ms(rows, R.kernels(ctx))) / R.timed(rows)
