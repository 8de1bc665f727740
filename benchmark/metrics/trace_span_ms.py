"""trace_span_ms: device ms a frame in the program's hand-kernel spans (one
around every launch through ops/kernels.launch), over the frames after the
profiled ones (the program's recorder, harness/recorder.py)."""

from benchmark.harness import recorder as R


def read(ctx):
    rows = R.unprofiled(ctx)
    if rows is None:
        return None
    return R.span_ms(rows, R.kernels(ctx)) / R.timed(rows)
