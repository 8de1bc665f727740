"""host_dispatch_ms: host ms a frame in the frame loop's frame.setup
(uniforms, flags, buffers) and frame.launch (the replay call and the
launch counts) spans, over the frames after the profiled ones."""

from benchmark.harness import recorder as R


def read(ctx):
    rows = R.unprofiled(ctx)
    if rows is None:
        return None
    ms = sum(row["host_ms"].get(n, 0.0) for row in rows
             for n in ("frame.setup", "frame.launch"))
    return ms / sum(row["frames"] for row in rows)
