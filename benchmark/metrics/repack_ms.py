"""repack_ms: device ms a frame in the binned transport's moves, its
bounce-0 pack (frame.head's pack: live_first_index, pack_rows,
gather_rows) and every re-pack by bin key (repack), over the frames after
the profiled ones; None where no frame took the binned transport."""

from benchmark.harness import recorder as R


def read(ctx):
    rows = R.unprofiled(ctx)
    if rows is None or not R.has_span(rows, "pack"):
        return None
    return R.span_ms(rows, ["pack", "repack"]) / R.timed(rows)
