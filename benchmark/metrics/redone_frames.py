"""redone_frames: frames of the window that the program redid eagerly
because their binned buffer overflowed (Renderer.stats["redone_frames"]
over the window)."""


def read(ctx):
    return ctx.stats.get("redone_frames")
