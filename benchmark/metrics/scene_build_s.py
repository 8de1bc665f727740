"""scene_build_s: seconds of the benchmark's span around compile_scene."""


def read(ctx):
    return ctx.spans.get("scene_build_s")
