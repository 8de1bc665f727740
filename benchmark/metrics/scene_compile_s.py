"""scene_compile_s: seconds of the program's scene.compile span (host BVH,
clusters and upload), its first in the run."""

from benchmark.harness import recorder as R


def read(ctx):
    return R.first_host_s(ctx, "scene.compile")
