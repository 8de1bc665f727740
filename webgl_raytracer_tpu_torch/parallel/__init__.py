"""Multi-GPU scaling: frame tiles sharded over a device mesh.

The scene is read-only during tracing, so there is no parameter-sync
problem: scene, environment and volume tensors are copied to every card,
the flat pixel batch is split into contiguous shards, one a card, and
each card traces its shard alone. Cards exchange data only at readout
(the image gather) or when samples per pixel are sharded (the partial
sums added on one card). Counterpart of webgl_raytracer_tpu/parallel.
"""

from .mesh import (
    Mesh,
    make_mesh,
    replicate_scene,
    shard_rays,
    render_tiles_sharded,
)

__all__ = ["Mesh", "make_mesh", "replicate_scene", "shard_rays", "render_tiles_sharded"]
