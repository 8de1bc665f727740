"""Device mesh for tile-parallel rendering over several cards.

Counterpart of webgl_raytracer_tpu/parallel/mesh.py, in one process on
one host thread, as the JAX package drives its mesh from one controller:

  * scene / env / volume / uniforms -> one copy a device (replicate_scene;
    molecular scenes are tiny next to a card's memory);
  * the flat pixel batch -> contiguous shards in ray order, one a device
    (shard_rays). The JAX package pads the batch to a multiple of the
    mesh size; here nothing needs a pad: shards may differ in size. They
    are whole blocks of the binned transport where the frame has one a
    shard, so that each shard takes the transport the whole frame takes;
  * every device runs the whole single-device frame on its own rays, its
    kernels launched on its own card (ops/kernels.launch). No op mixes
    rays, so nothing crosses between cards before readout;
  * readout copies the shards to one device in ray order: the only gather.

The Renderer's mesh path (render/frame.py, Renderer(mesh=...)) is the
counterpart of render_frames_tiles: one frame state a device, each
device's frame captured as a CUDA graph on that card and replayed from the
one thread, so the cards run together. render_spp_sharded splits the
samples instead of the pixels, for images too small to split.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import vec3 as V


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices of its shards, in shard order. A device may
    appear more than once (two shards on one card)."""
    devices: tuple
    axis_name: str = "tiles"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis_name: str = "tiles") -> Mesh:
    """1-D mesh over every visible card, or over `devices` (torch devices
    or their names; "cuda" means cuda:0, ["cpu"] * n is n shards on the
    CPU). Raises when no card is visible and none are given."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("no CUDA device is available: pass the mesh's devices, "
                               "e.g. ['cpu'] * n")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = tuple(torch.device("cuda", 0) if torch.device(d) == torch.device("cuda")
                    else torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis_name)


def replicate_scene(tree, mesh: Mesh) -> list:
    """One copy of `tree` a shard, in mesh order: a SceneBuffers,
    EnvBuffers, VolumeBuffers or Uniforms moved with its .to(). Shards on
    one device share one copy, and the device `tree` lies on gets `tree`
    itself. None gives a None a shard."""
    copies = {}
    for device in mesh.devices:
        if device not in copies:
            copies[device] = (tree if tree is None or tree.device == device
                              else tree.to(device))
    return [copies[device] for device in mesh.devices]


def shard_sizes(n: int, size: int) -> list:
    """Ray counts of `size` contiguous shards of n rays: whole blocks of
    the binned transport (integrator.BINNED_BLOCK rays) where there is
    one a shard, so that every shard can take the transport the whole
    frame takes, else single rays; the units split as evenly as they go,
    the first shards taking one more, the last shard also the rays left
    over."""
    from ..render.integrator import BINNED_BLOCK

    unit = BINNED_BLOCK if n >= BINNED_BLOCK * size else 1
    units, tail = divmod(n, unit)
    base, rem = divmod(units, size)
    sizes = [(base + (i < rem)) * unit for i in range(size)]
    sizes[-1] += tail
    return sizes


def shard_rays(arr: torch.Tensor, mesh: Mesh) -> list:
    """Contiguous shards of a per-ray tensor over axis 0 (shard_sizes),
    one a device in mesh order, each on its device."""
    sizes = shard_sizes(arr.shape[0], mesh.size)
    return [part.to(device) for part, device
            in zip(torch.split(arr, sizes), mesh.devices)]


def render_tiles_sharded(render_fn, mesh: Mesh, scene, env, vol, flags, uniforms,
                         px, py, frame_index):
    """Run a render_batch-style function (the port's calling convention:
    render_fn(scene, flags, u, px, py, frame_index, env=, vol=)) with the
    rays sharded over the mesh, each shard against its device's copies.
    Returns the colours in ray order on the mesh's first device."""
    shards = zip(replicate_scene(scene, mesh), replicate_scene(env, mesh),
                 replicate_scene(vol, mesh), replicate_scene(uniforms, mesh),
                 shard_rays(px, mesh), shard_rays(py, mesh))
    colors = [render_fn(s, flags, u, x, y, frame_index, env=e, vol=v)
              for s, e, v, u, x, y in shards]
    return torch.cat([c.to(mesh.devices[0]) for c in colors])


def spp_split(spp: int, size: int) -> list:
    """(first global sample, count) of each shard: exactly spp samples in
    all, the first (spp % size) shards taking one more."""
    base, rem = divmod(spp, size)
    return [(i * base + min(i, rem), base + (i < rem)) for i in range(size)]


def render_spp_sharded(mesh: Mesh, scene, env, vol, flags, uniforms, px, py,
                       frame_index):
    """Samples sharded over the mesh: each shard traces every pixel for
    its own global sample indices (spp_split), so that the camera rays'
    seeds, which hash the sample index, are the single-device frame's.
    Every shard's samples are issued before any is read back; a shard
    whose binned buffer overflowed has its samples redone through the
    permuted transport. The partial sums are added on the mesh's first
    device in shard order (the JAX package's psum), then divided by spp
    and multiplied by the exposure. Returns colour f32[B,3] there."""
    from ..render.integrator import _sample_radiance

    def samples(scene_d, env_d, vol_d, u_d, x, y, first, count, binned):
        total = V.full(x.shape, 0.0, device=x.device)
        overflow = torch.zeros((), dtype=torch.int64, device=x.device)
        for s in range(first, first + count):
            radiance, _, over = _sample_radiance(scene_d, flags, u_d, x, y, frame_index, s,
                                                 env=env_d, binned=binned, vol=vol_d)
            total = V.add(total, radiance)
            overflow = overflow + over
        return total, overflow

    shards = list(zip(replicate_scene(scene, mesh), replicate_scene(env, mesh),
                      replicate_scene(vol, mesh), replicate_scene(uniforms, mesh),
                      [px.to(d) for d in mesh.devices], [py.to(d) for d in mesh.devices],
                      spp_split(flags.spp, mesh.size)))
    partials = [samples(*shard[:6], *shard[6], True) for shard in shards]
    first = mesh.devices[0]
    total = V.full(px.shape, 0.0, device=first)
    for shard, (part, overflow) in zip(shards, partials):
        if int(overflow):
            part, _ = samples(*shard[:6], *shard[6], False)
        total = V.add(total, tuple(c.to(first) for c in part))
    u = replicate_scene(uniforms, mesh)[0]
    return V.to_array(total) / flags.spp * u.exposure
