"""Progressive frame rendering and accumulation.

Counterpart of webgl_raytracer_tpu/render/frame.py for the path-traced
mode. Each frame traces spp new samples per pixel and folds them into a
running fp32 mean (prev*N + x)/(N+1); a camera or settings change resets
N to 0 through reset_accumulation().

How frames run. One frame (_frame: camera rays, the transport, the
running mean, the frame index and the block's overflow and ray totals) is
device work on tensors the Renderer owns, with no host read on the
kernels' path. On the card with the kernels (impl=None) it is captured
once as a CUDA graph, the counterpart of the JAX package's
_render_frames_fused (a lax.scan that runs `count` frames as one XLA
program): render_frames(count) replays the graph `count` times and then
reads the block's totals back once. On CPU tensors, and with
impl="plain", the same frame function runs eagerly: the plain traces read
the host and are never captured. A failed capture or replay raises.

A frame whose binned buffer overflowed (integrator._binned_transport)
counts in the block's totals; the block is then redone frame by frame
through integrator.render_batch_stats, which takes the permuted transport,
from the accumulator as it stood at the block's start: the port's form of
the JAX package's lax.cond fallback, with the same frames.

The graph bakes in what the frame reads on the host while it is traced:
the StaticFlags, the size, the scene, environment and volume, impl and the
transport knobs (integrator.TRANSPORT_KNOBS); a change of any of them
recaptures. The uniforms are one device buffer (config.uniforms_view)
refreshed in place, so a camera move or a uniform setting needs none.

With the recorder on (utils/telemetry.py) each render_frames call is a
row of it: the host spans frame.setup, frame.launch, frame.wait,
frame.redo and frame.capture, and the device spans of its frames, which
_frame marks and a capture records into the graph (a capture key of its
own), so that every replay times itself; they are read when the call
returns, after the block's host read. While it is off none of it runs and
the captured frame is the one without it.

Visualisation modes (settings.vis_mode 1-3) render eagerly, one frame at
a time with no capture, as the JAX package does: the view
(integrator.render_visualization) replaces the accumulator, frame_index
becomes 1, and image() shows it through the linear tone map. A vis frame
releases the held capture, so the next path-traced frame captures anew.

With a mesh (parallel/mesh.py, Renderer(mesh=...)) the frame is split by
rays: one shard a mesh device, each a single-device Renderer on its
contiguous part of the Morton-ordered rays (parallel/mesh.shard_sizes:
whole blocks of the binned transport where the frame has one a shard,
so that the shards take the single-device frame's transport), with its
own copies of the scene, environment and volume, its own accumulator,
uniforms, frame counter and totals, and its own captured frame, and with
this Renderer's settings, camera and stats. render_frames captures where
needed on every shard first, then issues every shard's replays, then
reads each shard's totals; a shard whose binned buffer overflowed redoes
its block alone. Readout gathers the shards' accumulators in ray order
onto the first device. The counterpart of the JAX package's shard_map
tile path, which needs the ray count to divide by the mesh size; here
shards may differ in size, so one path serves every size.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kernels import launches
from ..ops.tonemap import apply_tonemap
from ..parallel.mesh import replicate_scene, shard_rays
from ..scene.camera import OrbitCamera
from ..scene.compile import SceneBuffers, scene_bounds, scene_scale
from ..utils import telemetry
from .config import (UNIFORM_SIZE, RenderSettings, split_settings, static_flags,
                     uniform_values, uniforms_view)
from .integrator import (TRANSPORT_KNOBS, render_batch_flagged, render_batch_stats,
                         render_visualization)
from .lights import light_dirs_for_camera


def morton_pixel_order(width: int, height: int):
    """Ray order of the pixels: 16x16 screen tiles along a Morton curve,
    row-major inside a tile. Returns (xs, ys_image, inverse) as numpy:
    x and top-down image row of each ray, and for each row-major image
    pixel its ray index."""
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    tile_y = yy // 16
    tile_x = xx // 16

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    morton = spread(tile_x) | (spread(tile_y) << np.uint64(1))
    order = np.lexsort((xx.ravel(), yy.ravel() % 16, morton.ravel()))
    inverse = np.empty(width * height, np.int64)
    inverse[order] = np.arange(width * height)
    return xx.ravel()[order], yy.ravel()[order], inverse


def running_mean(accum, color, frame_index) -> None:
    """accum <- color at frame 0, else (accum*N + color)/(N + 1), in place;
    frame_index N is a 0-d integer tensor on accum's device. The divisor is
    a tensor: a Python-scalar divisor would turn into a multiply by its
    reciprocal on CUDA."""
    fi = frame_index.to(torch.float32)
    torch.where(frame_index == 0, color, (accum * fi + color) / (fi + 1.0), out=accum)


_NULL = contextlib.nullcontext()


def _host(name: str):
    """The recorder's host span `name` (utils/telemetry.py), or a no-op
    while it is off."""
    rec = telemetry.recorder
    return _NULL if rec is None else rec.host(name)


def _eager(device):
    """The recorder's device spans of one eager frame on `device`, or a
    no-op while it is off."""
    rec = telemetry.recorder
    return _NULL if rec is None else rec.eager_frame(device)


@dataclass
class _Captured:
    """A captured frame and what it was captured for."""
    graph: torch.cuda.CUDAGraph
    key: tuple
    held: tuple          # the scene, env and volume the key names by id, kept alive
    launches: dict       # kernel launches one replay makes, by name
    plan: object = None  # its device spans, captured with the recorder on


class Renderer:
    """Owns the scene and environment on its device, the settings, the
    camera, the progressive accumulator and the captured frame.

    device: None means cuda:0 (raises without a GPU); "cpu" renders with
    the plain traces. env: EnvBuffers (env/) or None for ambient light only.
    volume: VolumeBuffers (models/density.DensityVolume.to_device_buffers)
    or None; settings.volume_enabled turns its march on.
    impl: None (kernels on CUDA tensors, plain versions on CPU ones) or
    "plain" to force the plain traces on a CUDA device (comparison runs,
    eager). mesh: a parallel.Mesh to split every frame's rays over its
    devices (the module docstring); device is then the mesh's first.

    stats counts captures, blocks whose binned buffer overflowed and the
    frames redone for them; ray_counts holds the (path, occlusion) rays of
    the frames accumulated since the last reset.
    """

    def __init__(self, scene: SceneBuffers, settings: RenderSettings | None = None,
                 env=None, volume=None, width: int = 800, height: int = 600,
                 device=None, impl: str | None = None, auto_fit: bool = True,
                 mesh=None):
        self.settings = settings or RenderSettings()
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.impl = impl
        self.width = int(width)
        self.height = int(height)
        self.base_width = self.width
        self.base_height = self.height
        self.scale = 1.0
        self.camera = OrbitCamera(width=self.width, height=self.height)
        self.stats = {"captures": 0, "overflowed_blocks": 0, "redone_frames": 0}
        self._init_frame_state()
        self.env = None
        self.set_env(env)
        self.set_scene(scene, volume=volume, auto_fit=auto_fit)

    def _init_frame_state(self) -> None:
        self.frame_index = 0
        self.ray_counts = (0, 0)
        self._graph = None
        self._capture_stream = None
        self._accum = None
        self._px = self._py = self._unperm = None
        self._u = self._uflat = self._uhost = None
        self._fi = None          # int64 0-d: the next frame's index, on the device
        self._totals = None      # int64[3]: the block's overflows, path and occlusion rays
        self._shards = None      # a mesh's shards, made on first use (_mesh_shards)

    # -- state management ---------------------------------------------------

    def reset_accumulation(self) -> None:
        self.frame_index = 0
        self.ray_counts = (0, 0)

    def set_env(self, env) -> None:
        """Swap the environment (EnvBuffers or None) and restart
        accumulation."""
        if self.mesh is not None:
            self._envs = replicate_scene(env, self.mesh)
            env = self._envs[0]
            for shard, copy in zip(self._shards or (), self._envs):
                shard.env = copy
        if env is not None and env.device != self.device:
            env = env.to(self.device)
        self.env = env
        self._release_graph()
        self.reset_accumulation()

    def set_scene(self, scene: SceneBuffers, volume=None, auto_fit: bool = True) -> None:
        """Swap the compiled scene and its volume (VolumeBuffers or None):
        bounds, scene scale, ray bias and the camera fit are recomputed;
        accumulation restarts."""
        if self.mesh is not None:
            self._scenes = replicate_scene(scene, self.mesh)
            self._volumes = replicate_scene(volume, self.mesh)
            scene, volume = self._scenes[0], self._volumes[0]
            for shard, copy, vol in zip(self._shards or (), self._scenes, self._volumes):
                shard.scene, shard.volume = copy, vol
        self.scene = scene if scene.device == self.device else scene.to(self.device)
        if volume is not None and volume.device != self.device:
            volume = volume.to(self.device)
        self.volume = volume
        self.bounds = scene_bounds(self.scene)
        self.scene_scale = scene_scale(self.scene)
        # Scale-derived ray bias.
        suggested = max(1e-5, self.scene_scale * 1e-5)
        self.settings.ray_bias = suggested
        self.settings.t_min = suggested
        if auto_fit:
            self.camera.fit_to_bounds(*self.bounds)
        self._release_graph()
        self.reset_accumulation()

    def resize(self, width: int, height: int) -> None:
        if width != self.width or height != self.height:
            self.width, self.height = int(width), int(height)
            self._release_graph()        # it reads the old size's buffers
            self._accum = None
            self._px = self._py = self._unperm = None
            self._shards = None
            self.reset_accumulation()
        self.camera.width, self.camera.height = self.width, self.height

    def set_scale(self, scale: float) -> None:
        """Internal render-resolution scale: the path tracer renders at
        base x scale, dimensions snapped to 16-pixel tiles; accumulation
        resets on a change."""
        scale = float(min(2.0, max(0.05, scale)))
        w = max(16, int(round(self.base_width * scale / 16.0)) * 16)
        h = max(16, int(round(self.base_height * scale / 16.0)) * 16)
        self.scale = scale
        self.resize(w, h)

    def _pixel_grids(self):
        """Flat pixel index tensors in Morton-ordered 16x16 tiles (y = 0 is
        the bottom row, the gl_FragCoord convention)."""
        if self._px is None:
            xs, ys_img, inverse = morton_pixel_order(self.width, self.height)
            self._px = torch.as_tensor(xs.astype(np.int64), device=self.device)
            self._py = torch.as_tensor((self.height - 1 - ys_img).astype(np.int64),
                                       device=self.device)
            self._unperm = torch.as_tensor(inverse, device=self.device)
        return self._px, self._py

    def frame_inputs(self):
        """(flags, uniforms, px, py) for the next frame; the uniforms are
        tensors of their own, not the Renderer's buffer."""
        s = self.settings
        basis = self.camera.basis()
        flags, uniforms = split_settings(s, basis, light_dirs_for_camera(s.lights, basis),
                                         has_env=self.env is not None,
                                         has_volume=self.volume is not None,
                                         clip=self.active_clip_plane(basis),
                                         device=self.device)
        px, py = self._pixel_grids()
        return flags, uniforms, px, py

    def active_clip_plane(self, basis):
        """Camera-forward clip plane, or the locked one
        (lock_clip_plane): None or (normal, offset, side)."""
        s = self.settings
        if not s.clip_enabled:
            return None
        if s.clip_locked and s.clip_locked_normal is not None:
            normal = np.asarray(s.clip_locked_normal, np.float64)
        else:
            normal = np.asarray(basis.forward, np.float64)
        normal = normal / (np.linalg.norm(normal) or 1.0)
        if s.clip_locked and s.clip_locked_offset is not None:
            offset = float(s.clip_locked_offset)
        else:
            plane_point = np.asarray(basis.origin) + normal * s.clip_distance
            offset = float(normal @ plane_point)
        if s.clip_locked and s.clip_locked_side is not None:
            side = float(s.clip_locked_side)
        else:
            cam_side = float(normal @ np.asarray(basis.origin)) - offset
            side = 1.0 if cam_side >= 0 else -1.0
        return (normal.astype(np.float32), offset, side)

    def lock_clip_plane(self) -> None:
        """Freeze the current camera-derived clip plane in world space."""
        plane = self.active_clip_plane(self.camera.basis())
        if plane is None:
            return
        normal, offset, side = plane
        self.settings.clip_locked = True
        self.settings.clip_locked_normal = tuple(float(v) for v in normal)
        self.settings.clip_locked_offset = offset
        self.settings.clip_locked_side = side

    def unlock_clip_plane(self) -> None:
        self.settings.clip_locked = False
        self.settings.clip_locked_normal = None
        self.settings.clip_locked_offset = None
        self.settings.clip_locked_side = None

    # -- rendering ----------------------------------------------------------

    def _frame_setup(self):
        """The next frames' flags. Refreshes the device uniforms where they
        changed (one copy) and allocates the frame's buffers."""
        s = self.settings
        basis = self.camera.basis()
        clip = self.active_clip_plane(basis)
        flags = static_flags(s, has_env=self.env is not None,
                             has_volume=self.volume is not None, clip=clip)
        values = uniform_values(s, basis, light_dirs_for_camera(s.lights, basis), clip)
        if self._uflat is None:
            self._uflat = torch.empty(UNIFORM_SIZE, dtype=torch.float32, device=self.device)
            self._u = uniforms_view(self._uflat)
            self._fi = torch.zeros((), dtype=torch.int64, device=self.device)
            self._totals = torch.zeros(3, dtype=torch.int64, device=self.device)
        if self._uhost is None or not np.array_equal(values, self._uhost):
            self._uflat.copy_(torch.from_numpy(values))
            self._uhost = values
        self._accumulator()
        return flags

    def _accumulator(self) -> torch.Tensor:
        """The accumulator, allocated (zeros) on first use."""
        if self._accum is None:
            px, _ = self._pixel_grids()
            self._accum = torch.zeros((px.shape[0], 3), dtype=torch.float32,
                                      device=self.device)
        return self._accum

    def _frame(self, flags):
        """One progressive frame into the accumulator at the device frame
        index, which it advances; the frame's overflow flag and ray counts
        add to the block's totals. No host read on the kernels' path.
        Returns the frame's device spans with the recorder on (captured
        with the frame where it is captured), else None."""
        rec = telemetry.recorder
        if rec is not None:
            rec.begin_frame(self.device)
        color, rays, overflow = render_batch_flagged(
            self.scene, flags, self._u, self._px, self._py, self._fi, env=self.env,
            impl=self.impl, vol=self.volume)
        running_mean(self._accum, color, self._fi)
        self._totals.add_(torch.stack([overflow, rays[0], rays[1]]))
        self._fi.add_(1)
        return None if rec is None else rec.end_frame()

    def _release_graph(self) -> None:
        if self._graph is not None:
            self._graph.graph.reset()
            self._graph = None
        for shard in self._shards or ():
            shard._release_graph()

    def _capture_key(self, flags) -> tuple:
        """What a captured frame bakes in; with the recorder on, also its
        device spans."""
        key = (flags, self.width, self.height, id(self.scene), id(self.env),
               id(self.volume), self.impl, tuple(os.environ.get(k) for k in TRANSPORT_KNOBS))
        return key if telemetry.recorder is None else key + ("telemetry",)

    def _captured(self, flags) -> _Captured:
        """The captured frame for these flags and the current scene, env,
        volume, size, impl and transport knobs: the one held, or a new capture.
        A new capture first runs the frame once on a side stream (it builds
        the kernels and the scene's operands, which capture cannot), then
        restores the accumulator and records one frame on this Renderer's
        own capture stream; the launch counters keep the warm-up's launches
        and learn the replay's. All of it runs with the Renderer's device
        current, whatever device the caller's is."""
        key = self._capture_key(flags)
        if self._graph is not None and self._graph.key == key:
            return self._graph
        self._release_graph()
        with _host("frame.capture"), torch.cuda.device(self.device):
            saved = self._accum.clone()
            self._fi.fill_(self.frame_index)
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._frame(flags)
            main.wait_stream(side)
            self._accum.copy_(saved)
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            graph = torch.cuda.CUDAGraph()
            before = dict(launches)
            with torch.cuda.graph(graph, stream=self._capture_stream):
                plan = self._frame(flags)
        per_replay = {name: launches[name] - n for name, n in before.items()}
        launches.update(before)
        self.stats["captures"] += 1
        self._graph = _Captured(graph, key, (self.scene, self.env, self.volume), per_replay,
                                plan)
        return self._graph

    def render_frames(self, count: int) -> bool:
        """Trace `count` progressive frames: on the card, `count` replays of
        the captured frame and one host read of the block's totals.
        Returns False when max_frames was already reached. With the
        recorder on (utils/telemetry.py) the call is one row of it."""
        s = self.settings
        if s.max_frames > 0:
            count = min(count, max(0, s.max_frames - self.frame_index))
        if count <= 0:
            return False
        rec = telemetry.recorder
        if rec is None:
            self._render_block(count)
        else:
            with rec.call(self, count):
                self._render_block(count)
        return True

    def _render_block(self, count: int) -> None:
        if self.mesh is not None:
            self._render_mesh(count)
            return
        with _host("frame.setup"):
            flags = self._frame_setup()
        if flags.vis_mode > 0:
            for _ in range(count):
                self._vis_frame(flags)
            return
        self._finish_block(flags, self._start_block(flags, count, self._block_graph(flags)))

    def _block_graph(self, flags):
        """The captured frame a block replays (_captured), or None where
        frames run eagerly: on the CPU and with impl="plain"."""
        if self.device.type == "cuda" and self.impl is None:
            return self._captured(flags)
        return None

    def _start_block(self, flags, count, captured):
        """Issue `count` frames from frame_index: replays of `captured`, or
        eager frames where it is None. No host read on the card. Returns
        the block (start, count, accumulator at the start) for
        _finish_block. Its frames' device spans are read when the call
        returns (recorder on)."""
        rec = telemetry.recorder
        with _host("frame.launch"):
            start = self.frame_index
            saved = self._accum.clone() if start > 0 else None
            self._fi.fill_(start)
            self._totals.zero_()
            if captured is None:
                plans = [self._frame(flags) for _ in range(count)]
            else:
                with torch.cuda.device(self.device):
                    for _ in range(count):
                        captured.graph.replay()
                for name, n in captured.launches.items():
                    launches[name] += n * count
                plans = [captured.plan]
        if rec is not None:
            for plan in plans:
                rec.timed(plan)
        return start, count, saved

    def _finish_block(self, flags, block) -> tuple:
        """Read the block's totals (one host read), redo the block where
        its binned buffer overflowed, and advance frame_index and
        ray_counts. Returns the block's (path, occlusion) rays."""
        start, count, saved = block
        with _host("frame.wait"):
            overflowed, paths, occl = self._totals.tolist()
        if overflowed:
            with _host("frame.redo"):
                paths, occl = self._redo(flags, start, count, saved)
        self.frame_index = start + count
        self.ray_counts = (self.ray_counts[0] + paths, self.ray_counts[1] + occl)
        return paths, occl

    def _mesh_shards(self) -> list:
        """The mesh's shards (module docstring), made on first use after
        a resize: each a _Shard on its device's part of the rays."""
        if self._shards is None:
            px, py = self._pixel_grids()
            self._shards = [
                _Shard(self, *parts) for parts in zip(
                    self.mesh.devices, shard_rays(px, self.mesh), shard_rays(py, self.mesh),
                    self._scenes, self._envs, self._volumes)]
        return self._shards

    def _render_mesh(self, count: int) -> None:
        """`count` frames on every shard: the captures first, then every
        shard's replays (the cards run together), then each shard's
        totals; vis frames shard by shard, eagerly."""
        shards = self._mesh_shards()
        for shard in shards:
            shard.frame_index = self.frame_index
        flags = [shard._frame_setup() for shard in shards]
        if flags[0].vis_mode > 0:
            for shard, f in zip(shards, flags):
                for _ in range(count):
                    shard._vis_frame(f)
            self.frame_index = 1
            return
        graphs = [shard._block_graph(f) for shard, f in zip(shards, flags)]
        blocks = [shard._start_block(f, count, g) for shard, f, g in zip(shards, flags, graphs)]
        rays = [shard._finish_block(f, b) for shard, f, b in zip(shards, flags, blocks)]
        self.frame_index += count
        self.ray_counts = (self.ray_counts[0] + sum(p for p, _ in rays),
                           self.ray_counts[1] + sum(o for _, o in rays))

    def _vis_frame(self, flags) -> None:
        """One visualisation frame: the view written over the accumulator
        in place (a held capture reads that tensor), frame_index 1."""
        self._release_graph()
        with _eager(self.device):
            color = render_visualization(self.scene, flags, self._u, self._px, self._py,
                                         self.frame_index, env=self.env, impl=self.impl,
                                         vol=self.volume)
            self._accum.copy_(color)
        self.frame_index = 1

    def _redo(self, flags, start, count, saved):
        """Redo frames [start, start + count) eagerly through
        render_batch_stats (the permuted transport where the binned buffer
        overflows) from the accumulator `saved` at the block's start.
        Returns their (path, occlusion) rays."""
        if saved is not None:
            self._accum.copy_(saved)
        paths = occl = 0
        for f in range(start, start + count):
            self._fi.fill_(f)
            with _eager(self.device):
                color, (p, o) = render_batch_stats(self.scene, flags, self._u, self._px,
                                                   self._py, f, env=self.env,
                                                   impl=self.impl, vol=self.volume)
                running_mean(self._accum, color, self._fi)
            paths, occl = paths + int(p), occl + int(o)
        self.stats["overflowed_blocks"] += 1
        self.stats["redone_frames"] += count
        return paths, occl

    def render_frame(self) -> bool:
        """Trace one progressive frame into the accumulator. Returns False
        when max_frames has been reached (accumulation is kept)."""
        return self.render_frames(1)

    def render(self, frames: int | None = None) -> np.ndarray:
        """Render `frames` progressive frames (default settings.max_frames)
        and return the tone-mapped u8[H,W,3] image."""
        n = frames if frames is not None else max(1, self.settings.max_frames)
        self.render_frames(n)
        return self.image_u8()

    # -- output -------------------------------------------------------------

    def _ray_accum(self):
        """The accumulator in ray order on the Renderer's device, None
        before any frame: on a mesh, the shards' accumulators copied onto
        the first device in shard order (the readout's one gather)."""
        if self.mesh is None:
            return self._accum
        if self._shards is None or self._shards[0]._accum is None:
            return None
        return torch.cat([shard._accum.to(self.device) for shard in self._shards])

    def accumulated(self) -> np.ndarray:
        """Linear accumulated radiance f32[H,W,3] (top row first)."""
        accum = self._ray_accum()
        if accum is None:
            return np.zeros((self.height, self.width, 3), np.float32)
        flat = accum[self._unperm]      # ray order -> image order
        return flat.cpu().numpy().reshape(self.height, self.width, 3)

    def image(self) -> np.ndarray:
        """Tone-mapped display image f32[H,W,3] in [0,1]; the linear map in
        visualisation modes."""
        linear = torch.as_tensor(self.accumulated())
        mode = self.settings.tone_map if self.settings.vis_mode == 0 else "linear"
        return apply_tonemap(linear, mode).numpy()

    def image_u8(self) -> np.ndarray:
        return (np.clip(self.image(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    # -- checkpoint / resume --------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Write the accumulator (ray order), its frame count and the
        camera to an .npz with the JAX package's keys, so that either
        package loads the other's checkpoint."""
        accum = self._ray_accum()
        accum = (accum.cpu().numpy() if accum is not None
                 else np.zeros((self.width * self.height, 3), np.float32))
        np.savez_compressed(
            path, accum=accum, frame_index=self.frame_index, width=self.width,
            height=self.height, cam_target=np.asarray(self.camera.target, np.float64),
            cam_distance=self.camera.distance,
            cam_rotation=np.asarray(self.camera.rotation, np.float64),
            cam_fov=self.camera.fov)

    def load_checkpoint(self, path: str) -> None:
        """Resume accumulation from a checkpoint of the same resolution
        (raises ValueError otherwise)."""
        with np.load(path) as data:
            w, h = int(data["width"]), int(data["height"])
            if (w, h) != (self.width, self.height):
                raise ValueError(f"Checkpoint resolution {w}x{h} != renderer "
                                 f"{self.width}x{self.height}")
            accum = torch.from_numpy(np.asarray(data["accum"], np.float32))
            if self.mesh is None:
                self._accumulator().copy_(accum)
            else:
                start = 0
                for shard in self._mesh_shards():
                    part = shard._accumulator()
                    part.copy_(accum[start:start + part.shape[0]])
                    start += part.shape[0]
            self.frame_index = int(data["frame_index"])
            self.camera.target = data["cam_target"]
            self.camera.distance = float(data["cam_distance"])
            self.camera.rotation = data["cam_rotation"]
            self.camera.fov = float(data["cam_fov"])


class _Shard(Renderer):
    """One device's part of a mesh Renderer: the single-device frame loop
    on rays px, py (a contiguous part of the parent's ray order), with
    the parent's settings, camera and stats, and its own copies of the
    scene, environment and volume."""

    def __init__(self, parent: Renderer, device, px, py, scene, env, volume):
        self.settings, self.camera, self.stats = parent.settings, parent.camera, parent.stats
        self.mesh, self.device, self.impl = None, device, parent.impl
        self.width, self.height = parent.width, parent.height
        self.scene, self.env, self.volume = scene, env, volume
        self._init_frame_state()
        self._px, self._py = px, py
