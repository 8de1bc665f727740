"""Progressive frame rendering and accumulation.

Counterpart of webgl_raytracer_tpu/render/frame.py for the path-traced
mode. Each frame traces spp new samples per pixel and folds them into a
running fp32 mean (prev*N + x)/(N+1); a camera or settings change resets
N to 0 through reset_accumulation().
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.tonemap import apply_tonemap
from ..scene.camera import OrbitCamera
from ..scene.compile import SceneBuffers, scene_bounds, scene_scale
from .config import RenderSettings, split_settings
from .integrator import render_batch
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


class Renderer:
    """Owns the scene and environment on its device, the settings, the
    camera and the progressive accumulator.

    device: None means cuda:0 (raises without a GPU); "cpu" renders with
    the plain traces. env: EnvBuffers (env/) or None for ambient light only.
    impl: None (kernels on CUDA tensors, plain versions on CPU ones) or
    "plain" to force the plain traces on a CUDA device (comparison runs).
    """

    def __init__(self, scene: SceneBuffers, settings: RenderSettings | None = None,
                 env=None, width: int = 800, height: int = 600, device=None,
                 impl: str | None = None, auto_fit: bool = True):
        self.settings = settings or RenderSettings()
        self.device = resolve_device(device)
        self.scene = scene if scene.device == self.device else scene.to(self.device)
        self.env = None
        self.set_env(env)
        self.impl = impl
        self.width = int(width)
        self.height = int(height)
        self.camera = OrbitCamera(width=self.width, height=self.height)
        self.frame_index = 0
        self._accum = None
        self._px = None
        self._py = None
        self._unperm = None

        self.bounds = scene_bounds(self.scene)
        self.scene_scale = scene_scale(self.scene)
        # Scale-derived ray bias.
        suggested = max(1e-5, self.scene_scale * 1e-5)
        self.settings.ray_bias = suggested
        self.settings.t_min = suggested
        if auto_fit:
            self.camera.fit_to_bounds(*self.bounds)

    def reset_accumulation(self) -> None:
        self.frame_index = 0

    def set_env(self, env) -> None:
        """Swap the environment (EnvBuffers or None) and restart
        accumulation."""
        if env is not None and env.device != self.device:
            env = env.to(self.device)
        self.env = env
        self.reset_accumulation()

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
        """(flags, uniforms, px, py) for the next frame."""
        s = self.settings
        basis = self.camera.basis()
        light_dirs = light_dirs_for_camera(s.lights, basis)
        clip = self.active_clip_plane(basis)
        flags, uniforms = split_settings(s, basis, light_dirs,
                                         has_env=self.env is not None, clip=clip,
                                         device=self.device)
        px, py = self._pixel_grids()
        return flags, uniforms, px, py

    def active_clip_plane(self, basis):
        """Camera-forward clip plane: None or (normal, offset, side)."""
        s = self.settings
        if not s.clip_enabled:
            return None
        normal = np.asarray(basis.forward, np.float64)
        normal = normal / (np.linalg.norm(normal) or 1.0)
        plane_point = np.asarray(basis.origin) + normal * s.clip_distance
        offset = float(normal @ plane_point)
        cam_side = float(normal @ np.asarray(basis.origin)) - offset
        side = 1.0 if cam_side >= 0 else -1.0
        return (normal.astype(np.float32), offset, side)

    def render_frame(self) -> bool:
        """Trace one progressive frame into the accumulator. Returns False
        when max_frames has been reached (accumulation is kept)."""
        s = self.settings
        if s.max_frames > 0 and self.frame_index >= s.max_frames:
            return False
        flags, uniforms, px, py = self.frame_inputs()
        color = render_batch(self.scene, flags, uniforms, px, py,
                             self.frame_index, env=self.env, impl=self.impl)
        if self._accum is None or self.frame_index == 0:
            self._accum = color
        else:
            # In place: the running mean never needs a second [B,3] buffer.
            # The divisor is a device tensor: a Python-scalar divisor would
            # turn into a multiply by its reciprocal on CUDA.
            fi = float(self.frame_index)
            denom = torch.tensor(fi + 1.0, dtype=torch.float32, device=self.device)
            self._accum.mul_(fi).add_(color).div_(denom)
        self.frame_index += 1
        return True

    def render_frames(self, count: int) -> bool:
        """Trace `count` progressive frames. Returns False when max_frames
        was already reached."""
        s = self.settings
        if s.max_frames > 0:
            count = min(count, max(0, s.max_frames - self.frame_index))
        if count <= 0:
            return False
        for _ in range(count):
            self.render_frame()
        return True

    def render(self, frames: int | None = None) -> np.ndarray:
        """Render `frames` progressive frames (default settings.max_frames)
        and return the tone-mapped u8[H,W,3] image."""
        n = frames if frames is not None else max(1, self.settings.max_frames)
        self.render_frames(n)
        return self.image_u8()

    def accumulated(self) -> np.ndarray:
        """Linear accumulated radiance f32[H,W,3] (top row first)."""
        if self._accum is None:
            return np.zeros((self.height, self.width, 3), np.float32)
        flat = self._accum[self._unperm]      # ray order -> image order
        return flat.cpu().numpy().reshape(self.height, self.width, 3)

    def image(self) -> np.ndarray:
        """Tone-mapped display image f32[H,W,3] in [0,1]."""
        linear = torch.as_tensor(self.accumulated())
        return apply_tonemap(linear, self.settings.tone_map).numpy()

    def image_u8(self) -> np.ndarray:
        return (np.clip(self.image(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
