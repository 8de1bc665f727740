"""Render configuration; counterpart of webgl_raytracer_tpu/render/config.py.

`RenderSettings` is the user-facing flag registry. For the integrator it
splits into
  * StaticFlags — hashable structural switches that select code paths
    (material mode, feature toggles, bounce/spp counts), read on the host;
  * Uniforms    — per-frame scalars/vectors as f32 tensors on the device,
    views of one flat f32 buffer (UNIFORM_SHAPES gives its layout), so
    that a frame's uniforms reach the card in one copy, and a Renderer
    refreshes its captured frame's uniforms in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from ..device import resolve_device

MATERIAL_MODES = {"metallic": 0, "matte": 1, "surface-glass": 2, "translucent-plastic": 3}
TONE_MAPS = ("linear", "aces", "reinhard")


@dataclass
class LightSettings:
    """One camera-relative cone light."""
    enabled: bool = True
    azimuth: float = 0.0
    elevation: float = 0.0
    intensity: float = 1.0
    angle: float = 20.0          # cone half-angle in degrees
    color: tuple[float, float, float] = (1.0, 1.0, 1.0)


def default_lights() -> list[LightSettings]:
    """Key / fill / rim studio defaults."""
    return [
        LightSettings(True, -40.0, -30.0, 5.0, 22.0, (1.0, 1.0, 1.0)),
        LightSettings(True, 40.0, 0.0, 0.6, 50.0, (1.0, 1.0, 1.0)),
        LightSettings(True, 170.0, 10.0, 0.35, 6.0, (1.0, 1.0, 1.0)),
    ]


@dataclass
class RenderSettings:
    """Full render state, with the JAX package's defaults."""
    render_scale: float = 1.0
    fast_scale: float = 0.25        # the viewer's preview scale while interacting
    use_bvh: bool = True
    use_imported_color: bool = True
    base_color: tuple[float, float, float] = (0.8, 0.8, 0.8)
    material_mode: str = "metallic"
    metallic: float = 0.0
    roughness: float = 0.4
    rim_boost: float = 0.2
    matte_specular: float = 0.03
    matte_roughness: float = 0.5
    matte_diffuse_roughness: float = 0.5
    wrap_diffuse: float = 0.2
    surface_ior: float = 1.33
    surface_transmission: float = 0.35
    surface_opacity: float = 0.0
    surface_flag_mode: int = 0
    max_bounces: int = 4
    max_frames: int = 100
    exposure: float = 1.0
    dof_enabled: bool = False
    dof_aperture: float = 0.03
    dof_focus_distance: float = 4.0
    tone_map: str = "aces"
    ambient_intensity: float = 0.0
    ambient_color: tuple[float, float, float] = (1.0, 1.0, 1.0)
    env_intensity: float = 0.1
    env_max_luminance: float = 200.0
    ray_bias: float = 1e-5
    t_min: float = 1e-5
    samples_per_bounce: int = 1     # spp per progressive frame, clamped 1..8
    cast_shadows: bool = True
    volume_enabled: bool = False
    volume_color: tuple[float, float, float] = (0.435, 0.643, 1.0)
    volume_density: float = 1.0
    volume_opacity: float = 1.0
    volume_step: float = 0.5
    volume_max_steps: int = 256
    volume_threshold: float = 0.0
    lights: list[LightSettings] = field(default_factory=default_lights)
    clip_enabled: bool = False
    clip_distance: float = 0.0
    clip_locked: bool = False
    clip_locked_normal: tuple | None = None
    clip_locked_offset: float | None = None
    clip_locked_side: float | None = None
    vis_mode: int = 0               # 0 render, 1 normals, 2 cost, 3 depth
    tracer: str = "wavefront"


def apply_material_preset(settings: RenderSettings, mode: str) -> bool:
    """Material-mode preset: selecting translucent-plastic loads its
    dielectric defaults; other modes leave the sliders untouched. Returns
    True when a preset was applied."""
    if mode != "translucent-plastic":
        return False
    settings.metallic = 0.0
    settings.roughness = 0.22
    settings.rim_boost = 0.0
    settings.surface_ior = 1.46
    settings.surface_transmission = 0.55
    settings.surface_opacity = 0.15
    return True


def clip_distance_max(scene_scale: float) -> float:
    """Clip-plane distance range from the scene scale: max(1, scale * 4)."""
    return max(1.0, float(scene_scale) * 4.0)


@dataclass(frozen=True)
class StaticFlags:
    """Code-path switches (hashable)."""
    material_mode: int = 0
    use_imported_color: bool = True
    use_env: bool = False
    volume_enabled: bool = False
    volume_max_steps: int = 0
    dof_enabled: bool = False
    clip_enabled: bool = False
    cast_shadows: bool = True
    max_bounces: int = 4
    spp: int = 1
    surface_flag_mode: int = 0
    light_enabled: tuple[bool, bool, bool] = (True, True, True)
    vis_mode: int = 0
    rim_enabled: bool = True
    tracer: str = "wavefront"
    use_bvh: bool = True


@dataclass
class Uniforms:
    """Per-frame values as f32 tensors on one device."""
    base_color: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    rim_boost: torch.Tensor
    matte_specular: torch.Tensor
    matte_roughness: torch.Tensor
    matte_diffuse_roughness: torch.Tensor
    wrap_diffuse: torch.Tensor
    surface_ior: torch.Tensor
    surface_transmission: torch.Tensor
    surface_opacity: torch.Tensor
    exposure: torch.Tensor
    dof_aperture: torch.Tensor
    dof_focus_distance: torch.Tensor
    ambient_intensity: torch.Tensor
    ambient_color: torch.Tensor
    env_intensity: torch.Tensor
    env_max_luminance: torch.Tensor
    ray_bias: torch.Tensor
    t_min: torch.Tensor
    light_dir: torch.Tensor         # f32[3,3] per light, the pointing direction
    light_color: torch.Tensor       # f32[3,3]
    light_intensity: torch.Tensor   # f32[3]
    light_angle: torch.Tensor       # f32[3] radians, clamped [0.001, pi]
    clip_normal: torch.Tensor
    clip_offset: torch.Tensor
    clip_side: torch.Tensor
    volume_color: torch.Tensor
    volume_density: torch.Tensor
    volume_opacity: torch.Tensor
    volume_step: torch.Tensor
    volume_threshold: torch.Tensor
    cam_origin: torch.Tensor        # camera basis (right/up prescaled) + origin
    cam_forward: torch.Tensor
    cam_right: torch.Tensor
    cam_up: torch.Tensor
    resolution: torch.Tensor        # f32[2] (width, height)

    @property
    def device(self) -> torch.device:
        return self.resolution.device

    def to(self, device) -> "Uniforms":
        return Uniforms(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


# Shape of each Uniforms field, in the order of the flat buffer.
UNIFORM_SHAPES = {f.name: () for f in fields(Uniforms)}
UNIFORM_SHAPES.update(
    base_color=(3,), ambient_color=(3,), light_dir=(3, 3), light_color=(3, 3),
    light_intensity=(3,), light_angle=(3,), clip_normal=(3,), volume_color=(3,),
    cam_origin=(3,), cam_forward=(3,), cam_right=(3,), cam_up=(3,), resolution=(2,))
UNIFORM_SIZE = sum(math.prod(shape) for shape in UNIFORM_SHAPES.values())


def uniforms_view(flat: torch.Tensor) -> Uniforms:
    """Uniforms whose fields are views of `flat` (f32[UNIFORM_SIZE])."""
    out, at = {}, 0
    for name, shape in UNIFORM_SHAPES.items():
        size = math.prod(shape)
        out[name] = flat[at:at + size].view(shape)
        at += size
    return Uniforms(**out)


def uniforms_from_numpy(fields_: dict, device=None) -> Uniforms:
    """Uniforms from the JAX package's Uniforms fields (arrays converted
    with numpy) — carries identical per-frame values into the port.
    device None means cuda:0."""
    device = resolve_device(device)
    return Uniforms(**{
        f.name: torch.tensor(np.asarray(fields_[f.name], np.float32),
                             device=device)
        for f in fields(Uniforms)})


def static_flags(settings: RenderSettings, has_env: bool = False,
                 has_volume: bool = False, clip=None) -> StaticFlags:
    """The code-path switches of `settings` (see split_settings)."""
    s = settings
    return StaticFlags(
        material_mode=(MATERIAL_MODES[s.material_mode]
                       if isinstance(s.material_mode, str) else int(s.material_mode)),
        use_imported_color=bool(s.use_imported_color),
        use_env=bool(has_env),
        volume_enabled=bool(s.volume_enabled and has_volume),
        volume_max_steps=(int(min(s.volume_max_steps, 1024))
                          if (s.volume_enabled and has_volume) else 0),
        dof_enabled=bool(s.dof_enabled and s.dof_aperture > 1e-6),
        clip_enabled=bool(clip is not None),
        cast_shadows=bool(s.cast_shadows),
        max_bounces=int(min(max(s.max_bounces, 0), 8)),
        spp=int(min(max(s.samples_per_bounce, 1), 8)),
        surface_flag_mode=int(s.surface_flag_mode),
        light_enabled=tuple(bool(lt.enabled) for lt in s.lights[:3]),
        vis_mode=int(s.vis_mode),
        rim_enabled=bool(s.rim_boost > 0.0),
        tracer=str(s.tracer),
        use_bvh=bool(s.use_bvh),
    )


def uniform_values(settings: RenderSettings, camera_basis, light_dirs,
                   clip=None) -> np.ndarray:
    """The uniforms of one frame as the flat f32[UNIFORM_SIZE] host array
    that uniforms_view reads (see split_settings)."""
    s = settings
    if clip is None:
        clip_normal, clip_offset, clip_side = np.array([0.0, 0.0, 1.0]), 0.0, 1.0
    else:
        clip_normal, clip_offset, clip_side = clip
    values = dict(
        base_color=s.base_color,
        metallic=s.metallic,
        roughness=s.roughness,
        rim_boost=s.rim_boost,
        matte_specular=s.matte_specular,
        matte_roughness=s.matte_roughness,
        matte_diffuse_roughness=s.matte_diffuse_roughness,
        wrap_diffuse=s.wrap_diffuse,
        surface_ior=s.surface_ior,
        surface_transmission=s.surface_transmission,
        surface_opacity=s.surface_opacity,
        exposure=s.exposure,
        dof_aperture=s.dof_aperture,
        dof_focus_distance=s.dof_focus_distance,
        ambient_intensity=s.ambient_intensity,
        ambient_color=s.ambient_color,
        env_intensity=s.env_intensity,
        env_max_luminance=s.env_max_luminance,
        ray_bias=s.ray_bias,
        t_min=s.t_min,
        light_dir=light_dirs,
        light_color=[lt.color for lt in s.lights[:3]],
        light_intensity=[lt.intensity for lt in s.lights[:3]],
        light_angle=[float(np.clip(math.radians(lt.angle), 0.001, math.pi))
                     for lt in s.lights[:3]],
        clip_normal=clip_normal,
        clip_offset=clip_offset,
        clip_side=clip_side,
        volume_color=s.volume_color,
        volume_density=s.volume_density,
        volume_opacity=s.volume_opacity,
        volume_step=s.volume_step,
        volume_threshold=s.volume_threshold,
        cam_origin=camera_basis.origin,
        cam_forward=camera_basis.forward,
        cam_right=camera_basis.right,
        cam_up=camera_basis.up,
        resolution=[camera_basis.width, camera_basis.height],
    )
    return np.concatenate([np.asarray(values[name], np.float32).reshape(-1)
                           for name in UNIFORM_SHAPES])


def split_settings(settings: RenderSettings, camera_basis, light_dirs,
                   has_env: bool = False, has_volume: bool = False,
                   clip=None, device=None) -> tuple[StaticFlags, Uniforms]:
    """(static flags, uniforms on `device`, None meaning cuda:0) for one
    frame. has_env sets use_env (env miss radiance and env NEE).

    light_dirs: f32[3,3] world-space light directions for this camera.
    clip: optional (normal, offset, side)."""
    flat = uniform_values(settings, camera_basis, light_dirs, clip)
    return (static_flags(settings, has_env, has_volume, clip),
            uniforms_view(torch.as_tensor(flat, device=resolve_device(device))))
