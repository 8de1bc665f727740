"""Preetham/Perez analytic sky baked to an equirect float image on the
device.

Counterpart of webgl_raytracer_tpu/env/sky.py: the settings record and
its validation, the sun direction, the Perez coefficient polynomials,
zenith values, xyY -> linear sRGB, the ground-albedo blend below the
horizon and the Gaussian sun glow, as elementwise torch over the pixel
grid.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import vec3 as V

ANALYTIC_SKY_ID = "analytic://preetham-perez"


@dataclass(frozen=True)
class AnalyticSkySettings:
    width: int = 1024
    height: int = 512
    turbidity: float = 2.5
    sun_azimuth_deg: float = 30.0
    sun_elevation_deg: float = 35.0
    sky_intensity: float = 1.0
    sun_intensity: float = 20.0
    sun_angular_radius_deg: float = 0.27
    ground_albedo: float = 0.2
    horizon_softness: float = 0.12


def normalize_analytic_sky_settings(raw=None, **kw) -> AnalyticSkySettings:
    """Merge and validate settings; raises ValueError out of range."""
    base = asdict(AnalyticSkySettings())
    if raw:
        base.update(raw if isinstance(raw, dict) else asdict(raw))
    base.update(kw)
    s = AnalyticSkySettings(**base)

    if not (isinstance(s.width, int) and s.width > 0):
        raise ValueError("Analytic sky width must be a positive integer.")
    if not (isinstance(s.height, int) and s.height > 0):
        raise ValueError("Analytic sky height must be a positive integer.")
    for name in ("turbidity", "sun_azimuth_deg", "sun_elevation_deg", "sky_intensity",
                 "sun_intensity", "sun_angular_radius_deg", "ground_albedo",
                 "horizon_softness"):
        if not math.isfinite(float(getattr(s, name))):
            raise ValueError(f"Analytic sky {name} must be finite.")
    if not 1.0 <= s.turbidity <= 20.0:
        raise ValueError("Analytic sky turbidity must be between 1 and 20.")
    if not -10.0 <= s.sun_elevation_deg <= 90.0:
        raise ValueError("Analytic sky sun elevation must be between -10 and 90 degrees.")
    if not 0.0 <= s.sky_intensity <= 100.0:
        raise ValueError("Analytic sky intensity must be between 0 and 100.")
    if not 0.0 <= s.sun_intensity <= 10000.0:
        raise ValueError("Analytic sky sun intensity must be between 0 and 10000.")
    if not 0.0 < s.sun_angular_radius_deg <= 5.0:
        raise ValueError("Analytic sky sun angular radius must be > 0 and <= 5 degrees.")
    if not 0.0 <= s.ground_albedo <= 1.0:
        raise ValueError("Analytic sky ground albedo must be between 0 and 1.")
    if not 0.0 < s.horizon_softness <= 1.0:
        raise ValueError("Analytic sky horizon softness must be > 0 and <= 1.")
    return s


def analytic_sky_cache_key(settings=None, **kw) -> str:
    s = normalize_analytic_sky_settings(settings, **kw)
    return "|".join([
        str(s.width), str(s.height),
        f"{s.turbidity:.4f}", f"{s.sun_azimuth_deg:.4f}", f"{s.sun_elevation_deg:.4f}",
        f"{s.sky_intensity:.4f}", f"{s.sun_intensity:.4f}",
        f"{s.sun_angular_radius_deg:.4f}", f"{s.ground_albedo:.4f}",
        f"{s.horizon_softness:.4f}"])


def compute_sun_direction(sun_azimuth_deg: float, sun_elevation_deg: float) -> np.ndarray:
    az = math.radians(sun_azimuth_deg)
    el = math.radians(sun_elevation_deg)
    d = np.array([math.cos(az) * math.cos(el), math.sin(el),
                  math.sin(az) * math.cos(el)])
    return d / (np.linalg.norm(d) or 1.0)


def _perez(coeffs, theta, gamma):
    a, b, c, d, e = coeffs
    cos_theta = torch.clamp_min(V.cos(theta), 0.01)
    part1 = 1.0 + a * V.exp(b / cos_theta)
    cos_gamma = V.cos(gamma)
    part2 = 1.0 + c * V.exp(d * gamma) + e * cos_gamma * cos_gamma
    return part1 * part2


def _coeff_y(t):
    return (0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
            0.1206 * t - 2.5771, -0.0670 * t + 0.3703)


def _coeff_x(t):
    return (-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
            -0.0641 * t - 0.8989, -0.0033 * t + 0.0452)


def _coeff_yy(t):
    return (-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
            -0.0441 * t - 1.6537, -0.0109 * t + 0.0529)


def _zenith_luminance(t, theta_s):
    chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * V.tan(chi) - 0.2155 * t + 2.4192
    return torch.clamp_min(yz, 0.001)


def _zenith_chroma(t, theta_s, c2, c1, c0):
    th = theta_s
    th2 = th * th
    th3 = th2 * th
    term1 = (c2[0] * th3 + c2[1] * th2 + c2[2] * th + c2[3]) * t * t
    term2 = (c1[0] * th3 + c1[1] * th2 + c1[2] * th + c1[3]) * t
    term3 = c0[0] * th3 + c0[1] * th2 + c0[2] * th + c0[3]
    return torch.clamp(term1 + term2 + term3, 0.001, 0.999)


_ZX_C2 = (0.00165, -0.00374, 0.00208, 0.0)
_ZX_C1 = (-0.02902, 0.06377, -0.03202, 0.00394)
_ZX_C0 = (0.11693, -0.21196, 0.06052, 0.25885)
_ZY_C2 = (0.00275, -0.00610, 0.00317, 0.0)
_ZY_C1 = (-0.04214, 0.08970, -0.04153, 0.00516)
_ZY_C0 = (0.15346, -0.26756, 0.06669, 0.26688)


def _xyy_to_rgb(x, y, big_y):
    safe_y = torch.clamp_min(y, 1e-4)
    big_x = (x / safe_y) * big_y
    big_z = ((1.0 - x - y) / safe_y) * big_y
    r = 3.2406 * big_x - 1.5372 * big_y - 0.4986 * big_z
    g = -0.9689 * big_x + 1.8758 * big_y + 0.0415 * big_z
    b = 0.0557 * big_x - 0.2040 * big_y + 1.0570 * big_z
    rgb = torch.stack([r, g, b], dim=-1)
    rgb = torch.where((y < 1e-4)[..., None], 0.0, rgb)
    return torch.clamp_min(rgb, 0.0)


def sky_image(s: AnalyticSkySettings, device=None) -> torch.Tensor:
    """The sky of normalised settings `s` as f32[H,W,3] on `device` (None:
    cuda:0)."""
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    width, height = s.width, s.height
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    phi = u[None, :] * (2.0 * math.pi)
    theta = v[:, None] * math.pi
    sin_theta = V.sin(theta)
    dirs = torch.stack([
        V.cos(phi) * sin_theta,
        V.cos(theta).expand(height, width),
        V.sin(phi) * sin_theta,
    ], dim=-1)

    sun_dir = f32(compute_sun_direction(s.sun_azimuth_deg, s.sun_elevation_deg))
    sun = sun_dir / torch.linalg.vector_norm(sun_dir)
    theta_s = V.acos(torch.clamp(sun[1], -1.0, 1.0))
    gamma = V.acos(torch.clamp((dirs * sun).sum(dim=-1), -1.0, 1.0))

    t = torch.clamp_min(f32(s.turbidity), 1.0)
    cy = _coeff_y(t)
    cx = _coeff_x(t)
    cyy = _coeff_yy(t)

    y_zen = _zenith_luminance(t, theta_s)
    x_zen = _zenith_chroma(t, theta_s, _ZX_C2, _ZX_C1, _ZX_C0)
    yy_zen = _zenith_chroma(t, theta_s, _ZY_C2, _ZY_C1, _ZY_C0)

    zero = f32(0.0)
    y_norm = _perez(cy, zero, theta_s)
    x_norm = _perez(cx, zero, theta_s)
    yy_norm = _perez(cyy, zero, theta_s)

    big_y = torch.clamp_min(y_zen * _perez(cy, theta, gamma) / torch.clamp_min(y_norm, 1e-4), 0.0)
    x = x_zen * _perez(cx, theta, gamma) / torch.clamp_min(x_norm, 1e-4)
    yy = yy_zen * _perez(cyy, theta, gamma) / torch.clamp_min(yy_norm, 1e-4)
    x = torch.clamp(x, 0.001, 0.999)
    yy = torch.clamp(yy, 0.001, 0.999)
    overflow = (x + yy) > 0.999
    scale = 0.999 / torch.clamp_min(x + yy, 1e-6)
    x = torch.where(overflow, x * scale, x)
    yy = torch.where(overflow, yy * scale, yy)

    sky_intensity = f32(s.sky_intensity)
    rgb = _xyy_to_rgb(x, yy, big_y) * sky_intensity

    below = dirs[..., 1] < 0.0
    softness = f32(s.horizon_softness)
    blend = torch.clamp(torch.abs(dirs[..., 1]) / torch.clamp_min(softness, 1e-4), 0.0, 1.0)
    ground = f32(s.ground_albedo) * sky_intensity
    mixed = rgb * 0.05 * (1.0 - blend[..., None]) + ground * blend[..., None]
    rgb = torch.where(below[..., None], mixed, rgb)

    sun_sigma = torch.clamp_min(f32(math.radians(s.sun_angular_radius_deg)), 1e-4)
    glow = V.exp(-0.5 * torch.square(gamma / sun_sigma))
    rgb = rgb + (f32(s.sun_intensity) * glow)[..., None]
    return torch.clamp_min(rgb, 0.0)


def generate_analytic_sky(settings=None, device=None, **kw) -> dict:
    """The sky image with its settings: dict(source, version, settings,
    width, height, data f32[H,W,3] tensor on `device`)."""
    s = normalize_analytic_sky_settings(settings, **kw)
    return {"source": ANALYTIC_SKY_ID,
            "version": f"{ANALYTIC_SKY_ID}:{analytic_sky_cache_key(s)}",
            "settings": s, "width": s.width, "height": s.height,
            "data": sky_image(s, device)}
