"""The viewer's analytic sky and its importance-sampling tables.

The Preetham/Perez sky baked to an equirect float image (the sun from an
azimuth and an elevation, Perez coefficients in the turbidity, zenith
luminance and chromaticity, xyY to linear sRGB, a ground-albedo blend
below the horizon and a Gaussian sun glow), and the sampling tables of an
equirect image: weight = luminance * sin(theta), a marginal CDF over rows
and a conditional CDF over each row's columns, last entries forced to 1.
Then the lookups the shader makes: a bilinear radiance fetch with the soft
luminance clamp, a CDF-sampled direction with its pdf, and the pdf of a
direction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fmath as M

PI = math.pi
TWO_PI = 2.0 * math.pi


def _perez(coeffs, theta, gamma):
    a, b, c, d, e = coeffs
    cos_theta = torch.clamp_min(M.cos(theta), 0.01)
    cos_gamma = M.cos(gamma)
    return (1.0 + a * M.exp(b / cos_theta)) * (1.0 + c * M.exp(d * gamma)
                                               + e * cos_gamma * cos_gamma)


def _chroma(t, th, c2, c1, c0):
    th2 = th * th
    th3 = th2 * th
    return torch.clamp((c2[0] * th3 + c2[1] * th2 + c2[2] * th + c2[3]) * t * t
                       + (c1[0] * th3 + c1[1] * th2 + c1[2] * th + c1[3]) * t
                       + c0[0] * th3 + c0[1] * th2 + c0[2] * th + c0[3], 0.001, 0.999)


def sky_image(s: dict, device) -> torch.Tensor:
    """f32[H,W,3] sky radiance for the settings dict `s` (the analytic
    sky's width, height, turbidity, sun_azimuth_deg, sun_elevation_deg,
    sky_intensity, sun_intensity, sun_angular_radius_deg, ground_albedo,
    horizon_softness)."""
    f32 = torch.float32

    def const(x):
        return torch.tensor(x, dtype=f32, device=device)

    w, h = int(s["width"]), int(s["height"])
    u = (torch.arange(w, dtype=f32, device=device) + 0.5) / w
    v = (torch.arange(h, dtype=f32, device=device) + 0.5) / h
    phi = u[None, :] * TWO_PI
    theta = v[:, None] * PI
    sin_theta = M.sin(theta)
    dirs = torch.stack([M.cos(phi) * sin_theta, M.cos(theta).expand(h, w),
                        M.sin(phi) * sin_theta], dim=-1)

    az, el = math.radians(s["sun_azimuth_deg"]), math.radians(s["sun_elevation_deg"])
    sun = np.array([math.cos(az) * math.cos(el), math.sin(el), math.sin(az) * math.cos(el)])
    sun = const(sun / (np.linalg.norm(sun) or 1.0))
    sun = sun / torch.linalg.vector_norm(sun)
    theta_s = M.acos(torch.clamp(sun[1], -1.0, 1.0))
    gamma = M.acos(torch.clamp((dirs * sun).sum(dim=-1), -1.0, 1.0))

    t = torch.clamp_min(const(s["turbidity"]), 1.0)
    cy = (0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
          0.1206 * t - 2.5771, -0.0670 * t + 0.3703)
    cx = (-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
          -0.0641 * t - 0.8989, -0.0033 * t + 0.0452)
    cyy = (-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
           -0.0441 * t - 1.6537, -0.0109 * t + 0.0529)
    chi = (4.0 / 9.0 - t / 120.0) * (PI - 2.0 * theta_s)
    y_zen = torch.clamp_min((4.0453 * t - 4.9710) * M.tan(chi) - 0.2155 * t + 2.4192, 0.001)
    x_zen = _chroma(t, theta_s, (0.00165, -0.00374, 0.00208, 0.0),
                    (-0.02902, 0.06377, -0.03202, 0.00394),
                    (0.11693, -0.21196, 0.06052, 0.25885))
    yy_zen = _chroma(t, theta_s, (0.00275, -0.00610, 0.00317, 0.0),
                     (-0.04214, 0.08970, -0.04153, 0.00516),
                     (0.15346, -0.26756, 0.06669, 0.26688))
    zero = const(0.0)
    big_y = torch.clamp_min(y_zen * _perez(cy, theta, gamma)
                            / torch.clamp_min(_perez(cy, zero, theta_s), 1e-4), 0.0)
    x = x_zen * _perez(cx, theta, gamma) / torch.clamp_min(_perez(cx, zero, theta_s), 1e-4)
    yy = yy_zen * _perez(cyy, theta, gamma) / torch.clamp_min(_perez(cyy, zero, theta_s), 1e-4)
    x = torch.clamp(x, 0.001, 0.999)
    yy = torch.clamp(yy, 0.001, 0.999)
    over = (x + yy) > 0.999
    k = 0.999 / torch.clamp_min(x + yy, 1e-6)
    x = torch.where(over, x * k, x)
    yy = torch.where(over, yy * k, yy)

    safe = torch.clamp_min(yy, 1e-4)
    big_x = (x / safe) * big_y
    big_z = ((1.0 - x - yy) / safe) * big_y
    rgb = torch.stack([3.2406 * big_x - 1.5372 * big_y - 0.4986 * big_z,
                       -0.9689 * big_x + 1.8758 * big_y + 0.0415 * big_z,
                       0.0557 * big_x - 0.2040 * big_y + 1.0570 * big_z], dim=-1)
    rgb = torch.clamp_min(torch.where((yy < 1e-4)[..., None], 0.0, rgb), 0.0)
    sky_int = const(s["sky_intensity"])
    rgb = rgb * sky_int

    blend = torch.clamp(torch.abs(dirs[..., 1])
                        / torch.clamp_min(const(s["horizon_softness"]), 1e-4), 0.0, 1.0)
    ground = const(s["ground_albedo"]) * sky_int
    mixed = rgb * 0.05 * (1.0 - blend[..., None]) + ground * blend[..., None]
    rgb = torch.where((dirs[..., 1] < 0.0)[..., None], mixed, rgb)
    sigma = torch.clamp_min(const(math.radians(s["sun_angular_radius_deg"])), 1e-4)
    glow = M.exp(-0.5 * torch.square(gamma / sigma))
    return torch.clamp_min(rgb + (const(s["sun_intensity"]) * glow)[..., None], 0.0)


class Env:
    """An equirect image with its sampling tables, in `dtype`."""

    def __init__(self, radiance: torch.Tensor, dtype=torch.float32):
        h, w = radiance.shape[0], radiance.shape[1]
        theta = (torch.arange(h, dtype=torch.float32, device=radiance.device) + 0.5) / h * PI
        lum = (radiance[..., 0] * 0.2126 + radiance[..., 1] * 0.7152
               + radiance[..., 2] * 0.0722) * M.sin(theta)[:, None]
        rows = lum.sum(dim=1)
        total = rows.sum()
        marginal = torch.cat([torch.zeros(1, device=lum.device),
                              torch.cumsum(rows / torch.clamp_min(total, 1e-20), 0)])
        marginal[-1] = 1.0
        safe = torch.where(rows > 0, rows, 1.0)
        cond = torch.cat([torch.zeros((h, 1), device=lum.device),
                          torch.cumsum(lum / safe[:, None], dim=1)], dim=1)
        cond[:, -1] = 1.0
        self.width, self.height = w, h
        self.flat = radiance.reshape(-1, 3).to(dtype)
        self.marginal = marginal.to(dtype)
        self.cond = cond.to(dtype)


def _dir_to_uv(d):
    u = M.atan2(d[2], d[0]) / TWO_PI + 0.5
    v = M.acos(torch.clamp(d[1], -1.0, 1.0)) / PI
    return u, v


def radiance(env: Env, d, intensity: float, max_lum: float):
    """Bilinear lookup times intensity, with the soft luminance clamp."""
    u, v = _dir_to_uv(d)
    w, h = env.width, env.height
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(x - torch.floor(x), 0.0, 1.0)[:, None]
    fy = torch.clamp(y - torch.floor(y), 0.0, 1.0)[:, None]
    img = env.flat
    color = ((img[y0 * w + x0] * (1 - fx) + img[y0 * w + x1] * fx) * (1 - fy)
             + (img[y1 * w + x0] * (1 - fx) + img[y1 * w + x1] * fx) * fy)
    color = color * intensity
    lum = color[:, 0] * 0.2126 + color[:, 1] * 0.7152 + color[:, 2] * 0.0722
    if max_lum > 0.0:
        excess = lum - max_lum
        compressed = max_lum + excess / (1.0 + excess / max_lum)
        k = torch.where(lum > max_lum, compressed / torch.clamp_min(lum, 1e-12), 1.0)
        color = color * k[:, None]
    return (color[:, 0], color[:, 1], color[:, 2])


def _search(cdf, size: int, xi, row=None):
    """Index of the CDF bucket that holds xi, and xi's place in it."""
    def fetch(i):
        return cdf[i] if row is None else cdf[row, i]

    lo = torch.zeros(xi.shape, dtype=torch.long, device=xi.device)
    hi = torch.full_like(lo, size - 1)
    for _ in range(math.ceil(math.log2(size)) + 1):
        cont = lo < hi
        mid = (lo + hi) // 2
        right = cont & (fetch(mid) <= xi)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(cont & ~right, mid, hi)
    idx = torch.clamp_min(lo - 1, 0)
    c_lo, c_hi = fetch(idx), fetch(idx + 1)
    span = torch.where(c_hi > c_lo, c_hi - c_lo, torch.ones_like(c_hi))
    tt = torch.where(c_hi > c_lo, torch.clamp((xi - c_lo) / span, 0.0, 1.0),
                     torch.zeros_like(c_hi))
    return idx, idx.to(xi.dtype) + tt


def sample_direction(env: Env, r1, r2):
    """A direction drawn in proportion to the weights, and its pdf."""
    w, h = env.width, env.height
    v_idx, v_f = _search(env.marginal, h + 1, r1)
    v_idx = torch.clamp(v_idx, 0, h - 1)
    u_idx, u_f = _search(env.cond, w + 1, r2, row=v_idx)
    v = (v_f + 0.5) / h
    u = (u_f + 0.5) / w
    theta = v * PI
    phi = u * TWO_PI - PI
    sin_t = M.sin(theta)
    d = (sin_t * M.cos(phi), M.cos(theta), sin_t * M.sin(phi))
    mpdf = env.marginal[v_idx + 1] - env.marginal[v_idx]
    ub = torch.clamp(u_f.long(), 0, w - 1)
    cpdf = env.cond[v_idx, ub + 1] - env.cond[v_idx, ub]
    pdf = mpdf * h * cpdf * w / (2.0 * PI * PI * torch.clamp_min(sin_t, 1e-4))
    return d, torch.clamp_min(pdf, 1e-6)


def pdf(env: Env, d):
    u, v = _dir_to_uv(d)
    w, h = env.width, env.height
    ui = torch.clamp((u * w).long(), 0, w - 1)
    vi = torch.clamp((v * h).long(), 0, h - 1)
    p = ((env.marginal[vi + 1] - env.marginal[vi]) * h
         * (env.cond[vi, ui + 1] - env.cond[vi, ui]) * w)
    return torch.clamp_min(p / (2.0 * PI * PI * torch.clamp_min(M.sin(v * PI), 1e-4)), 1e-6)
