"""Environment-map radiance lookup and CDF importance sampling.

Counterpart of webgl_raytracer_tpu/ops/envmap.py (component-form variants
only): equirect direction <-> UV, the bilinear radiance lookup with the soft
luminance knee, the two-level (marginal row / conditional column) CDF
sampler with a fixed-trip bisection over the whole batch, and the
solid-angle pdf used by MIS. Plain tensor code: gathers and elementwise
maths, no hand kernel (the JAX package has none here either).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import vec3 as V
from .rng import rand2
from .sampling import PI, TWO_PI


@dataclass
class EnvBuffers:
    """Environment radiance + sampling CDFs as tensors on one device.

    radiance f32[H,W,3]; marginal_cdf f32[H+1]; conditional_cdf f32[H,W+1]
    (each row a CDF over columns)."""
    radiance: torch.Tensor
    marginal_cdf: torch.Tensor
    conditional_cdf: torch.Tensor
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.radiance.device

    def to(self, device) -> "EnvBuffers":
        return EnvBuffers(self.radiance.to(device), self.marginal_cdf.to(device),
                          self.conditional_cdf.to(device), self.width, self.height)


def dir_to_uv_v3(d):
    u = V.atan2(d[2], d[0]) / TWO_PI + 0.5
    v = V.acos(torch.clamp(d[1], -1.0, 1.0)) / PI
    return u, v


def sample_env_radiance_v3(env: EnvBuffers, d, intensity, max_luminance):
    """Bilinear equirect lookup times intensity, with the soft luminance
    clamp; direction and colour as component triples."""
    u, v = dir_to_uv_v3(d)
    h, w = env.height, env.width
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(x - torch.floor(x), 0.0, 1.0)
    fy = torch.clamp(y - torch.floor(y), 0.0, 1.0)

    flat = env.radiance.reshape(-1, 3)
    idx00 = y0 * w + x0
    idx10 = y0 * w + x1
    idx01 = y1 * w + x0
    idx11 = y1 * w + x1
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    out = []
    for c in range(3):
        ch = flat[:, c]
        val = ch[idx00] * w00 + ch[idx10] * w10 + ch[idx01] * w01 + ch[idx11] * w11
        out.append(val * intensity)

    lum = out[0] * 0.2126 + out[1] * 0.7152 + out[2] * 0.0722
    excess = lum - max_luminance
    compressed = max_luminance + excess / (1.0 + excess / torch.clamp_min(max_luminance, 1e-12))
    scale = torch.where((max_luminance > 0.0) & (lum > max_luminance),
                        compressed / torch.clamp_min(lum, 1e-12), 1.0)
    return (out[0] * scale, out[1] * scale, out[2] * scale)


def _bisect_cdf(gather, size: int, xi):
    """First index where cdf > xi, minus one, plus the in-bucket fraction:
    a fixed ceil(log2(size)) trips over the whole batch. `gather(idx)`
    fetches cdf values at integer indices. Returns (idx i64, float idx)."""
    lo = torch.zeros(xi.shape, dtype=torch.int64, device=xi.device)
    hi = torch.full_like(lo, size - 1)
    for _ in range(max(1, math.ceil(math.log2(max(2, size))))):
        cont = lo < hi
        mid = (lo + hi) // 2
        go_right = cont & (gather(mid) <= xi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(cont & ~go_right, mid, hi)
    idx = torch.clamp_min(lo - 1, 0)
    c_lo = gather(idx)
    c_hi = gather(idx + 1)
    t = torch.where(c_hi > c_lo,
                    torch.clamp((xi - c_lo) / (c_hi - c_lo), 0.0, 1.0), 0.0)
    return idx, idx.to(torch.float32) + t


def conditional_pdf(cond, v_idx, u_float):
    """cond[v, u+1] - cond[v, u] at the column bin u of u_float, with the
    column indices clamped into [0, W] as the JAX package's gathers clamp
    them: u_float = idx + fraction can round up to W (a fraction within an
    ulp of 1 in the last bin), and that bin's pdf is then 0."""
    last = cond.shape[1] - 1
    u_bin = u_float.to(torch.int64)
    return (cond[v_idx, torch.clamp(u_bin + 1, 0, last)]
            - cond[v_idx, torch.clamp(u_bin, 0, last)])


def sample_env_direction_v3(env: EnvBuffers, state):
    """Importance-sample a direction ~ luminance * sin(theta): (state,
    direction triple, solid-angle pdf). Two RNG draws."""
    state, r1, r2 = rand2(state)
    h, w = env.height, env.width
    marg = env.marginal_cdf
    v_idx_raw, v_float = _bisect_cdf(lambda i: marg[i], h + 1, r1)
    v_idx = torch.clamp(v_idx_raw, 0, h - 1)
    v = (v_float + 0.5) / h
    cond = env.conditional_cdf
    _, u_float = _bisect_cdf(lambda i: cond[v_idx, i], w + 1, r2)
    u = (u_float + 0.5) / w

    theta = v * PI
    phi = u * TWO_PI - PI
    sin_t = V.sin(theta)
    d = (sin_t * V.cos(phi), V.cos(theta), sin_t * V.sin(phi))

    marginal_pdf = marg[v_idx + 1] - marg[v_idx]
    pdf_uv = marginal_pdf * h * conditional_pdf(cond, v_idx, u_float) * w
    pdf = pdf_uv / (2.0 * PI * PI * torch.clamp_min(sin_t, 1e-4))
    return state, d, torch.clamp_min(pdf, 1e-6)


def env_pdf_v3(env: EnvBuffers, d):
    """pdf of sampling direction d from the env CDFs (solid angle)."""
    u, v = dir_to_uv_v3(d)
    w, h = env.width, env.height
    u_idx = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    v_idx = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    marginal_pdf = env.marginal_cdf[v_idx + 1] - env.marginal_cdf[v_idx]
    cond_pdf = env.conditional_cdf[v_idx, u_idx + 1] - env.conditional_cdf[v_idx, u_idx]
    pdf_uv = marginal_pdf * h * cond_pdf * w
    theta = v * PI
    sin_t = torch.clamp_min(V.sin(theta), 1e-4)
    return torch.clamp_min(pdf_uv / (2.0 * PI * PI * sin_t), 1e-6)
