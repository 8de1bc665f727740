"""Environment importance-sampling CDFs, built on the device.

Counterpart of webgl_raytracer_tpu/env/cdf.py: the per-pixel weight is
luminance * sin(theta); a marginal CDF over rows (H+1) and per-row
conditional CDFs over columns (H x (W+1)), each with its last entry forced
to 1 — two prefix sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops import vec3 as V
from ..ops.envmap import EnvBuffers


def _build_cdfs(radiance: torch.Tensor):
    """radiance f32[H,W,3] -> (marginal f32[H+1], conditional f32[H,W+1],
    total luminance as a 0-d tensor)."""
    h = radiance.shape[0]
    device = radiance.device
    theta = ((torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
             * math.pi)
    sin_theta = V.sin(theta)
    lum = (radiance[..., 0] * 0.2126 + radiance[..., 1] * 0.7152
           + radiance[..., 2] * 0.0722) * sin_theta[:, None]
    row_sums = lum.sum(dim=1)
    total = row_sums.sum()
    zero = torch.zeros((1,), dtype=torch.float32, device=device)
    marginal = torch.cat([zero, torch.cumsum(row_sums / torch.clamp_min(total, 1e-20), 0)])
    marginal[-1] = 1.0
    safe_rows = torch.where(row_sums > 0, row_sums, 1.0)
    cond = torch.cat([torch.zeros((h, 1), dtype=torch.float32, device=device),
                      torch.cumsum(lum / safe_rows[:, None], dim=1)], dim=1)
    cond[:, -1] = 1.0
    return marginal, cond, total


def _as_radiance(radiance, device) -> torch.Tensor:
    if not torch.is_tensor(radiance):
        radiance = torch.tensor(np.asarray(radiance, np.float32))
    r = radiance.to(device=device, dtype=torch.float32)
    if r.shape[-1] == 4:
        r = r[..., :3]
    return r.contiguous()


def build_env_sampling(radiance, device=None):
    """radiance f32[H,W,3] (or [H,W,4], alpha dropped) -> (marginal
    f32[H+1], conditional f32[H,W+1], total luminance) on `device` (None:
    cuda:0)."""
    marginal, cond, total = _build_cdfs(_as_radiance(radiance, resolve_device(device)))
    return marginal, cond, float(total)


def make_env_buffers(radiance, device=None) -> EnvBuffers:
    """Full environment compile: image and CDFs as tensors on `device`
    (None: cuda:0)."""
    r = _as_radiance(radiance, resolve_device(device))
    marginal, cond, _ = _build_cdfs(r)
    return EnvBuffers(radiance=r, marginal_cdf=marginal, conditional_cdf=cond,
                      width=int(r.shape[1]), height=int(r.shape[0]))


def constant_env(value=1.0, width: int = 16, height: int = 8,
                 device=None) -> EnvBuffers:
    """Uniform environment (furnace tests; the 'white' fallback env)."""
    return make_env_buffers(np.full((height, width, 3), value, np.float32), device)


def env_from_numpy(fields_: dict, device=None) -> EnvBuffers:
    """EnvBuffers from the JAX package's EnvBuffers fields as numpy arrays
    (radiance, marginal_cdf, conditional_cdf, width, height): carries an
    identical environment, CDFs included, into the port."""
    device = resolve_device(device)

    def t(name):
        return torch.tensor(np.asarray(fields_[name], np.float32), device=device)

    return EnvBuffers(radiance=t("radiance"), marginal_cdf=t("marginal_cdf"),
                      conditional_cdf=t("conditional_cdf"),
                      width=int(fields_["width"]), height=int(fields_["height"]))
