"""Display transform: linear / ACES / Reinhard tone mapping; counterpart of
webgl_raytracer_tpu/ops/tonemap.py."""

from __future__ import annotations

import torch

TONE_MAP_MODES = {"linear": 0, "aces": 1, "reinhard": 2}


def tonemap_reinhard(c):
    return c / (1.0 + c)


def tonemap_aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def apply_tonemap(color, mode):
    """mode: 0 linear, 1 ACES, 2 Reinhard (int or name)."""
    if isinstance(mode, str):
        mode = TONE_MAP_MODES[mode]
    if mode == 1:
        return tonemap_aces(color)
    if mode == 2:
        return tonemap_reinhard(color)
    return color


def to_srgb_u8(color):
    """Linear [0,1] -> uint8: a plain quantisation, round half to even, no
    gamma (the reference writes linear values to an sRGB-unaware canvas)."""
    return torch.clamp(torch.round(color * 255.0), 0, 255).to(torch.uint8)
