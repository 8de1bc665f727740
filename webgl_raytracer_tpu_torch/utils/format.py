"""Display formatting helpers; the port's own copy of
webgl_raytracer_tpu/utils/format.py (renderer_controller.js:1-6)."""

from __future__ import annotations

import math


def format_poly_count(count) -> str:
    """1234567 -> '1.2M', 56000 -> '56K'."""
    if not isinstance(count, (int, float)) or not math.isfinite(count):
        return "0"
    if count >= 1_000_000:
        return f"{count / 1_000_000:.1f}".rstrip("0").rstrip(".") + "M"
    if count >= 1_000:
        return f"{count / 1_000:.1f}".rstrip("0").rstrip(".") + "K"
    return str(int(count))
