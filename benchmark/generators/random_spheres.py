"""Upstream's built-in scaling scene (src/main.js loadRandomSpheres):
`spheres` random spheres in a cube of side cube_scale * spheres**(1/3),
radii in [radius_min, radius_min + radius_span), colours drawn as HSL (hue
in [0, 1), saturation and lightness in their configured ranges). Each
sphere takes seven draws in upstream's order (x, y, z, radius, hue,
saturation, lightness), from numpy's PCG64 seeded with the run's seed where
upstream uses mulberry32(12345).

The sphere scene kind: generate, program_scene, bounds and reference_scene
(benchmark/README.md, "Adding a configuration of another scene kind")."""

from __future__ import annotations

import numpy as np

from benchmark.reference import tracer as T


def hsl_to_rgb(h, s, light):
    """Upstream's hslToRgb, on arrays."""
    q = np.where(light < 0.5, light * (1 + s), light + s - light * s)
    p = 2 * light - q

    def channel(t):
        t = np.mod(t, 1.0)
        return np.select([t < 1 / 6, t < 1 / 2, t < 2 / 3],
                         [p + (q - p) * 6 * t, q, p + (q - p) * (2 / 3 - t) * 6], p)
    return np.stack([channel(h + 1 / 3), channel(h), channel(h - 1 / 3)], axis=1)


def generate(config: dict, seed: int) -> dict:
    """{"centers": f32[N,3], "radii": f32[N], "colors": f32[N,3]}."""
    rng = np.random.default_rng(seed % 2**64)
    n = int(config["spheres"])
    cube = n ** (1 / 3) * float(config["cube_scale"])
    u = rng.random((n, 7))
    centers = ((u[:, :3] - 0.5) * cube).astype(np.float32)
    radii = float(config["radius_min"]) + u[:, 3] * float(config["radius_span"])
    sat = float(config["saturation_min"]) + u[:, 5] * float(config["saturation_span"])
    light = float(config["lightness_min"]) + u[:, 6] * float(config["lightness_span"])
    colors = hsl_to_rgb(u[:, 4], sat, light).astype(np.float32)
    return {"centers": centers, "radii": radii.astype(np.float32), "colors": colors}


def program_scene(geo: dict, config: dict, device):
    """The program's compiled scene of the spheres, and no volume."""
    from webgl_raytracer_tpu_torch.models import Geometry
    from webgl_raytracer_tpu_torch.scene import compile_scene

    z3 = geo["centers"][:0]
    scene = compile_scene(Geometry(geo["centers"], geo["radii"], geo["colors"], z3, z3,
                                   geo["radii"][:0], z3), device=device)
    return scene, None


def bounds(geo: dict):
    return T.sphere_bounds(geo["centers"], geo["radii"])


def reference_scene(geo: dict, config: dict, sky, device, dtype):
    return T.Scene(geo["centers"], geo["radii"], geo["colors"], sky, device, dtype)
