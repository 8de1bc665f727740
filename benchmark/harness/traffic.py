"""The one traffic generator: a viewer user who looks at a view until it
has converged, then turns the camera anywhere on the viewer's orbit.

A traffic file gives
  frames_per_view   frames rendered before the camera turns (the viewer's
                    progressive cap); the check compares the shown view at
                    this many frames
  views_per_round   views in each round of the orbit: every round takes one
                    azimuth in each of this many equal sectors of the full
                    circle and one elevation in each of this many bands of
                    equal solid angle, paired at random (a Latin hypercube
                    drawn from the seed), so every seed's views cover the
                    whole orbit alike, in another order
  pole_limit_y      the orbit's pole limit: the viewer's drag keeps
                    |forward.y| under it (scene/camera.apply_orbit_drag)
  sky               the analytic sky's settings, or null for no environment
  profile_frames    frames of the window that a traced run profiles
  check_pixels, check_candidates
                    pixels the check compares, and the seeded pixels they
                    are drawn from (half from primary hits where there are
                    enough)
Every view is at the fitted camera's target and distance.
"""

from __future__ import annotations

import math

import numpy as np

from ..reference import camera as C


def views(traffic: dict, fov: float, lo, hi, seed: int):
    """Endless camera dicts (target, distance, rotation, fov) of the
    seeded orbit: a stream of its own, so the scene does not move it."""
    target, distance = C.fit_camera(lo, hi, fov)
    rng = np.random.default_rng([seed % 2**64, 1])
    k = int(traffic["views_per_round"])
    pole = float(traffic["pole_limit_y"])
    while True:
        azimuth = (rng.permutation(k) + rng.random(k)) / k * 360.0
        height = ((rng.permutation(k) + rng.random(k)) / k * 2.0 - 1.0) * pole
        for az, y in zip(azimuth, height):
            yield {"target": target, "distance": distance, "fov": fov,
                   "rotation": C.view_rotation(float(az), math.degrees(math.asin(y)))}
