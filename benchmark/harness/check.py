"""The check that decides `correct`: the shown view's image, held against
the plain reference at pixels drawn from the seed.

After the window closes, the view shown then is rendered on through the
same Renderer.render_frame() to its frames_per_view frames, and the
accumulator holds their running mean. The scene kind's reference scene
renders those same frames (pixel, frame index, camera, settings, sky) at
the sampled pixels and folds them the same way. Half the sample comes from
pixels whose centre ray hits the scene, so that the lit paths, and not the
background, fill it.

The reference scene is any object with closest(o, d, tmin) (an index per
ray, >= 0 where it hits), trace_frames(settings, view, width, height, px,
py, frames), accumulate(colors), lo, hi, device and dtype
(benchmark/README.md).

A program that rounds otherwise at the same precision sends a path
elsewhere within a few bounces, so the two images differ by Monte Carlo
noise that shrinks with the frames; a wrong program differs by a shift
or an error that does not. How noisy the image is depends on the view
(the sun in view, or reflected), so the first number measures the
difference in the reference's own noise: the standard error of each
pixel's mean, the spread of its frames over sqrt(frames). Numbers, each
against the cell's limit:
  err_over_noise the sum over pixels and channels of |difference| over the
                 sum of the reference's standard errors: near 1 or under
                 for a sound render that rounds otherwise, about
                 sqrt(frames) for an image left at one frame
  mean_bias_pct  the largest, over the channels, |sum of the differences|
                 as a % of the reference's sum: a shift of the whole image
  rel_rmse       RMS of the differences over the RMS of the reference;
                 bright paths clamped at 100 rule it, so it does not part
                 a sound render from a wrong one under the sky
  px_off_pct     % of the sampled pixels where some channel differs from
                 the reference by more than PIXEL_ATOL + PIXEL_RTOL *
                 |reference|: near 0 where the program follows the
                 reference's rounding, near half where it does not

A cell compares the numbers its workload file gives a limit; the others
are printed beside them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..reference import fmath as M
from ..reference.camera import View

PIXEL_ATOL = 1e-4
PIXEL_RTOL = 1e-3
LANE_BLOCK = 1 << 18


class Expected(NamedTuple):
    """The reference at the sampled pixels after k frames: mean f32[n, 3]
    (folded as the program folds) and noise f64[n, 3], the standard error
    of each mean (0 where k is 1)."""
    mean: np.ndarray
    noise: np.ndarray


def primary_hits(scene, view: View, width: int, height: int, rows, cols):
    """[n] bool: the ray through each pixel's centre hits the scene."""
    dev, dt = scene.device, scene.dtype
    px = torch.as_tensor(cols, device=dev).to(dt)
    py = torch.as_tensor(height - 1 - rows, device=dev).to(dt)
    uvx = (px + 1.0) / float(width) * 2.0 - 1.0
    uvy = (py + 1.0) / float(height) * 2.0 - 1.0
    f, r, u = view.forward, view.right, view.up
    d = M.norm(tuple(float(f[i]) + uvx * float(r[i]) + uvy * float(u[i]) for i in range(3)))
    o = tuple(torch.full_like(px, float(view.origin[i])) for i in range(3))
    idx = scene.closest(o, d, torch.full_like(px, view.bias))
    return (idx >= 0).cpu().numpy()


def choose_pixels(scene, view, width, height, seed: int, pixels: int, candidates: int):
    """(rows, cols, primary hit share of the candidates): `pixels` of
    `candidates` seeded pixels, half of them centre-ray hits where there
    are enough."""
    rng = np.random.default_rng([seed % 2**64, 2])
    flat = rng.choice(width * height, size=min(candidates, width * height), replace=False)
    rows, cols = flat // width, flat % width
    hit = primary_hits(scene, view, width, height, rows, cols)
    hits, rest = np.nonzero(hit)[0], np.nonzero(~hit)[0]
    take_hits = min(len(hits), pixels // 2)
    pick = np.concatenate([rng.choice(hits, take_hits, replace=False),
                           rng.choice(rest, min(len(rest), pixels - take_hits), replace=False)])
    return rows[pick], cols[pick], float(hit.mean())


def reference_means(scene, settings, view, width, height, rows, cols, counts) -> list:
    """[Expected] of frames 0 .. k-1 at each pixel, for each k in
    `counts`."""
    dev = scene.device
    n = len(rows)
    frames = max(counts)
    px = torch.as_tensor(cols, device=dev).repeat(frames)
    py = torch.as_tensor(height - 1 - rows, device=dev).repeat(frames)
    fr = torch.arange(frames, device=dev).repeat_interleave(n)
    out = []
    for s in range(0, px.shape[0], LANE_BLOCK):
        sl = slice(s, s + LANE_BLOCK)
        out.append(scene.trace_frames(settings, view, width, height, px[sl], py[sl], fr[sl]))
    colors = torch.cat(out).reshape(frames, n, 3)
    out = []
    for k in counts:
        spread = colors[:k].double().std(dim=0, correction=min(1, k - 1))
        out.append(Expected(scene.accumulate(colors[:k]).float().cpu().numpy(),
                            (spread / math.sqrt(k)).cpu().numpy()))
    return out


def compare(program, expected: Expected) -> dict:
    program = np.asarray(program, np.float64)
    reference = np.asarray(expected.mean, np.float64)
    diff = np.abs(program - reference)
    within = diff <= PIXEL_ATOL + PIXEL_RTOL * np.abs(reference)
    off = 100.0 * float(np.mean(~within.all(axis=1)))
    rms_ref = math.sqrt(float(np.mean(reference ** 2)))
    rel = math.sqrt(float(np.mean(diff ** 2))) / max(rms_ref, 1e-12)
    over_noise = float(np.sum(diff)) / max(float(np.sum(expected.noise)), 1e-12)
    sums = np.abs(reference.sum(axis=0))
    bias = 100.0 * float(np.max(np.abs((program - reference).sum(axis=0))
                                / np.maximum(sums, 1e-12)))
    return {"err_over_noise": over_noise, "mean_bias_pct": bias, "rel_rmse": rel,
            "px_off_pct": off}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit; a NaN, or a limit not set
    (null), fails."""
    return all(limit is not None and numbers[k] <= limit for k, limit in limits.items())
