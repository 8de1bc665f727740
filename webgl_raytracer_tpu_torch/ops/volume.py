"""Emission/absorption ray march through the nitrogen density volume.

Counterpart of webgl_raytracer_tpu/ops/volume.py (the reference viewer's
in-loop march, webgl.js:1191-1221, and its trilinear 3D texture sample,
:417-421): a ray's segment through the grid's box, clipped to
[max(enter, t_min), min(exit, t_surface)], is marched in steps of
step_size; each step adds emission colour * alpha with alpha =
clamp((1 - exp(-density * density_scale * dt)) * opacity) and scales the
throughput by 1 - alpha, until the throughput falls below 1e-3.

march_volume
    The kernel's wrapper (csrc/volume_march.cu, one thread a ray, on the
    callers' own tensors: march_args), for the
    JAX package's jax.lax.fori_loop at ops/volume.py:95, which XLA runs as
    one device loop: written as tensor operations, each step is some 60
    launches, and a frame marches max_steps (256) steps in every bounce of
    every chunk. Dispatch is by tensor device, as in ops/trace.py: CUDA
    tensors take the kernel (raising when it cannot be built or launched),
    CPU tensors the plain version, and impl="plain" forces the plain one.
march_plain
    The plain version: the JAX masked loop as written. The step position
    is t_enter + i * step_size, never an accumulated t; a lane whose
    throughput falls below 1e-3 inside the segment has it set to 0 and
    stops. After a lane stops, each further step adds exactly +0.0 to its
    radiance (throughput is finite and radiance starts at +0.0) and
    multiplies its throughput by 1, so the kernel's early exit gives the
    same bits.

Vectors are component triples of [N] tensors (ops/vec3.py; on a CUDA
tensor each a contiguous f32 row or one value, which the kernel reads as
they are); active is None or bool [N]; the uniforms (t_min, colour,
density scale, opacity, step, threshold) are 0-d tensors or numbers,
read on the device only, so a frame that marches can be captured. On CPU
tensors exp goes through ops/vec3 (float64, rounded once).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import vec3 as V
from .intersect import intersect_aabb_range
from .trace import _f32, _use_kernel

MAX_STEPS = 1024            # render/config.static_flags caps volume_max_steps here


@dataclass
class VolumeBuffers:
    """Density grid and bounds on one device. data: f32[nz, ny, nx], x
    fastest (the reference's x + y*nx + z*nx*ny layout, volume.js:106-145);
    vmin, vmax f32[3]; max_value f32 0-d."""
    data: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor
    max_value: torch.Tensor
    nx: int = 1
    ny: int = 1
    nz: int = 1

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "VolumeBuffers":
        return VolumeBuffers(self.data.to(device), self.vmin.to(device),
                             self.vmax.to(device), self.max_value.to(device),
                             self.nx, self.ny, self.nz)


def sample_volume_trilinear(vol: VolumeBuffers, pos):
    """Normalised-coordinate trilinear lookup with edge clamping, as GL
    LINEAR / CLAMP_TO_EDGE samples a 3D R32F texture: [N] densities at the
    component-triple positions `pos`."""
    inv_size = 1.0 / torch.clamp_min(vol.vmax - vol.vmin, 1e-12)
    dims = (vol.nx, vol.ny, vol.nz)
    i0, i1, f = [], [], []
    for a in range(3):
        uvw = torch.clamp((pos[a] - vol.vmin[a]) * inv_size[a], 0.0, 1.0)
        # Texel-space coordinate uvw * N - 0.5, clamped to the edge texels.
        xyz = uvw * float(dims[a]) - 0.5
        fl = torch.floor(xyz)
        lo = torch.clamp(fl.to(torch.int64), 0, dims[a] - 1)
        i0.append(lo)
        i1.append(torch.clamp(lo + 1, 0, dims[a] - 1))
        f.append(torch.clamp(xyz - fl, 0.0, 1.0))
    (x0, y0, z0), (x1, y1, z1), (fx, fy, fz) = i0, i1, f
    flat = vol.data.reshape(-1)
    nx, nxy = vol.nx, vol.nx * vol.ny

    def at(z, y, x):
        return flat[z * nxy + y * nx + x]

    c000 = at(z0, y0, x0)
    c100 = at(z0, y0, x1)
    c010 = at(z0, y1, x0)
    c110 = at(z0, y1, x1)
    c001 = at(z1, y0, x0)
    c101 = at(z1, y0, x1)
    c011 = at(z1, y1, x0)
    c111 = at(z1, y1, x1)

    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def march_volume(vol: VolumeBuffers, origin, direction, t_surface, t_min, color,
                 density_scale, opacity, step_size, threshold, throughput, active,
                 max_steps: int, impl=None):
    """March each ray's segment [max(enter, t_min), min(exit, t_surface)].
    Returns (added radiance triple, new throughput triple). origin,
    direction, throughput: triples of [N] tensors; t_surface [N]; active
    bool [N] or None; color f32[3]; the other uniforms 0-d tensors or
    numbers. Lanes outside the segment keep their throughput and add 0."""
    n = t_surface.shape[0]
    if _use_kernel(t_surface, impl):
        return _march_cuda(vol, origin, direction, t_surface, t_min, color,
                           density_scale, opacity, step_size, threshold, throughput,
                           active, max_steps, n)
    return march_plain(vol, origin, direction, t_surface, t_min, color, density_scale,
                       opacity, step_size, threshold, throughput, active, max_steps)


def march_plain(vol: VolumeBuffers, origin, direction, t_surface, t_min, color,
                density_scale, opacity, step_size, threshold, throughput, active,
                max_steps: int, count_steps=False):
    """Plain version of the kernel: the masked loop of the JAX package's
    march_volume, every lane through all max_steps steps. count_steps
    True also returns the lane-steps the kernel runs (lanes alive at a
    step's start, summed over the steps) as a 0-d int64 tensor;
    count_steps "lane" returns each lane's steps instead, int64 [N]."""
    if count_steps not in (False, True, "lane"):
        raise ValueError(f"count_steps must be False, True or 'lane', not {count_steps!r}")
    device = t_surface.device
    t_min, step, density_scale, opacity, threshold = (
        _f32(x, device) for x in (t_min, step_size, density_scale, opacity, threshold))
    color = V.splat(_f32(color, device))
    if active is None:
        active = torch.ones(t_surface.shape, dtype=torch.bool, device=device)
    hit_box, t_enter, t_exit = intersect_aabb_range(vol.vmin, vol.vmax, origin, direction)
    t_enter = torch.maximum(t_enter, t_min)
    t_exit = torch.minimum(t_exit, t_surface)
    run = active & hit_box & (t_exit > t_enter) & (step > 0.0)
    inv_max = 1.0 / torch.clamp_min(vol.max_value, 1e-6)

    zero = torch.zeros_like(t_enter)
    radiance = (zero, zero, zero)
    tp = throughput
    alive = run
    steps = torch.zeros(t_surface.shape, dtype=torch.int64, device=device)
    for i in range(max_steps):
        if count_steps:
            steps = steps + alive
        t_cur = t_enter + step * float(i)
        inside = alive & (t_cur <= t_exit)
        dt = torch.minimum(step, t_exit - t_cur)
        pos = V.add(origin, V.scale(direction, t_cur))
        density = sample_volume_trilinear(vol, pos) * inv_max
        density = torch.clamp_min(density - threshold, 0.0)
        alpha = 1.0 - V.exp(-density * density_scale * dt)
        alpha = torch.clamp(alpha * opacity, 0.0, 1.0)
        alpha = torch.where(inside & (density > 0.0), alpha, 0.0)
        radiance = tuple(radiance[c] + tp[c] * color[c] * alpha for c in range(3))
        tp = tuple(tp[c] * (1.0 - alpha) for c in range(3))
        dead = V.max_component(tp) < 1e-3
        tp = V.where(inside & dead, (zero, zero, zero), tp)
        alive = alive & ~dead & (t_cur + step <= t_exit)
    tp = V.where(run, tp, throughput)
    if count_steps:
        return radiance, tp, steps if count_steps == "lane" else steps.sum()
    return radiance, tp


def march_params(vol: VolumeBuffers, t_min, color, density_scale, opacity, step_size,
                 threshold) -> torch.Tensor:
    """The kernel's params f32[16]: 0-2 vmin, 3-5 vmax, 6 max_value, 7
    t_min, 8-10 colour, 11 density scale, 12 opacity, 13 step, 14
    threshold, 15 unused. Built on the device only (no host value), so a
    captured frame can build it."""
    device = vol.data.device
    scalars = [_f32(x, device).reshape(-1) for x in
               (vol.max_value, t_min, color, density_scale, opacity, step_size,
                threshold)]
    if any(s.numel() != w for s, w in zip(scalars, (1, 1, 3, 1, 1, 1, 1))):
        raise ValueError("the march's t_min, colour and step settings must be one "
                         "value for the whole batch")
    return torch.cat([vol.vmin.reshape(3), vol.vmax.reshape(3), *scalars,
                      torch.zeros(1, dtype=torch.float32, device=device)])


def march_args(vol: VolumeBuffers, origin, direction, t_surface, t_min, color,
               density_scale, opacity, step_size, threshold, throughput, active,
               max_steps: int) -> tuple:
    """The kernel's arguments before its output, each operand
    checked first (ValueError: a ray operand that is neither one f32 value
    nor a contiguous f32 [N] row on the rays' device, an activity mask
    that is not bool [N], a
    grid that is not (nz, ny, nx) f32, max_steps out of range, uniforms
    that are not one value). Tensors stand for their pointers
    (ops/kernels.launch); the rows are the callers' own, nothing is
    staged."""
    from .kernels import check_operand, mask_operand, ray_count, ray_operand

    if not 0 <= max_steps <= MAX_STEPS:
        raise ValueError(f"max_steps must lie in [0, {MAX_STEPS}], not {max_steps}")
    n = ray_count(t_surface.shape[0])
    device = t_surface.device
    names = ("ox", "oy", "oz", "dx", "dy", "dz", "t_surface", "tpx", "tpy", "tpz")
    rows = [v for x, name in zip((*origin, *direction, t_surface, *throughput), names)
            for v in ray_operand(x, n, device, name)]
    check_operand(vol.data, torch.float32, device)
    ray_count(vol.data.numel())     # the kernel indexes the grid with 32-bit ints
    if tuple(vol.data.shape) != (vol.nz, vol.ny, vol.nx):
        raise ValueError(f"volume data {tuple(vol.data.shape)} is not "
                         f"(nz, ny, nx) = {(vol.nz, vol.ny, vol.nx)}")
    params = march_params(vol, t_min, color, density_scale, opacity, step_size, threshold)
    return (*rows, mask_operand(active, n, device), n, params, vol.data, vol.nx, vol.ny,
            vol.nz, int(max_steps))


def _march_cuda(vol, origin, direction, t_surface, t_min, color, density_scale, opacity,
                step_size, threshold, throughput, active, max_steps, n):
    from .kernels import launch

    args = march_args(vol, origin, direction, t_surface, t_min, color, density_scale,
                      opacity, step_size, threshold, throughput, active, max_steps)
    device = t_surface.device
    out = torch.empty((6, n), dtype=torch.float32, device=device)
    if n:
        err = launch("wrt_volume_march", device, *args, out)
        if err != 0:
            raise RuntimeError(f"wrt_volume_march failed: CUDA error {err}")
    return (out[0], out[1], out[2]), (out[3], out[4], out[5])
