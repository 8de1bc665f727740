"""The reference transport: the viewer's progressive path tracer for sphere
scenes, lane by lane. With grid.py it is the sphere kind's reference
(generators/random_spheres.py); camera.py, fmath.py and sky.py are shared
with other kinds' references.

Per pixel and frame a PCG stream seeded from (x, y, frame) draws the
camera jitter, then up to max_bounces bounces: the closest sphere; on a
miss the sky (with MIS after the first bounce) or the ambient colour; the
three cone lights with their shadow rays and MIS; a rim term at the first
hit; the sky's importance-sampled light with its shadow ray and MIS; a
GGX or cosine BRDF sample; Russian roulette from the second bounce. A draw
advances only the lanes whose path reaches it. Radiance is clamped at 100
and scaled by the exposure, and a pixel's frames fold into the running
mean (m * f + c) / (f + 1).

Supported: material mode "metallic", imported colours, shadows on, no
depth of field, no clip plane, no volume, one sample a frame; anything
else raises.
"""

from __future__ import annotations

import math
import numpy as np
import torch

from . import fmath as M
from . import sky as S
from .camera import View
from .grid import BIG, SphereGrid

PI = math.pi
TWO_PI = 2.0 * math.pi
_MUL, _INC, _OUT = 747796405, 2891336453, 277803737
MASK32 = 0xFFFFFFFF
_INV_U32 = 1.0 / 4294967295.0


def _permute(state):
    word = (((state >> ((state >> 28) + 4)) ^ state) * _OUT) & MASK32
    return (word >> 22) ^ word


def init_seed(px, py, frame):
    """pcg(x + y * 65536 + frame * 15485863) in int64 holders."""
    seed = (px + py * 65536 + frame * 15485863) & MASK32
    return _permute((seed * _MUL + _INC) & MASK32)


def rand(state, dtype, mask=None):
    """(next state, a uniform in [0, 1]); lanes outside `mask` keep
    their state."""
    new = (state * _MUL + _INC) & MASK32
    u = (_permute(new).to(torch.float32) * _INV_U32).to(dtype)
    if mask is not None:
        new = torch.where(mask, new, state)
    return new, u


def sphere_bounds(centers, radii):
    """The spheres' world AABB as float32 (lo, hi)."""
    c = np.asarray(centers, np.float32)
    r = np.asarray(radii, np.float32)[:, None]
    return (c - r).min(axis=0), (c + r).max(axis=0)


def _check(settings: dict) -> None:
    unsupported = {"material_mode": "metallic", "use_imported_color": True,
                   "cast_shadows": True, "dof_enabled": False, "clip_enabled": False,
                   "volume_enabled": False, "samples_per_bounce": 1}
    for key, want in unsupported.items():
        if settings[key] != want:
            raise ValueError(f"the reference supports {key}={want!r} only")


class Scene:
    """The spheres, their colours and the sky, on `device` in `dtype`: the
    sphere kind's reference scene, with the interface the check reads
    (closest, trace_frames, accumulate, lo, hi, device, dtype)."""

    def __init__(self, centers, radii, colors, sky: dict | None, device,
                 dtype=torch.float32):
        self.grid = SphereGrid(centers, radii, device, dtype)
        self.color = torch.as_tensor(np.asarray(colors, np.float32), device=device).to(dtype)
        self.lo, self.hi = sphere_bounds(centers, radii)
        self.env = None if sky is None else S.Env(S.sky_image(sky, device), dtype)
        self.device = device
        self.dtype = dtype

    def closest(self, o, d, tmin):
        """[n] index of the closest sphere past tmin, -1 where the ray misses."""
        return self.grid.closest(o, d, tmin)[1]

    def trace_frames(self, settings: dict, view: View, width: int, height: int,
                     px, py, frames) -> torch.Tensor:
        return trace_frames(self, settings, view, width, height, px, py, frames)

    @staticmethod
    def accumulate(colors: torch.Tensor) -> torch.Tensor:
        return accumulate(colors)


def trace_frames(scene: Scene, settings: dict, view: View, width: int, height: int,
                 px, py, frames) -> torch.Tensor:
    """[n, 3] colour of one sample of frame `frames[i]` at pixel (px[i],
    py[i]) (y = 0 the bottom row), exposure applied."""
    _check(settings)
    dt, dev = scene.dtype, scene.device
    s = settings
    n = px.shape[0]

    def full(v):
        return torch.full((n,), float(v), dtype=dt, device=dev)

    state = init_seed(px.long(), py.long(), frames.long())
    state, jx = rand(state, dt)
    state, jy = rand(state, dt)
    # The resolution is a tensor, as the shader's uniform is: on the card a
    # Python-scalar divisor would become a multiply by its reciprocal.
    res = torch.tensor([float(width), float(height)], dtype=dt, device=dev)
    uvx = (px.to(dt) + 0.5 + (jx - 0.5) + 0.5) / res[0] * 2.0 - 1.0
    uvy = (py.to(dt) + 0.5 + (jy - 0.5) + 0.5) / res[1] * 2.0 - 1.0
    f, r, u = view.forward, view.right, view.up
    d = M.norm(tuple(float(f[i]) + uvx * float(r[i]) + uvy * float(u[i]) for i in range(3)))
    o = tuple(full(view.origin[i]) for i in range(3))

    bias = max(view.bias, float(np.float32(1e-4)))
    t_min = full(view.bias)
    zero = torch.zeros(n, dtype=dt, device=dev)
    radiance = [zero.clone(), zero.clone(), zero.clone()]
    throughput = (full(1.0), full(1.0), full(1.0))
    last_pdf = zero.clone()
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    ambient = [float(np.float32(c) * np.float32(s["ambient_intensity"]))
               for c in s["ambient_color"]]
    env = scene.env
    metallic = float(s["metallic"])
    rough = float(s["roughness"])
    grid = scene.grid

    for bounce in range(int(s["max_bounces"])):
        if not bool(alive.any()):
            break
        live = torch.nonzero(alive)[:, 0]
        t = torch.full((n,), BIG, dtype=dt, device=dev)
        row = torch.full((n,), -1, dtype=torch.long, device=dev)
        tl, rl = grid.closest(tuple(x[live] for x in o), tuple(x[live] for x in d), t_min[live])
        t[live], row[live] = tl, rl
        hit = row >= 0

        # A miss takes the sky and the ambient colour.
        env_c = [full(a) for a in ambient]
        mis_w = full(1.0)
        if env is not None:
            er = S.radiance(env, d, float(s["env_intensity"]), float(s["env_max_luminance"]))
            env_c = [env_c[c] + er[c] for c in range(3)]
            if bounce > 0:
                pe = S.pdf(env, d)
                a2, b2 = last_pdf * last_pdf, pe * pe
                mis_w = torch.where(last_pdf > 0.0, a2 / torch.clamp_min(a2 + b2, 1e-8), mis_w)
        miss = alive & ~hit
        for c in range(3):
            radiance[c] = torch.where(miss, radiance[c] + throughput[c] * env_c[c] * mis_w,
                                      radiance[c])
        alive = alive & hit
        if not bool(alive.any()):
            break

        pos = tuple(o[i] + d[i] * t for i in range(3))
        rs = torch.clamp_min(row, 0)
        cen = grid.center[rs]
        n_raw = M.norm(tuple(pos[i] - cen[:, i] for i in range(3)))
        front = M.dot(n_raw, d) < 0.0
        sn = M.where(front, n_raw, tuple(-x for x in n_raw))
        col = scene.color[rs]
        base = (col[:, 0], col[:, 1], col[:, 2])
        v = tuple(-x for x in d)
        shade = alive
        f0 = tuple((1.0 - metallic) * 0.04 + base[c] * metallic for c in range(3))
        spec_w = M.max3(f0)
        diff_w = (1.0 - metallic) * M.max3(base)
        wsum = spec_w + diff_w
        spec_prob = torch.where(wsum > 0.0, spec_w / torch.clamp_min(wsum, 1e-12),
                                torch.full_like(wsum, 0.5))
        shadow_o = tuple(pos[i] + sn[i] * bias for i in range(3))
        shadow_lo = full(max(bias, view.bias))

        # The three cone lights.
        direct = [zero, zero, zero]
        for i, light in enumerate(s["lights"][:3]):
            if not light["enabled"]:
                continue
            state, l1 = rand(state, dt, shade)
            state, l2 = rand(state, dt, shade)
            axis_c = -view.light_dir[i] / np.linalg.norm(view.light_dir[i])
            axis = tuple(full(axis_c[k]) for k in range(3))
            angle = float(np.float32(np.clip(math.radians(light["angle"]), 0.001, math.pi)))
            cos_max = float(np.cos(np.float32(angle)))
            cos_t = cos_max + (1.0 - cos_max) * l1
            sin_t = M.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
            phi = TWO_PI * l2
            ldir = M.to_world(axis, M.cos(phi) * sin_t, M.sin(phi) * sin_t, cos_t)
            l_pdf = 1.0 / max(2.0 * math.pi * (1.0 - cos_max), 1e-6)
            ndl = torch.clamp_min(M.dot(sn, ldir), 0.0)
            cand = shade & (ndl > 0.0)
            lit = cand & ~_any(grid, shadow_o, ldir, t_min, shadow_lo, cand)
            brdf = _brdf(sn, v, ldir, ndl, base, f0, metallic, rough)
            mis = _power(full(l_pdf), _brdf_pdf(sn, v, ldir, rough, spec_prob))
            w = ndl * mis / max(l_pdf, 1e-6) * float(light["intensity"])
            for c in range(3):
                direct[c] = torch.where(lit, direct[c] + brdf[c] * float(light["color"][c]) * w,
                                        direct[c])
        for c in range(3):
            radiance[c] = torch.where(shade, radiance[c] + throughput[c] * direct[c], radiance[c])

        if bounce == 0 and float(s["rim_boost"]) > 0.0:
            ndv = torch.clamp_min(M.dot(sn, v), 0.0)
            rim = M.pow(1.0 - ndv, 3.0) * float(s["rim_boost"])
            for c in range(3):
                radiance[c] = torch.where(shade, radiance[c] + throughput[c] * base[c] * rim,
                                          radiance[c])

        # The sky as a light: an importance-sampled direction and its shadow ray.
        if env is not None:
            state, r1 = rand(state, dt, shade)
            state, r2 = rand(state, dt, shade)
            edir, epdf = S.sample_direction(env, r1, r2)
            ndl_e = M.dot(sn, edir)
            cand = shade & (ndl_e > 0.0)
            open_sky = cand & ~_any(grid, shadow_o, edir, t_min, zero, cand)
            ndl_c = torch.clamp_min(ndl_e, 0.0)
            brdf = _brdf(sn, v, edir, ndl_c, base, f0, metallic, rough)
            erad = S.radiance(env, edir, float(s["env_intensity"]), float(s["env_max_luminance"]))
            mis = _power(epdf, _brdf_pdf(sn, v, edir, rough, spec_prob))
            w = ndl_c * mis / torch.clamp_min(epdf, 1e-6)
            contrib = tuple(throughput[c] * brdf[c] * erad[c] * w for c in range(3))
            mx = M.max3(contrib)
            k = torch.where(mx > 20.0, 20.0 / torch.clamp_min(mx, 1e-12), torch.ones_like(mx))
            for c in range(3):
                radiance[c] = torch.where(open_sky, radiance[c] + contrib[c] * k, radiance[c])

        # The next direction: a GGX or a cosine sample.
        lobe_prob = torch.clamp(torch.where(wsum > 0.0, spec_w / torch.clamp_min(wsum, 1e-12),
                                            torch.ones_like(wsum)), 0.0, 1.0)
        state, r_lobe = rand(state, dt, shade)
        state, s1 = rand(state, dt, shade)
        state, s2 = rand(state, dt, shade)
        choose_spec = shade & (r_lobe < lobe_prob)
        a2 = (rough * rough) * (rough * rough)
        phi = TWO_PI * s1
        cos_t = M.sqrt((1.0 - s2) / (1.0 + (a2 - 1.0) * s2))
        sin_t = M.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        h = M.to_world(sn, M.cos(phi) * sin_t, M.sin(phi) * sin_t, cos_t)
        dh = M.dot(d, h)
        spec_dir = M.norm(tuple(d[i] - 2 * dh * h[i] for i in range(3)))
        ndl_s = torch.clamp_min(M.dot(sn, spec_dir), 0.0)
        ndv = torch.clamp_min(M.dot(sn, v), 0.001)
        ndh = torch.clamp_min(M.dot(sn, h), 0.001)
        vdh = torch.clamp_min(M.dot(v, h), 0.001)
        fr = _fresnel(vdh, f0)
        kw = _smith(ndv, ndl_s, rough) * vdh / (ndv * ndh * torch.clamp_min(lobe_prob, 0.01))
        spec_weight = M.scale(fr, kw)
        spec_pdf = lobe_prob * _ggx(ndh, rough) * ndh / (4.0 * vdh)
        cos_d = M.sqrt(1.0 - s2)
        sin_d = M.sqrt(s2)
        diff_dir = M.to_world(sn, M.cos(phi) * sin_d, M.sin(phi) * sin_d, cos_d)
        ndl_d = torch.clamp_min(M.dot(sn, diff_dir), 0.0)
        kd = (1.0 - metallic) * PI / torch.clamp_min(1.0 - lobe_prob, 0.01)
        diff_weight = tuple(base[c] / PI * kd for c in range(3))
        diff_pdf = (1.0 - lobe_prob) * ndl_d / PI
        new_dir = M.where(choose_spec, spec_dir, diff_dir)
        weight = M.where(choose_spec, spec_weight, diff_weight)
        dead_spec = choose_spec & (ndl_s <= 0.0)

        throughput = M.where(shade, tuple(throughput[c] * weight[c] for c in range(3)),
                             throughput)
        mx = M.max3(throughput)
        k = torch.where(shade & (mx > 10.0), 10.0 / torch.clamp_min(mx, 1e-12),
                        torch.ones_like(mx))
        throughput = M.scale(throughput, k)
        o = M.where(shade, shadow_o, o)
        d = M.where(shade, new_dir, d)
        last_pdf = torch.where(shade, torch.where(choose_spec, spec_pdf, diff_pdf), last_pdf)

        survivor = shade & ~dead_spec
        if bounce >= 1:
            state, rr = rand(state, dt, survivor)
            p = torch.clamp(mx * k, 0.05, 0.95)
            boost = torch.where(survivor, 1.0 / p, torch.ones_like(p))
            throughput = M.scale(throughput, boost)
            survivor = survivor & ~(rr > p)
        alive = survivor

    exposure = float(s["exposure"])
    return torch.stack([torch.clamp_max(x, 100.0) * exposure for x in radiance], dim=-1)


def _any(grid, o, d, t_min, lo, mask):
    """Occlusion of the masked lanes' rays for lo < t < BIG."""
    out = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    live = torch.nonzero(mask)[:, 0]
    if live.numel():
        hi = torch.full((live.numel(),), BIG, dtype=o[0].dtype, device=o[0].device)
        out[live] = grid.any_hit(tuple(x[live] for x in o), tuple(x[live] for x in d),
                                 t_min[live], lo[live], hi)
    return out


def _ggx(ndh, rough):
    a2 = (rough * rough) * (rough * rough)
    den = (ndh * ndh) * (a2 - 1.0) + 1.0
    return a2 / (PI * den * den + 1e-6)


def _schlick(ndv, rough):
    k = (rough + 1.0) * (rough + 1.0) / 8.0
    return ndv / (ndv * (1.0 - k) + k + 0.0001)


def _smith(ndv, ndl, rough):
    return _schlick(ndv, rough) * _schlick(ndl, rough)


def _fresnel(cos_t, f0):
    w = M.pow(torch.clamp(1.0 - cos_t, 0.0, 1.0), 5.0)
    return tuple(f0[c] + (1.0 - f0[c]) * w for c in range(3))


def _power(pa, pb):
    a2, b2 = pa * pa, pb * pb
    return a2 / torch.clamp_min(a2 + b2, 1e-8)


def _brdf(n, v, ldir, ndl, base, f0, metallic, rough):
    """GGX specular plus Lambert diffuse, weighted by 1 - Fresnel."""
    h = M.norm(tuple(v[i] + ldir[i] for i in range(3)))
    ndv = torch.clamp_min(M.dot(n, v), 0.001)
    ndh = torch.clamp_min(M.dot(n, h), 0.001)
    vdh = torch.clamp_min(M.dot(v, h), 0.001)
    fr = _fresnel(vdh, f0)
    kspec = _ggx(ndh, rough) * _smith(ndv, ndl, rough) / torch.clamp_min(4.0 * ndv * ndl, 0.001)
    return tuple(fr[c] * kspec + base[c] / PI * (1.0 - metallic) * (1.0 - fr[c])
                 for c in range(3))


def _brdf_pdf(n, v, ldir, rough, spec_prob):
    ndl = torch.clamp_min(M.dot(n, ldir), 0.0)
    h = M.norm(tuple(v[i] + ldir[i] for i in range(3)))
    ndh = torch.clamp_min(M.dot(n, h), 0.001)
    vdh = torch.clamp_min(M.dot(v, h), 0.001)
    pdf = spec_prob * (_ggx(ndh, rough) * ndh / (4.0 * vdh)) + (1.0 - spec_prob) * (ndl / PI)
    return torch.where(ndl > 0.0, pdf, torch.zeros_like(pdf))


def accumulate(colors: torch.Tensor) -> torch.Tensor:
    """[frames, n, 3] -> the running mean after the last frame."""
    acc = colors[0]
    for f in range(1, colors.shape[0]):
        fi = torch.tensor(float(f), dtype=colors.dtype, device=colors.device)
        acc = (acc * fi + colors[f]) / (fi + 1.0)
    return acc
