"""The reference transport of the molecule kind: tracer.py's lane-by-lane
path tracer over spheres, capped cylinders and triangles (prims.py's
grid), with upstream's surface-glass material.

Per pixel and frame a PCG stream seeded from (x, y, frame) draws the
camera jitter, then up to max_bounces bounces:
  - the closest primitive; on a miss the sky (with MIS after the first
    bounce, unless the last bounce transmitted: last_pdf 0) or the
    ambient colour;
  - the surface: a sphere's normal from its centre, a cylinder's from its
    axis or its cap (the cap when the hit's height along the axis falls
    outside the body), a triangle's geometric normal from its edges; the
    normal faces the ray (front when it met the ray); a triangle shades
    with its vertex normals interpolated by the hit's barycentrics,
    turned to the geometric normal's side;
  - surface-glass (webgl.js:1752-1763; the program's
    render/integrator.py transmission): four draws (opacity, lobe, two
    unused by glass); a triangle hit transmits where the opacity draw is
    at or above surface_opacity: reflect with the Schlick Fresnel of the
    IOR (always where it cannot refract), else refract (eta 1/ior
    entering, ior leaving) and tint the throughput by mix(1, colour,
    surface_transmission); the ray leaves the surface on the chosen side,
    last_pdf 0, and the transmitting lane skips the lights, env NEE, the
    BRDF sample and roulette in this bounce;
  - the three cone lights with their shadow rays and MIS; in the metallic
    mode the rim term at the first hit (no rim in the glass mode); the
    sky's importance-sampled light with its shadow ray and MIS; a GGX or
    cosine BRDF sample (the glass mode's opaque hits: metallic 0, f0 0.04);
    the throughput clamp; Russian roulette from the second bounce on the
    shaded lanes.
Every draw is taken for every lane alive at the bounce's hit, in the
program's order (glass, lights, env NEE, lobe and direction, roulette).
Radiance is clamped at 100 and scaled by the exposure.

Departures from upstream's shader, as the program has them: upstream's
SES normals come from its own marching cubes (this reference's SES is
models' algorithm, reference/molecule.py); no depth of field, clip plane
or volume; one sample a frame; surface_flag_mode 0 (every triangle is
glass). Other settings raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fmath as M
from . import sky as S
from . import tracer as T
from .camera import View
from .grid import BIG
from .prims import PrimGrid, bounds

MODES = ("metallic", "surface-glass")


def _check(settings: dict) -> None:
    if settings["material_mode"] not in MODES:
        raise ValueError(f"the reference supports material_mode in {MODES} only")
    unsupported = {"use_imported_color": True, "cast_shadows": True, "dof_enabled": False,
                   "clip_enabled": False, "volume_enabled": False, "samples_per_bounce": 1}
    if settings["material_mode"] == "surface-glass":
        unsupported["surface_flag_mode"] = 0
    for key, want in unsupported.items():
        if settings[key] != want:
            raise ValueError(f"the reference supports {key}={want!r} only")


class Scene:
    """A molecule's primitives and the sky, on `device` in `dtype`, with
    the interface the check reads (closest, trace_frames, accumulate, lo,
    hi, device, dtype). geometry: reference/molecule.scene_geometry's
    dict."""

    def __init__(self, geometry: dict, sky: dict | None, device, dtype=torch.float32):
        g = geometry
        spheres = (g["sphere_centers"], g["sphere_radii"])
        cylinders = (g["cyl_p1"], g["cyl_p2"], g["cyl_radii"])
        self.grid = PrimGrid(spheres, cylinders, g["tri_verts"], device, dtype)
        self.lo, self.hi = bounds(spheres, cylinders, np.asarray(g["tri_verts"], np.float32))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)

        self.color = torch.cat([t(g["tri_colors"]).reshape(-1, 3),
                                t(g["sphere_colors"]).reshape(-1, 3),
                                t(g["cyl_colors"]).reshape(-1, 3)])
        self.tri_normals = t(g["tri_normals"]).reshape(-1, 3, 3)
        self.env = None if sky is None else S.Env(S.sky_image(sky, device), dtype)
        self.device = device
        self.dtype = dtype

    def closest(self, o, d, tmin):
        """[n] global id of the closest primitive past tmin, -1 on a miss."""
        return self.grid.closest(o, d, tmin)[1]

    def trace_frames(self, settings: dict, view: View, width: int, height: int,
                     px, py, frames) -> torch.Tensor:
        return trace_frames(self, settings, view, width, height, px, py, frames)

    @staticmethod
    def accumulate(colors: torch.Tensor) -> torch.Tensor:
        return T.accumulate(colors)


def _surface(scene: Scene, gid, o, d, t):
    """(pos, geometric normal facing the ray, shading normal, base colour,
    front, is triangle) at the lanes' hits."""
    grid = scene.grid
    nt, ns, nc = grid.counts
    pos = tuple(o[i] + d[i] * t for i in range(3))
    zero = torch.zeros_like(t)
    n_raw = (zero, zero, zero)
    is_tri = gid < nt
    is_sph = (gid >= nt) & (gid < nt + ns)
    is_cyl = gid >= nt + ns
    if ns:
        c = grid.sph_c[torch.clamp(gid - nt, 0, ns - 1)]
        n_sph = M.norm(tuple(pos[i] - c[:, i] for i in range(3)))
        n_raw = M.where(is_sph, n_sph, n_raw)
    if nc:
        k = torch.clamp(gid - nt - ns, 0, nc - 1)
        p1, p2 = grid.cyl_p1[k], grid.cyl_p2[k]
        av = tuple(p2[:, i] - p1[:, i] for i in range(3))
        height = M.sqrt(M.dot(av, av))
        degen = height < 1e-6
        a = M.scale(av, 1.0 / torch.where(degen, torch.ones_like(height), height))
        rel = tuple(pos[i] - p1[:, i] for i in range(3))
        h = M.dot(rel, a)
        cap = torch.where(h < 0.0, 1, torch.where(h > height, 2, 0))
        cap = torch.where(degen, 0, cap)
        side = tuple(pos[i] - (p1[:, i] + a[i] * h) for i in range(3))
        n_cyl = M.where(cap == 1, rel, M.where(cap == 2, tuple(pos[i] - p2[:, i]
                                                               for i in range(3)), side))
        n_raw = M.where(is_cyl, M.norm(n_cyl), n_raw)
    shading_tri = None
    if nt:
        k = torch.clamp(gid, 0, nt - 1)
        tri = grid.tri[k]
        v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        e1 = tuple(v1[:, i] - v0[:, i] for i in range(3))
        e2 = tuple(v2[:, i] - v0[:, i] for i in range(3))
        n_raw = M.where(is_tri, M.norm(M.cross(e1, e2)), n_raw)
        u, v, _, _ = PrimGrid.triangle_uvt(o, d, v0, v1, v2)
        tn = scene.tri_normals[k]
        b0 = 1.0 - u - v
        shading_tri = M.norm(tuple(b0 * tn[:, 0, i] + u * tn[:, 1, i] + v * tn[:, 2, i]
                                   for i in range(3)))
    front = M.dot(n_raw, d) < 0.0
    n_geom = M.where(front, n_raw, tuple(-x for x in n_raw))
    sn = n_geom
    if shading_tri is not None:
        flip = M.dot(shading_tri, n_geom) < 0.0
        tri_sn = M.where(flip, tuple(-x for x in shading_tri), shading_tri)
        sn = M.where(is_tri, tri_sn, n_geom)
    col = scene.color[torch.clamp_min(gid, 0)]
    return pos, n_geom, sn, (col[:, 0], col[:, 1], col[:, 2]), front, is_tri


def trace_frames(scene: Scene, settings: dict, view: View, width: int, height: int,
                 px, py, frames) -> torch.Tensor:
    """[n, 3] colour of one sample of frame `frames[i]` at pixel (px[i],
    py[i]) (y = 0 the bottom row), exposure applied."""
    _check(settings)
    dt, dev = scene.dtype, scene.device
    s = settings
    glass = s["material_mode"] == "surface-glass"
    n = px.shape[0]

    def full(v):
        return torch.full((n,), float(v), dtype=dt, device=dev)

    rand = T.rand
    state = T.init_seed(px.long(), py.long(), frames.long())
    state, jx = rand(state, dt)
    state, jy = rand(state, dt)
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
    metallic = 0.0 if glass else float(s["metallic"])
    rough = float(s["roughness"])
    ior = max(float(np.float32(s["surface_ior"])), 1e-3)
    f0s = float(((np.float32(s["surface_ior"]) - np.float32(1.0))
                 / (np.float32(s["surface_ior"]) + np.float32(1.0))) ** 2)
    grid = scene.grid

    for bounce in range(int(s["max_bounces"])):
        if not bool(alive.any()):
            break
        live = torch.nonzero(alive)[:, 0]
        t = torch.full((n,), BIG, dtype=dt, device=dev)
        gid = torch.full((n,), -1, dtype=torch.long, device=dev)
        tl, gl = grid.closest(tuple(x[live] for x in o), tuple(x[live] for x in d), t_min[live])
        t[live], gid[live] = tl, gl
        hit = gid >= 0

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

        pos, n_geom, sn, base, front, is_tri = _surface(scene, gid, o, d, t)
        v = tuple(-x for x in d)
        drawn = alive

        # Glass: the opacity, lobe and two spare draws, then transmission.
        transmit = torch.zeros_like(alive)
        if glass:
            state, r_op = rand(state, dt, drawn)
            state, r_ref = rand(state, dt, drawn)
            state, _ = rand(state, dt, drawn)
            state, _ = rand(state, dt, drawn)
            transmit = alive & is_tri & (r_op >= float(s["surface_opacity"]))
            cosi = torch.clamp(-M.dot(d, n_geom), 0.0, 1.0)
            fres = f0s + (1.0 - f0s) * M.pow(torch.clamp(1.0 - cosi, 0.0, 1.0), 5.0)
            eta = torch.where(front, torch.full_like(cosi, 1.0 / ior), torch.full_like(cosi, ior))
            sin2 = eta * eta * (1.0 - cosi * cosi)
            can = sin2 <= 1.0
            cost = M.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
            kk = eta * cosi - cost
            refr = tuple(eta * d[i] + kk * n_geom[i] for i in range(3))
            reflect_prob = torch.where(can, fres, torch.ones_like(fres))
            do_reflect = r_ref < reflect_prob
            dn = M.dot(d, n_geom)
            refl_dir = M.norm(tuple(d[i] - 2.0 * dn * n_geom[i] for i in range(3)))
            new_dir = M.where(do_reflect, refl_dir, M.norm(refr))
            new_origin = M.where(do_reflect, tuple(pos[i] + n_geom[i] * bias for i in range(3)),
                                 tuple(pos[i] - n_geom[i] * bias for i in range(3)))
            tr = float(s["surface_transmission"])
            tint = tuple(1.0 * (1.0 - tr) + base[c] * tr for c in range(3))
            tinted = transmit & ~do_reflect
            throughput = M.where(tinted, tuple(throughput[c] * tint[c] for c in range(3)),
                                 throughput)
            o = M.where(transmit, new_origin, o)
            d = M.where(transmit, new_dir, d)
            last_pdf = torch.where(transmit, torch.zeros_like(last_pdf), last_pdf)
        shade = alive & ~transmit

        f0 = tuple((1.0 - metallic) * 0.04 + base[c] * metallic for c in range(3))
        spec_w = M.max3(f0)
        diff_w = (1.0 - metallic) * M.max3(base)
        wsum = spec_w + diff_w
        spec_prob = torch.where(wsum > 0.0, spec_w / torch.clamp_min(wsum, 1e-12),
                                torch.full_like(wsum, 0.5))
        shadow_o = tuple(pos[i] + n_geom[i] * bias for i in range(3))
        shadow_lo = full(max(bias, view.bias))

        # The three cone lights.
        direct = [zero, zero, zero]
        for i, light in enumerate(s["lights"][:3]):
            if not light["enabled"]:
                continue
            state, l1 = rand(state, dt, drawn)
            state, l2 = rand(state, dt, drawn)
            axis_c = -view.light_dir[i] / np.linalg.norm(view.light_dir[i])
            axis = tuple(full(axis_c[k]) for k in range(3))
            angle = float(np.float32(np.clip(math.radians(light["angle"]), 0.001, math.pi)))
            cos_max = float(np.cos(np.float32(angle)))
            cos_t = cos_max + (1.0 - cos_max) * l1
            sin_t = M.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
            phi = T.TWO_PI * l2
            ldir = M.to_world(axis, M.cos(phi) * sin_t, M.sin(phi) * sin_t, cos_t)
            l_pdf = 1.0 / max(2.0 * math.pi * (1.0 - cos_max), 1e-6)
            ndl = torch.clamp_min(M.dot(sn, ldir), 0.0)
            cand = shade & (ndl > 0.0)
            lit = cand & ~T._any(grid, shadow_o, ldir, t_min, shadow_lo, cand)
            brdf = T._brdf(sn, v, ldir, ndl, base, f0, metallic, rough)
            mis = T._power(full(l_pdf), T._brdf_pdf(sn, v, ldir, rough, spec_prob))
            w = ndl * mis / max(l_pdf, 1e-6) * float(light["intensity"])
            for c in range(3):
                direct[c] = torch.where(lit, direct[c] + brdf[c] * float(light["color"][c]) * w,
                                        direct[c])
        for c in range(3):
            radiance[c] = torch.where(shade, radiance[c] + throughput[c] * direct[c], radiance[c])

        if not glass and bounce == 0 and float(s["rim_boost"]) > 0.0:
            ndv = torch.clamp_min(M.dot(sn, v), 0.0)
            rim = M.pow(1.0 - ndv, 3.0) * float(s["rim_boost"])
            for c in range(3):
                radiance[c] = torch.where(shade, radiance[c] + throughput[c] * base[c] * rim,
                                          radiance[c])

        # The sky as a light: an importance-sampled direction and its shadow ray.
        if env is not None:
            state, r1 = rand(state, dt, drawn)
            state, r2 = rand(state, dt, drawn)
            edir, epdf = S.sample_direction(env, r1, r2)
            ndl_e = M.dot(sn, edir)
            cand = shade & (ndl_e > 0.0)
            open_sky = cand & ~T._any(grid, shadow_o, edir, t_min, zero, cand)
            ndl_c = torch.clamp_min(ndl_e, 0.0)
            brdf = T._brdf(sn, v, edir, ndl_c, base, f0, metallic, rough)
            erad = S.radiance(env, edir, float(s["env_intensity"]), float(s["env_max_luminance"]))
            mis = T._power(epdf, T._brdf_pdf(sn, v, edir, rough, spec_prob))
            w = ndl_c * mis / torch.clamp_min(epdf, 1e-6)
            contrib = tuple(throughput[c] * brdf[c] * erad[c] * w for c in range(3))
            mx = M.max3(contrib)
            k = torch.where(mx > 20.0, 20.0 / torch.clamp_min(mx, 1e-12), torch.ones_like(mx))
            for c in range(3):
                radiance[c] = torch.where(open_sky, radiance[c] + contrib[c] * k, radiance[c])

        # The next direction: a GGX or a cosine sample.
        lobe_prob = torch.clamp(torch.where(wsum > 0.0, spec_w / torch.clamp_min(wsum, 1e-12),
                                            torch.ones_like(wsum)), 0.0, 1.0)
        state, r_lobe = rand(state, dt, drawn)
        state, s1 = rand(state, dt, drawn)
        state, s2 = rand(state, dt, drawn)
        choose_spec = shade & (r_lobe < lobe_prob)
        a2 = (rough * rough) * (rough * rough)
        phi = T.TWO_PI * s1
        cos_t = M.sqrt((1.0 - s2) / (1.0 + (a2 - 1.0) * s2))
        sin_t = M.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        h = M.to_world(sn, M.cos(phi) * sin_t, M.sin(phi) * sin_t, cos_t)
        dh = M.dot(d, h)
        spec_dir = M.norm(tuple(d[i] - 2 * dh * h[i] for i in range(3)))
        ndl_s = torch.clamp_min(M.dot(sn, spec_dir), 0.0)
        ndv = torch.clamp_min(M.dot(sn, v), 0.001)
        ndh = torch.clamp_min(M.dot(sn, h), 0.001)
        vdh = torch.clamp_min(M.dot(v, h), 0.001)
        fr = T._fresnel(vdh, f0)
        kw = T._smith(ndv, ndl_s, rough) * vdh / (ndv * ndh * torch.clamp_min(lobe_prob, 0.01))
        spec_weight = M.scale(fr, kw)
        spec_pdf = lobe_prob * T._ggx(ndh, rough) * ndh / (4.0 * vdh)
        cos_d = M.sqrt(1.0 - s2)
        sin_d = M.sqrt(s2)
        diff_dir = M.to_world(sn, M.cos(phi) * sin_d, M.sin(phi) * sin_d, cos_d)
        ndl_d = torch.clamp_min(M.dot(sn, diff_dir), 0.0)
        kd = (1.0 - metallic) * T.PI / torch.clamp_min(1.0 - lobe_prob, 0.01)
        diff_weight = tuple(base[c] / T.PI * kd for c in range(3))
        diff_pdf = (1.0 - lobe_prob) * ndl_d / T.PI
        new_dir = M.where(choose_spec, spec_dir, diff_dir)
        weight = M.where(choose_spec, spec_weight, diff_weight)
        dead_spec = choose_spec & (ndl_s <= 0.0)

        throughput = M.where(shade, tuple(throughput[c] * weight[c] for c in range(3)),
                             throughput)
        mx = M.max3(throughput)
        k = torch.where(mx > 10.0, 10.0 / torch.clamp_min(mx, 1e-12), torch.ones_like(mx))
        throughput = M.scale(throughput, k)
        o = M.where(shade, shadow_o, o)
        d = M.where(shade, new_dir, d)
        last_pdf = torch.where(shade, torch.where(choose_spec, spec_pdf, diff_pdf), last_pdf)

        survivor = shade & ~dead_spec
        if bounce >= 1:
            state, rr = rand(state, dt, drawn)
            p = torch.clamp(M.max3(throughput), 0.05, 0.95)
            boost = torch.where(survivor, 1.0 / p, torch.ones_like(p))
            throughput = M.scale(throughput, boost)
            survivor = survivor & ~(rr > p)
        alive = transmit | survivor

    exposure = float(s["exposure"])
    return torch.stack([torch.clamp_max(x, 100.0) * exposure for x in radiance], dim=-1)

