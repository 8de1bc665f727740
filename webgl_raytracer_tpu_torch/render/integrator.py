"""The path-tracing integrator and its transports.

Counterpart of webgl_raytracer_tpu/render/integrator.py. One bounce step
(_make_bounce_step) runs over a flat batch of rays, dead paths masked out
of traversal and shading. Per bounce:

  closest hit (ops/trace kernel) -> volume march (ops/volume kernel) ->
  environment / ambient on miss with MIS -> surface reconstruction by
  primitive type -> glass/translucent stochastic transmission -> 3 cone
  lights with the fused 3-direction shadow fan and MIS -> env NEE
  (CDF-sampled direction, occlusion, MIS) -> GGX/cosine BRDF sample ->
  Russian roulette.

Per-ray vectors are component triples of [B] tensors (ops/vec3.py) and
RNG draws stay in the reference's order, so a frame matches the JAX
package's frame sample for sample up to f32 rounding.

_sample_radiance chooses how a frame's rays go through the bounces, as
the JAX package does:

  whole batch   one chunk (_chunk_count: frames under 2 x CHUNK_TARGET
                rays, or WRT_CHUNKS=1): every ray through every bounce;
  permuted      (_run_permuted) primaries traced full width, rays moved
                hit-first in 32-ray blocks, then the bounces chunk by
                chunk.
                With WRT_ATTRS=1 (_use_attrs) the traces return the
                winner's attribute row (ops/trace.trace_closest_attrs) and
                the rows ride through the permutation instead of the slot;
  binned        (_binned_transport, the default where the kernels run;
                not for volume frames)
                primary hits packed live-first into a buffer of n/12
                lanes, the bounces run over the whole buffer (dead lanes at
                its tail), re-packed by a coherence key (direction octant x
                origin cell) after each bounce but the last; radiance
                returns to pixel order once at the end.
                A frame with more live rays than the buffer holds is
                flagged on the device; its caller redoes it through the
                permuted transport. WRT_BINNED=0 turns it off.

Each transport is a permutation of the same per-lane computation, so all
give the same frame bit for bit (per-ray results do not depend on
batching).

render_visualization draws the debug views (vis modes 1-3) from the
pixel rays' closest hits: normals, a heatmap of the trace's count
(ops/trace.py, "Counts") and depth.

The tracers (_closest_hit, _any_hit), as the JAX package dispatches them:
flags.tracer "wavefront" takes the cluster tracer (ops/wavefront.py, the
kernels of ops/trace.py), and with use_bvh=False its brute sweep
(force_dense); "stack" takes the BVH walk (ops/traversal.py, the
trace_stack kernels). The stack walk and the brute sweep shoot the
3-light shadow fan as one concatenated any-hit batch of the enabled
lights' rays (the culled cluster tracer fuses it: trace_any3), never take
the binned transport or the attrs rows, and a stack hit's rows, colour
and triangle normals come from the unified table (walk_tables) its slot
indexes.

No host reads. Where the JAX package skips work with
`lax.cond(jnp.any(mask))`, this module runs the masked work anyway: a
trace with no active lane returns the miss record, and shading a batch
with no live lane adds 0.0 to every radiance, so the frame is the same
bit for bit. The over-cap test of the binned buffer is a device flag. So
on the kernels a frame (render_batch_flagged) reads nothing back to the
host and can be captured as a CUDA graph (render/frame.py); the plain
traces of ops/trace.py keep their host syncs and are never captured.
render_batch_stats is the eager contract: it reads the flag once and
redoes a flagged frame through the permuted transport.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import brdf as B
from ..ops import sampling as S
from ..ops import traversal as ST
from ..ops import vec3 as V
from ..ops.envmap import env_pdf_v3, sample_env_direction_v3, sample_env_radiance_v3
from ..ops.rng import init_seed, rand, rand2
from ..ops.trace import attr_slot, kernel_supported
from ..ops.volume import march_volume
from ..ops.wavefront import (HitRecord, _finalize_hit, wf_trace_any3_v3,
                             wf_trace_any_v3, wf_trace_closest_v3)
from ..scene.bvh import PRIM_CYLINDER, PRIM_SPHERE, PRIM_TRIANGLE
from ..utils import telemetry
from . import compact as CP

BIG = float(np.float32(1e20))
RADIANCE_CLAMP = 100.0
NEE_CLAMP = 20.0
THROUGHPUT_CLAMP = 10.0


def _no_stage(name, level):
    pass


def _no_end(level):
    pass


def _marks():
    """The recorder's (stage, end, stage_next) marks of the frame's device
    spans (utils/telemetry.py), or no-ops while it is off. Level 1 is a
    stage of the frame (frame.head, bounce[b], frame.tail), level 2 one of
    its parts; a bounce opens at its first part's mark (stage_next)."""
    rec = telemetry.recorder
    if rec is None:
        return _no_stage, _no_end, _no_stage
    return rec.stage, rec.end, rec.stage_next


def _clip_tuple(flags, u):
    if not flags.clip_enabled:
        return None
    return (u.clip_normal, u.clip_offset, u.clip_side)


# The environment knobs the transports read while a frame is traced; a
# captured frame bakes their values in (render/frame.py keys on them).
TRANSPORT_KNOBS = ("WRT_CHUNKS", "WRT_BINNED", "WRT_BIN_CAP_DIV", "WRT_ATTRS")


def _use_attrs(scene, flags) -> bool:
    """Shade from the attrs kernel's winner rows instead of gathering
    after the trace (WRT_ATTRS=1; off by default, as in the JAX package,
    which measured it slower on its TPU), on the culled cluster tracer
    only. Frames are the same bit for bit either way."""
    return (os.environ.get("WRT_ATTRS") == "1" and _cluster_tracer(flags)
            and kernel_supported(scene))


def _cluster_tracer(flags) -> bool:
    """The culled cluster tracer, the one the fused fan, the binned
    transport and the attrs rows belong to."""
    return flags.tracer == "wavefront" and flags.use_bvh


def _closest_hit(scene, flags, o3, d3, t_min, clip, active=None, full_record=True,
                 with_attrs=False, secondary=False, impl=None, with_cost=False):
    """The tracer dispatch (the JAX package's _closest_hit): the cluster
    tracer, its brute sweep under use_bvh=False, or the stack walk, whose
    record always carries its count."""
    if flags.tracer == "wavefront":
        return wf_trace_closest_v3(scene, o3, d3, t_min, clip, active=active,
                                   secondary=secondary, full_record=full_record,
                                   with_attrs=with_attrs, impl=impl, with_cost=with_cost,
                                   force_dense=not flags.use_bvh)
    return ST.trace_closest(scene, o3, d3, t_min, clip, active=active, impl=impl)


def _any_hit(scene, flags, o3, d3, t_min, clip, accept_min=None, t_max=BIG, active=None,
             divergent=False, impl=None):
    """Occlusion through the flags' tracer (the JAX package's _any_hit)."""
    if flags.tracer == "wavefront":
        return wf_trace_any_v3(scene, o3, d3, t_min, t_max=t_max, accept_min=accept_min,
                               clip=clip, active=active, divergent=divergent, impl=impl,
                               force_dense=not flags.use_bvh)
    return ST.trace_any(scene, o3, d3, t_min, t_max=t_max, accept_min=accept_min,
                        clip=clip, active=active, impl=impl)


def _cylinder_normal_v3(pos, p1, p2, hit_type):
    axis = V.sub(p2, p1)
    axis = V.scale(axis, 1.0 / torch.clamp_min(V.length(axis), 1e-12))
    h = V.dot(V.sub(pos, p1), axis)
    side = V.sub(pos, V.add(p1, V.scale(axis, h)))
    n = V.where(hit_type == 1.0, V.sub(pos, p1),
                V.where(hit_type == 2.0, V.sub(pos, p2), side))
    return V.normalize(n)


def _tri_index(scene, rec):
    """Per-lane index into the triangle side tables. Non-triangle hits
    carry their own type's local index, so it is clamped into range (as
    the JAX package's gathers clamp); those lanes never use the value."""
    return torch.clamp(rec.prim_local, 0, scene.tri_normals.shape[0] - 1).long()


def _surface_attributes(scene, flags, rec, pos, direction, u, attrs=None):
    """Geometric/shading normals + base colour at the hit, by primitive
    type: (n_geom, shading normal, base colour, front-facing).

    attrs: the winners' attribute rows (ops/trace.attr_operand layout);
    they replace every gather here (cluster row, colour, vertex normals)
    with the same values. A stack hit's slot indexes the unified table
    (the JAX package's _fetch_hit_rows)."""
    ptype = rec.prim_type
    slot = torch.clamp_min(rec.prim_slot, 0).long()
    if attrs is not None:
        row = attrs
        imported_color = (attrs[:, 12], attrs[:, 13], attrs[:, 14])
    elif flags.tracer == "wavefront":
        row = scene.cluster_prims.reshape(-1, 12)[slot]
        imported_color = V.from_array(scene.cluster_color[slot])
    else:
        tables = scene.walk_tables
        row = torch.cat([tables.prim_a[slot], tables.prim_b[slot], tables.prim_c[slot]],
                        dim=1)
        imported_color = V.from_array(tables.prim_color[slot])
    pa = (row[:, 0], row[:, 1], row[:, 2])
    pb = (row[:, 4], row[:, 5], row[:, 6])
    pc = (row[:, 8], row[:, 9], row[:, 10])

    zero = torch.zeros_like(pos[0])
    n_raw = (zero, zero, zero)

    if scene.sphere_count:
        n_sph = V.normalize(V.sub(pos, pa))
        n_raw = V.where(ptype == PRIM_SPHERE, n_sph, n_raw)

    if scene.cylinder_count:
        n_cyl = _cylinder_normal_v3(pos, pa, pb, rec.extra[..., 0])
        n_raw = V.where(ptype == PRIM_CYLINDER, n_cyl, n_raw)

    tri_shading = None
    if scene.tri_count:
        n_tri = V.normalize(V.cross(V.sub(pb, pa), V.sub(pc, pa)))
        n_raw = V.where(ptype == PRIM_TRIANGLE, n_tri, n_raw)
        if attrs is None:
            tn = scene.tri_normals[_tri_index(scene, rec)].reshape(-1, 9)  # gather
        else:
            tn = attrs[:, 15:24]
        tn0 = (tn[:, 0], tn[:, 1], tn[:, 2])
        tn1 = (tn[:, 3], tn[:, 4], tn[:, 5])
        tn2 = (tn[:, 6], tn[:, 7], tn[:, 8])
        bu = rec.extra[..., 0]
        bv = rec.extra[..., 1]
        b0 = 1.0 - bu - bv
        tri_shading = V.normalize((
            b0 * tn0[0] + bu * tn1[0] + bv * tn2[0],
            b0 * tn0[1] + bu * tn1[1] + bv * tn2[1],
            b0 * tn0[2] + bu * tn1[2] + bv * tn2[2],
        ))

    front = V.dot(n_raw, direction) < 0.0
    n_geom = V.where(front, n_raw, V.neg(n_raw))

    shading = n_geom
    if scene.tri_count:
        flip = V.dot(tri_shading, n_geom) < 0.0
        tri_sn = V.where(flip, V.neg(tri_shading), tri_shading)
        shading = V.where(ptype == PRIM_TRIANGLE, tri_sn, shading)

    if flags.use_imported_color:
        base_color = imported_color
    else:
        base_color = V.splat(u.base_color, like=pos[0])
    return n_geom, shading, base_color, front


def _material_params(flags, u, base_color):
    """Material-mode parameter selection: (metallic, roughness, diffuse
    roughness, wrap, f0 triple)."""
    zero = torch.zeros((), dtype=torch.float32, device=u.metallic.device)
    use_matte = flags.material_mode == 1
    metallic = u.metallic if flags.material_mode == 0 else zero
    rough = u.matte_roughness if use_matte else u.roughness
    diff_rough = u.matte_diffuse_roughness if use_matte else zero
    wrap = u.wrap_diffuse if use_matte else zero
    if use_matte:
        f = u.matte_specular + 0 * base_color[0]
        f0 = (f, f, f)
    else:
        f0 = (
            (1.0 - metallic) * 0.04 + base_color[0] * metallic,
            (1.0 - metallic) * 0.04 + base_color[1] * metallic,
            (1.0 - metallic) * 0.04 + base_color[2] * metallic,
        )
    return metallic, rough, diff_rough, wrap, f0


def _ggx_eval(sn, v, l, rough, f0):
    """GGX specular D*G*F / (4 NdotV NdotL): (value triple, Fresnel)."""
    h = V.normalize(V.add(v, l))
    ndv = torch.clamp_min(V.dot(sn, v), 0.001)
    ndl = torch.clamp_min(V.dot(sn, l), 0.0)
    ndh = torch.clamp_min(V.dot(sn, h), 0.001)
    vdh = torch.clamp_min(V.dot(v, h), 0.001)
    d = B.distribution_ggx(ndh, rough)
    g = B.geometry_smith(ndv, ndl, rough)
    f = B.fresnel_schlick_v3(vdh, f0)
    k = (d * g) / torch.clamp_min(4.0 * ndv * ndl, 0.001)
    return V.scale(f, k), f


@dataclass
class PathState:
    """Per-ray transport state carried from bounce to bounce, plus the
    frame's ray counters (0-d int64 tensors on the device)."""
    seed: torch.Tensor        # int64[B] PCG state (uint32 values)
    origin: tuple
    direction: tuple
    throughput: tuple
    radiance: tuple
    last_pdf: torch.Tensor
    alive: torch.Tensor       # bool[B]
    nrays: torch.Tensor       # closest-hit path segments traced
    noccl: torch.Tensor       # any-hit occlusion candidates traced


def _make_bounce_step(scene, env, flags, u, n, impl=None, vol=None):
    """Factory for ONE path-trace bounce over a flat [n] ray batch:
    bounce_body(bounce: int, state, rec=None, attrs=None, use_attrs=False)
    -> state. env: EnvBuffers when flags.use_env; vol: VolumeBuffers
    (ops/volume.py) when flags.volume_enabled."""
    if flags.use_env and env is None:
        raise ValueError("flags.use_env is set but no environment was given")
    if flags.volume_enabled and vol is None:
        raise ValueError("flags.volume_enabled is set but no volume was given")
    bias = torch.clamp_min(u.ray_bias, 1e-4)
    clip = _clip_tuple(flags, u)
    ambient = V.splat(u.ambient_color)
    stage = _marks()[0]

    def bounce_body(bounce: int, st: PathState, rec=None, attrs=None,
                    use_attrs=False) -> PathState:
        """rec (and attrs): this bounce's closest hits when the caller
        traced them already (bounce 0 of the chunked transports); else the
        live lanes are traced here, through the attrs kernel when
        use_attrs."""
        st.nrays = st.nrays + st.alive.sum()
        if rec is None:
            stage("extend", 2)
            # secondary: bounce rays take the per-ray routing on
            # cluster-rich scenes (the JAX package's _trace_or_skip).
            rec = _closest_hit(scene, flags, st.origin, st.direction, u.t_min, clip,
                               active=st.alive, secondary=bounce > 0,
                               with_attrs=use_attrs, impl=impl)
            if use_attrs:
                rec, attrs = rec
        hit = rec.prim_type >= 0

        # --- volume march up to the closest hit ---
        if flags.volume_enabled:
            stage("volume", 2)
            vol_rad, st.throughput = march_volume(
                vol, st.origin, st.direction, torch.where(hit, rec.t, BIG), u.t_min,
                u.volume_color, u.volume_density, u.volume_opacity, u.volume_step,
                u.volume_threshold, st.throughput, st.alive, flags.volume_max_steps,
                impl=impl)
            for c in range(3):
                st.radiance[c].add_(vol_rad[c])

        # --- environment / ambient on miss, MIS against BRDF sampling ---
        stage("env.miss", 2)
        env_contrib = V.scale(ambient, u.ambient_intensity)
        mis_w = 1.0
        if flags.use_env:
            env_contrib = V.add(env_contrib, sample_env_radiance_v3(
                env, st.direction, u.env_intensity, u.env_max_luminance))
            if bounce > 0:
                mis_w = torch.where(
                    st.last_pdf > 0.0,
                    S.power_heuristic(st.last_pdf, env_pdf_v3(env, st.direction)),
                    1.0)
        miss = st.alive & ~hit
        add = V.scale(V.mul(st.throughput, env_contrib), mis_w)
        # In place: the radiance triple is owned by this state.
        for c in range(3):
            st.radiance[c].add_(torch.where(miss, add[c], 0.0))
        st.alive = st.alive & hit
        return shade_tail(bounce, rec, attrs, st)

    def shade_tail(bounce: int, rec: HitRecord, attrs, st: PathState) -> PathState:
        stage("shade", 2)
        seed = st.seed
        origin, direction = st.origin, st.direction
        throughput, radiance = st.throughput, st.radiance
        last_pdf, alive = st.last_pdf, st.alive
        device = seed.device

        # --- surface reconstruction ---
        pos = V.add(origin, V.scale(direction, rec.t))
        n_geom, sn, base_color, front = _surface_attributes(
            scene, flags, rec, pos, direction, u, attrs=attrs)
        v = V.neg(direction)

        # --- glass / translucent transmission ---
        shade_lane = alive
        transmit = torch.zeros((n,), dtype=torch.bool, device=device)
        if flags.material_mode in (2, 3):
            seed, r_op = rand(seed)
            if flags.material_mode == 2:
                glass_lane = rec.prim_type == PRIM_TRIANGLE
                if flags.surface_flag_mode != 0 and scene.tri_count:
                    tflag = (scene.tri_flags[_tri_index(scene, rec)] if attrs is None
                             else attrs[:, 24])
                    glass_lane = glass_lane & (tflag > 0.5)
            else:
                glass_lane = torch.ones((n,), dtype=torch.bool, device=device)
            transmit = alive & glass_lane & (r_op >= u.surface_opacity)

            cosi = torch.clamp(-V.dot(direction, n_geom), 0.0, 1.0)
            f0s = ((u.surface_ior - 1.0) / (u.surface_ior + 1.0)) ** 2
            fres = B.fresnel_schlick(cosi, f0s)
            ior = torch.clamp_min(u.surface_ior, 1e-3)
            eta = torch.where(front, 1.0 / ior, ior)
            can_refract, refr = B.refract_dir_v3(direction, n_geom, eta)
            reflect_prob = torch.where(can_refract, fres, 1.0)

            seed, r_ref = rand(seed)
            seed, b1, b2 = rand2(seed)
            do_reflect = r_ref < reflect_prob
            if flags.material_mode == 3:
                trans_rough = torch.clamp(u.roughness, 0.02, 1.0)
                refl_dir = S.reflect_from_uv_v3(direction, n_geom, trans_rough, b1, b2)
                refr_dir = S.around_direction_from_uv_v3(refr, trans_rough, b1, b2)
            else:
                refl_dir = V.normalize(V.reflect(direction, n_geom))
                refr_dir = V.normalize(refr)

            new_dir = V.where(do_reflect, refl_dir, refr_dir)
            new_origin = V.where(do_reflect, V.add(pos, V.scale(n_geom, bias)),
                                 V.sub(pos, V.scale(n_geom, bias)))
            one = torch.ones((n,), dtype=torch.float32, device=device)
            tint = V.blend((one, one, one), base_color, u.surface_transmission)
            trans_mask = transmit & ~do_reflect
            throughput = V.where(trans_mask, V.mul(throughput, tint), throughput)
            origin = V.where(transmit, new_origin, origin)
            direction = V.where(transmit, new_dir, direction)
            last_pdf = torch.where(transmit, 0.0, last_pdf)
            shade_lane = alive & ~transmit

        metallic, rough, diff_rough, wrap, f0 = _material_params(flags, u, base_color)

        # --- direct lighting: 3 cone lights + shadows + MIS ---
        # RNG draws stay in per-light order; the shadow queries of all
        # enabled lights run as ONE fused 3-direction trace.
        direct = V.zeros_like(pos[0])
        shadow_min = torch.maximum(bias, u.t_min)
        shadow_origin = V.add(pos, V.scale(n_geom, bias))
        seed, light_samples = _sample_lights(flags, u, sn, shade_lane, seed, n)

        occluded_by_light = {}
        noccl = st.noccl
        if flags.cast_shadows and light_samples and _cluster_tracer(flags):
            for s in light_samples:
                noccl = noccl + s[4].sum()
            d3s, acts = _fan_query(light_samples, n, device)
            occ3 = wf_trace_any3_v3(scene, shadow_origin, d3s, u.t_min,
                                    accept_min=shadow_min.expand(n), clip=clip,
                                    actives=acts, impl=impl)
            for j, s in enumerate(light_samples):
                occluded_by_light[s[0]] = occ3[j]
        elif flags.cast_shadows and light_samples:
            # The enabled lights' rays as one concatenated batch (the JAX
            # package's path where its fused fan does not run).
            m = len(light_samples)
            o_cat = tuple(torch.cat([shadow_origin[c]] * m) for c in range(3))
            d_cat = tuple(torch.cat([s[1][c] for s in light_samples]) for c in range(3))
            act_cat = torch.cat([s[4] for s in light_samples])
            noccl = noccl + act_cat.sum()
            occ_cat = _any_hit(scene, flags, o_cat, d_cat, u.t_min, clip,
                               accept_min=shadow_min.expand(m * n), active=act_cat,
                               impl=impl)
            for j, s in enumerate(light_samples):
                occluded_by_light[s[0]] = occ_cat[j * n:(j + 1) * n]

        for i, ldir, l_pdf, ndl, candidate in light_samples:
            lit = candidate & ~occluded_by_light[i] if flags.cast_shadows else candidate
            spec, f = _ggx_eval(sn, v, ldir, rough, f0)
            diff = B.eval_diffuse_brdf_v3(sn, v, ldir, base_color, diff_rough, wrap)
            diff = V.scale(diff, 1.0 - metallic)
            one_minus_f = (1.0 - f[0], 1.0 - f[1], 1.0 - f[2])
            brdf_val = V.add(spec, V.mul(diff, one_minus_f))
            spec_prob = B.spec_probability_v3(f0, base_color, metallic)
            pdf_b = B.brdf_pdf_v3(sn, v, ldir, rough, spec_prob)
            mis = S.power_heuristic(l_pdf, pdf_b)
            w = ndl * mis / torch.clamp_min(l_pdf, 1e-6) * u.light_intensity[i]
            contrib = (brdf_val[0] * u.light_color[i][0] * w,
                       brdf_val[1] * u.light_color[i][1] * w,
                       brdf_val[2] * u.light_color[i][2] * w)
            direct = V.add(direct, V.where(lit, contrib, V.zeros_like(contrib[0])))
        shaded = V.mul(throughput, direct)
        for c in range(3):
            radiance[c].add_(torch.where(shade_lane, shaded[c], 0.0))

        # --- rim boost at the primary hit ---
        if flags.rim_enabled and flags.material_mode == 0 and bounce == 0:
            ndv = torch.clamp_min(V.dot(sn, v), 0.0)
            rim = V.pow(1.0 - ndv, 3.0) * u.rim_boost
            rim_add = V.scale(V.mul(throughput, base_color), rim)
            for c in range(3):
                radiance[c].add_(torch.where(shade_lane, rim_add[c], 0.0))

        # --- env NEE with MIS ---
        if flags.use_env:
            stage("env.nee", 2)
            seed, env_dir, env_spdf = sample_env_direction_v3(env, seed)
            ndl_e = V.dot(sn, env_dir)
            candidate = shade_lane & (ndl_e > 0.0)
            noccl = noccl + candidate.sum()
            occluded = _any_hit(scene, flags, shadow_origin, env_dir, u.t_min, clip,
                                t_max=BIG, active=candidate, divergent=True, impl=impl)
            open_sky = candidate & ~occluded
            spec, f = _ggx_eval(sn, v, env_dir, rough, f0)
            diff = B.eval_diffuse_brdf_v3(sn, v, env_dir, base_color, diff_rough, wrap)
            diff = V.scale(diff, 1.0 - metallic)
            one_minus_f = (1.0 - f[0], 1.0 - f[1], 1.0 - f[2])
            brdf_val = V.add(spec, V.mul(diff, one_minus_f))
            env_rad = sample_env_radiance_v3(env, env_dir, u.env_intensity,
                                             u.env_max_luminance)
            spec_prob = B.spec_probability_v3(f0, base_color, metallic)
            pdf_b = B.brdf_pdf_v3(sn, v, env_dir, rough, spec_prob)
            mis = S.power_heuristic(env_spdf, pdf_b)
            w = torch.clamp_min(ndl_e, 0.0) * mis / torch.clamp_min(env_spdf, 1e-6)
            contrib = V.scale(V.mul(V.mul(throughput, brdf_val), env_rad), w)
            mx = V.max_component(contrib)
            cscale = torch.where(mx > NEE_CLAMP,
                                 NEE_CLAMP / torch.clamp_min(mx, 1e-12), 1.0)
            contrib = V.scale(contrib, cscale)
            for c in range(3):
                radiance[c].add_(torch.where(open_sky, contrib[c], 0.0))

        # --- BRDF sampling ---
        stage("sample", 2)
        spec_w = V.max_component(f0)
        diff_w = (1.0 - metallic) * V.max_component(base_color)
        wsum = spec_w + diff_w
        spec_prob = torch.clamp(
            torch.where(wsum > 0.0, spec_w / torch.clamp_min(wsum, 1e-12), 1.0),
            0.0, 1.0)

        seed, r_lobe = rand(seed)
        seed, s1, s2 = rand2(seed)
        choose_spec = r_lobe < spec_prob

        h = S.ggx_half_vector_from_uv_v3(sn, rough, s1, s2)
        spec_dir = V.normalize(V.reflect(direction, h))
        ndl_s = torch.clamp_min(V.dot(sn, spec_dir), 0.0)
        ndv = torch.clamp_min(V.dot(sn, v), 0.001)
        ndh = torch.clamp_min(V.dot(sn, h), 0.001)
        vdh = torch.clamp_min(V.dot(v, h), 0.001)
        g = B.geometry_smith(ndv, ndl_s, rough)
        f = B.fresnel_schlick_v3(vdh, f0)
        spec_weight = V.scale(f, g * vdh / (ndv * ndh * torch.clamp_min(spec_prob, 0.01)))
        d_ggx = B.distribution_ggx(ndh, rough)
        spec_last_pdf = spec_prob * d_ggx * ndh / (4.0 * vdh)

        diff_dir = S.cosine_hemisphere_from_uv_v3(sn, s1, s2)
        ndl_d = torch.clamp_min(V.dot(sn, diff_dir), 0.0)
        diff_brdf = B.eval_diffuse_brdf_v3(sn, v, diff_dir, base_color, diff_rough, wrap)
        diff_weight = V.scale(diff_brdf, (1.0 - metallic) * S.PI
                              / torch.clamp_min(1.0 - spec_prob, 0.01))
        diff_last_pdf = (1.0 - spec_prob) * ndl_d / S.PI

        new_dir = V.where(choose_spec, spec_dir, diff_dir)
        weight = V.where(choose_spec, spec_weight, diff_weight)
        dead_spec = choose_spec & (ndl_s <= 0.0)

        throughput = V.where(shade_lane, V.mul(throughput, weight), throughput)
        mx = V.max_component(throughput)
        tscale = torch.where(mx > THROUGHPUT_CLAMP,
                             THROUGHPUT_CLAMP / torch.clamp_min(mx, 1e-12), 1.0)
        throughput = V.scale(throughput, tscale)

        origin = V.where(shade_lane, V.add(pos, V.scale(n_geom, bias)), origin)
        direction = V.where(shade_lane, new_dir, direction)
        last_pdf = torch.where(
            shade_lane, torch.where(choose_spec, spec_last_pdf, diff_last_pdf),
            last_pdf)

        # --- Russian roulette from bounce 1 ---
        rr_kill = torch.zeros_like(shade_lane)
        if bounce >= 1:
            seed, rr = rand(seed)
            p = torch.clamp(V.max_component(throughput), 0.05, 0.95)
            rr_kill = shade_lane & (rr > p)
            rr_boost = torch.where(shade_lane, 1.0 / p, 1.0)
            throughput = V.scale(throughput, rr_boost)

        alive = transmit | (shade_lane & ~dead_spec & ~rr_kill)
        return PathState(seed=seed, origin=origin, direction=direction,
                         throughput=throughput, radiance=radiance,
                         last_pdf=last_pdf, alive=alive, nrays=st.nrays,
                         noccl=noccl)

    return bounce_body


def _sample_lights(flags, u, sn, shade_lane, seed, n):
    """One cone sample per enabled light, in the reference's draw order.
    Returns (seed, [(light index, direction, pdf, n.l, candidate mask)])."""
    samples = []
    for i in range(3):
        if not flags.light_enabled[i]:
            continue
        seed, l1, l2 = rand2(seed)
        ld = u.light_dir[i]
        axis_const = -ld / V.sqrt((ld * ld).sum())
        axis = tuple(axis_const[c].expand(n) for c in range(3))
        ldir, l_pdf = S.cone_from_uv_v3(axis, u.light_angle[i], l1, l2)
        ndl = torch.clamp_min(V.dot(sn, ldir), 0.0)
        samples.append((i, ldir, l_pdf, ndl, shade_lane & (ndl > 0.0)))
    return seed, samples


def _fan_query(light_samples, n, device):
    """(three direction triples, three candidate masks) of the fused
    shadow query; absent lights get a dead (1,0,0) slot."""
    one = torch.ones((n,), dtype=torch.float32, device=device)
    zero = torch.zeros((n,), dtype=torch.float32, device=device)
    dead = torch.zeros((n,), dtype=torch.bool, device=device)
    d3s = tuple(light_samples[j][1] if j < len(light_samples) else (one, zero, zero)
                for j in range(3))
    acts = tuple(light_samples[j][4] if j < len(light_samples) else dead
                 for j in range(3))
    return d3s, acts


def _initial_state(seed, origin, direction, device) -> PathState:
    n = seed.shape[0]

    def ones():
        return torch.ones((n,), dtype=torch.float32, device=device)

    def zeros():
        return torch.zeros((n,), dtype=torch.float32, device=device)

    counter = torch.zeros((), dtype=torch.int64, device=device)
    return PathState(
        seed=seed, origin=origin, direction=direction,
        throughput=(ones(), ones(), ones()),
        radiance=(zeros(), zeros(), zeros()),
        last_pdf=zeros(),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        nrays=counter, noccl=counter.clone(),
    )


def trace_paths(scene, flags, u, origin0, dir0, seed0, env=None, impl=None,
                first_rec=None, first_attrs=None, vol=None):
    """Full path trace for a flat ray batch of component-triple rays.
    Returns (radiance triple, seed, (path_rays, occl_rays)): path_rays
    counts closest-hit extension segments (camera + bounces), occl_rays
    the any-hit shadow candidates (cone lights and env NEE), as 0-d int64
    tensors. env: EnvBuffers, required when flags.use_env; vol:
    VolumeBuffers, required when flags.volume_enabled.

    first_rec: the batch's bounce-0 hits, traced and finalised by the
    caller (a chunk of the permuted transport); first_attrs their
    attribute rows on the attrs path, which then shades every bounce from
    attrs-kernel rows. Without first_rec, _use_attrs decides."""
    n = origin0[0].shape[0]
    use_attrs = (first_attrs is not None if first_rec is not None
                 else _use_attrs(scene, flags))
    bounce_body = _make_bounce_step(scene, env, flags, u, n, impl=impl, vol=vol)
    st = _initial_state(seed0, origin0, dir0, origin0[0].device)
    _, end, stage_next = _marks()
    for bounce in range(flags.max_bounces):
        stage_next(f"bounce[{bounce}]", 1)
        if bounce == 0:
            st = bounce_body(0, st, rec=first_rec, attrs=first_attrs,
                             use_attrs=use_attrs)
        else:
            st = bounce_body(bounce, st, use_attrs=use_attrs)
    end(1)
    radiance = V.min_with(st.radiance, RADIANCE_CLAMP)
    return radiance, st.seed, (st.nrays, st.noccl)


def generate_camera_rays(u, flags, px, py, frame_index, sample_index):
    """Pixel indices -> jittered primary rays + thin-lens DoF.
    Returns (seed, origin triple, direction triple)."""
    seed = init_seed(px, py, frame_index, sample_index)
    seed, jx = rand(seed)
    seed, jy = rand(seed)
    pixel_x = px.to(torch.float32) + 0.5 + (jx - 0.5)
    pixel_y = py.to(torch.float32) + 0.5 + (jy - 0.5)
    uvx = (pixel_x + 0.5) / u.resolution[0] * 2.0 - 1.0
    uvy = (pixel_y + 0.5) / u.resolution[1] * 2.0 - 1.0

    fwd = u.cam_forward
    right = u.cam_right
    up = u.cam_up
    direction = V.normalize((
        fwd[0] + uvx * right[0] + uvy * up[0],
        fwd[1] + uvx * right[1] + uvy * up[1],
        fwd[2] + uvx * right[2] + uvy * up[2],
    ))
    origin = tuple(u.cam_origin[c].expand(px.shape) for c in range(3))

    if flags.dof_enabled:
        def unit(x):
            return x / V.sqrt((x * x).sum())

        fwd_n, right_n, up_n = unit(u.cam_forward), unit(u.cam_right), unit(u.cam_up)
        denom = torch.clamp_min(
            direction[0] * fwd_n[0] + direction[1] * fwd_n[1] + direction[2] * fwd_n[2],
            1e-4)
        t_focus = u.dof_focus_distance / denom
        focus = V.add(origin, V.scale(direction, t_focus))
        seed, (lens_x, lens_y) = S.sample_disk(seed)
        lx = lens_x * u.dof_aperture
        ly = lens_y * u.dof_aperture
        origin = (origin[0] + right_n[0] * lx + up_n[0] * ly,
                  origin[1] + right_n[1] * lx + up_n[1] * ly,
                  origin[2] + right_n[2] * lx + up_n[2] * ly)
        direction = V.normalize(V.sub(focus, origin))

    return seed, origin, direction


# Target rays per chunk of the permuted transport, and the tile a chunk
# is a multiple of (the JAX package's CHUNK_TARGET and wavefront.TILE).
CHUNK_TARGET = 1 << 17
TILE = 256


def _chunk_count(n: int) -> int:
    """Largest chunk count that keeps chunks >= CHUNK_TARGET rays, divides
    the batch exactly and keeps each chunk a multiple of TILE; 1 (the
    whole batch) below 2 x CHUNK_TARGET rays. WRT_CHUNKS overrides it
    where that count is 1 or divides the batch into TILE multiples."""
    force = os.environ.get("WRT_CHUNKS")
    if force:
        c = int(force)
        if c == 1 or (c > 1 and n % c == 0 and (n // c) % TILE == 0):
            return c
    if n < 2 * CHUNK_TARGET:
        return 1
    best = 1
    for chunks in range(2, 64):
        if n % chunks:
            continue
        size = n // chunks
        if size < CHUNK_TARGET or size % TILE:
            continue
        best = chunks
    return best


def _hit_first_permutation(hit):
    """Stable partition: hit lanes first, misses after. Returns (perm,
    inv): perm[slot] is the lane at a sorted slot, inv[lane] its slot."""
    n = hit.shape[0]
    hit_i = hit.to(torch.int64)
    pos_hit = torch.cumsum(hit_i, 0) - 1
    pos_miss = hit_i.sum() + torch.cumsum(1 - hit_i, 0) - 1
    inv = torch.where(hit, pos_hit, pos_miss)
    perm = torch.empty_like(inv)
    perm[inv] = torch.arange(n, dtype=torch.int64, device=hit.device)
    return perm, inv


# Rays move between chunks in blocks of this many (the JAX package's
# value, raced on its TPU; kept so both permute alike).
_PERM_BLOCK = 32


def _tile_permutation(hit, g):
    """Block-granular stable partition: g-ray blocks holding any hit
    first, all-miss blocks after. Returns (perm, inv) over blocks."""
    return _hit_first_permutation(hit.reshape(-1, g).any(dim=1))


def _run_permuted(scene, env, flags, u, seed, origin, direction, rec0, attrs0,
                  clip, chunks, impl=None, vol=None):
    """The block-permuted chunked transport: rays move hit-first in
    _PERM_BLOCK blocks, then each chunk runs trace_paths from its bounce-0
    record, rebuilt per chunk from (t, slot), or from (t, attrs) on the
    attrs path (no gather), and the colours move back. The stack tracer's
    record moves whole: its slots index another table and its t and extra
    are not _finalize_hit's. Returns (radiance triple, (path rays,
    occlusion rays))."""
    n = origin[0].shape[0]
    size = n // chunks
    g = _PERM_BLOCK if (n % _PERM_BLOCK == 0 and size % _PERM_BLOCK == 0) else 1
    if g > 1:
        perm, inv = _tile_permutation(rec0.prim_type >= 0, g)

        def gather(a):
            return a.reshape((n // g, g) + a.shape[1:])[perm].reshape(a.shape)
    else:
        perm, inv = _hit_first_permutation(rec0.prim_type >= 0)

        def gather(a):
            return a[perm]

    slim = flags.tracer == "wavefront"
    if attrs0 is not None:
        last = (attrs0,)
    elif slim:
        last = (rec0.prim_slot,)
    else:
        last = (rec0.prim_type, rec0.prim_local, rec0.prim_slot, rec0.extra, rec0.cost)
    state = [gather(a) for a in (seed, *origin, *direction, rec0.t, *last)]
    colors = []
    counter = torch.zeros((), dtype=torch.int64, device=seed.device)
    nrays, noccl = counter, counter.clone()
    for c in range(chunks):
        sl = slice(c * size, (c + 1) * size)
        seed_c, ox, oy, oz, dx, dy, dz, t_c, *last_c = (a[sl] for a in state)
        origin_c, direction_c = (ox, oy, oz), (dx, dy, dz)
        tmin_c = u.t_min.expand(size)
        attrs_c = None
        if not slim:
            rec_c = HitRecord(t_c, *last_c)
        elif attrs0 is None:
            rec_c = _finalize_hit(scene, origin_c, direction_c, tmin_c, clip, t_c,
                                  last_c[0], cost=None, refine_sphere_t=True)
        else:
            attrs_c = last_c[0]
            rec_c = _finalize_hit(scene, origin_c, direction_c, tmin_c, clip, t_c,
                                  attr_slot(attrs_c), cost=None, refine_sphere_t=True,
                                  row=attrs_c[:, :12])
        radiance, _, (nr, no) = trace_paths(scene, flags, u, origin_c, direction_c,
                                            seed_c, env=env, impl=impl,
                                            first_rec=rec_c, first_attrs=attrs_c,
                                            vol=vol)
        colors.append(V.to_array(radiance))
        nrays, noccl = nrays + nr, noccl + no
    stage = _marks()[0]
    stage("frame.tail", 1)
    colors = torch.cat(colors)
    if g > 1:
        colors = colors.reshape(n // g, g, 3)[inv].reshape(n, 3)
    else:
        colors = colors[inv]
    return V.from_array(colors), (nrays, noccl)


# The binned transport takes batches of whole blocks of this many rays.
BINNED_BLOCK = 1024


def _use_binned(scene, flags, n) -> bool:
    """The binned transport: the default wherever the kernels run
    (WRT_BINNED=1 forces it, =0 turns it off), for batches of whole
    BINNED_BLOCK-ray blocks and at least one bounce; never for volume frames,
    which march from every lane's camera ray, and only on the culled
    cluster tracer (the JAX package's rules)."""
    knob = os.environ.get("WRT_BINNED")
    if (knob == "0" or flags.volume_enabled or not _cluster_tracer(flags)
            or n % BINNED_BLOCK != 0 or flags.max_bounces < 1):
        return False
    return knob == "1" or kernel_supported(scene)


def _binned_transport(scene, env, flags, u, seed, origin, direction, rec0, clip,
                      impl=None):
    """Coherence-binned transport (the JAX package's _binned_transport).

    Bounce 0 packs the primary hits live-first (stable, so the final
    expand is monotone) into a buffer of cap = compact_cap(n, div) lanes
    and finalises the whole buffer, prim_slot -1 on its dead lanes; every
    bounce then runs over the whole buffer, whose live lanes are a prefix
    (`lanes < live count`, a device tensor) and whose dead lanes fill whole
    warps at its tail. After each bounce but the last the buffer is
    re-packed by bin_key, live rows first, every per-lane value moving with
    its row, radiance and the row's bounce-0 slot (`home`) included. At
    the end one inverse move by home and one expand return the radiance to
    pixel order, where the primary misses' environment radiance is added.
    WRT_BIN_CAP_DIV sets div (default 12). With the recorder on, each
    bounce's live lanes (the live count the bounce starts from) add to the
    frame's lanes counter (utils/telemetry.py) beside the cap lanes it
    runs.

    Returns (radiance triple, (path rays, occlusion rays), overflow): a
    0-d int64 tensor, 1 where the frame has more primary hits than cap.
    Such a frame's radiance and counts are not the frame's; the caller
    redoes it through the permuted transport (render_batch_stats, or
    render/frame.py for a block of captured frames)."""
    n = origin[0].shape[0]
    device = seed.device
    hit = rec0.prim_slot >= 0
    n_live = hit.sum()
    cap = CP.compact_cap(n, int(os.environ.get("WRT_BIN_CAP_DIV") or 12))
    recorder = telemetry.recorder
    stage, end, stage_next = _marks()

    # The primary misses' radiance, in pixel order (bounce 0 of trace_paths
    # for a lane that misses).
    stage("env.miss", 2)
    env_contrib = V.scale(V.splat(u.ambient_color), u.ambient_intensity)
    if flags.use_env:
        env_contrib = V.add(env_contrib, sample_env_radiance_v3(
            env, direction, u.env_intensity, u.env_max_luminance))
    zero = torch.zeros((n,), dtype=torch.float32, device=device)
    miss_rad = V.min_with(V.where(~hit, env_contrib, (zero, zero, zero)),
                          RADIANCE_CLAMP)

    # Scene box of the spatial key.
    stage("pack", 2)
    lo = scene.cluster_bmin.min(dim=0).values
    hi = scene.cluster_bmax.max(dim=0).values
    inv_extent = 1.0 / torch.clamp_min(hi - lo, 1e-6)

    # Bounce-0 pack.
    idx = CP.live_first_index(hit, cap)
    rows = CP.gather_rows(CP.pack_rows([seed, *origin, *direction, rec0.t,
                                        rec0.prim_slot]), idx)
    cols = rows.t().contiguous()
    st = _initial_state(CP.seed_col(rows, 0), (cols[1], cols[2], cols[3]),
                        (cols[4], cols[5], cols[6]), device)
    lanes = torch.arange(cap, device=device)
    st.alive = lanes < n_live
    home = lanes
    end(2)
    rec_k = _finalize_hit(scene, st.origin, st.direction, u.t_min.expand(cap), clip,
                          cols[7], torch.where(st.alive, CP.int_col(rows, 8), -1),
                          cost=None, refine_sphere_t=True)

    bounce_body = _make_bounce_step(scene, env, flags, u, cap, impl=impl)
    live = n_live
    for b in range(flags.max_bounces):
        stage_next(f"bounce[{b}]", 1)
        if recorder is not None:
            recorder.lanes(b, live, cap, flags.max_bounces)
        st = bounce_body(b, st, rec=rec_k if b == 0 else None)
        if b < flags.max_bounces - 1:
            stage("repack", 2)
            key = CP.bin_key(st.origin, st.direction, lo, inv_extent)
            order = torch.argsort(torch.where(st.alive, key, CP.DEAD_KEY), stable=True)
            rows = CP.gather_rows(CP.pack_rows(
                [st.seed, *st.origin, *st.direction, *st.throughput, st.last_pdf,
                 *st.radiance, home]), order)
            m = st.alive.sum()
            cols = rows.t().contiguous()
            st = PathState(seed=CP.seed_col(rows, 0),
                           origin=(cols[1], cols[2], cols[3]),
                           direction=(cols[4], cols[5], cols[6]),
                           throughput=(cols[7], cols[8], cols[9]),
                           last_pdf=cols[10],
                           radiance=(cols[11], cols[12], cols[13]),
                           alive=lanes < m, nrays=st.nrays, noccl=st.noccl)
            home = CP.int_col(rows, 14)
            live = m

    stage("frame.tail", 1)
    back = torch.argsort(home, stable=True)
    rad_c = V.min_with(tuple(r[back] for r in st.radiance), RADIANCE_CLAMP)
    radiance = V.add(miss_rad, CP.expand_cols(rad_c, hit))
    overflow = (n_live > cap).to(torch.int64)
    return radiance, (st.nrays + (n - n_live), st.noccl), overflow


def _sample_radiance(scene, flags, u, px, py, frame_index, s, env=None, impl=None,
                     binned=True, vol=None):
    """One path-traced sample for every pixel, through the transport the
    JAX package's _sample_radiance picks: the whole batch for one chunk;
    else a full-width primary trace, then the permuted transport with
    attrs rows (_use_attrs), the binned transport (_use_binned, unless
    binned=False) or the permuted transport. With the recorder on, each
    transport marks its device spans: frame.head (camera rays and, but
    for the whole batch, the primary trace; the binned transport's
    env.miss of the primary misses, its pack and _finalize_hit), a
    bounce[b] per bounce (and chunk) with its parts (extend, volume,
    env.miss, shade with the shadow fan's kernel, env.nee, sample, repack),
    frame.tail.
    Returns (radiance triple, (path rays, occlusion rays), overflow): a 0-d
    int64 tensor, 1 where the binned buffer overflowed (the sample must be
    redone with binned=False), else 0."""
    stage = _marks()[0]
    stage("frame.head", 1)
    seed, origin, direction = generate_camera_rays(u, flags, px, py, frame_index, s)
    n = px.shape[0]
    no_overflow = torch.zeros((), dtype=torch.int64, device=px.device)
    chunks = _chunk_count(n)
    if chunks == 1:
        radiance, _, rays = trace_paths(scene, flags, u, origin, direction, seed,
                                        env=env, impl=impl, vol=vol)
        stage("frame.tail", 1)
        return radiance, rays, no_overflow
    clip = _clip_tuple(flags, u)
    attrs0 = None
    if _use_attrs(scene, flags):
        rec0, attrs0 = _closest_hit(scene, flags, origin, direction, u.t_min, clip,
                                    with_attrs=True, impl=impl)
    else:
        rec0 = _closest_hit(scene, flags, origin, direction, u.t_min, clip,
                            full_record=False, impl=impl)
    if binned and attrs0 is None and _use_binned(scene, flags, n):
        return _binned_transport(scene, env, flags, u, seed, origin, direction,
                                 rec0, clip, impl=impl)
    radiance, rays = _run_permuted(scene, env, flags, u, seed, origin, direction,
                                   rec0, attrs0, clip, chunks, impl=impl, vol=vol)
    return radiance, rays, no_overflow


def render_batch_flagged(scene, flags, u, px, py, frame_index, env=None, impl=None,
                         binned=True, vol=None):
    """One progressive sample set per pixel with no host read on the
    kernels' path: (colour f32[B,3], (path rays, occlusion rays), overflow),
    overflow a 0-d int64 tensor counting the samples whose binned buffer
    overflowed. Where it is not 0 the colour and counts are not the
    frame's: redo the frame with binned=False. Exposure is applied before
    accumulation. frame_index: an int or an integer tensor (a captured
    frame's device counter). vol: VolumeBuffers for a volume frame."""
    device = px.device
    total = V.full(px.shape, 0.0, device=device)
    rays = (torch.zeros((), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device))
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(flags.spp):
        radiance, nrays, over = _sample_radiance(scene, flags, u, px, py, frame_index, s,
                                                 env=env, impl=impl, binned=binned,
                                                 vol=vol)
        total = V.add(total, radiance)
        rays = (rays[0] + nrays[0], rays[1] + nrays[1])
        overflow = overflow + over
    return V.to_array(V.scale(total, u.exposure / flags.spp)), rays, overflow


def render_batch_stats(scene, flags, u, px, py, frame_index, env=None, impl=None,
                       vol=None):
    """One progressive sample set per pixel -> (colour f32[B,3], (path
    rays, occlusion rays)). Reads the binned transport's overflow flag
    once: a frame that overflowed is redone through the permuted
    transport, the JAX package's lax.cond fallback."""
    color, rays, overflow = render_batch_flagged(scene, flags, u, px, py, frame_index,
                                                 env=env, impl=impl, vol=vol)
    if int(overflow):
        color, rays, _ = render_batch_flagged(scene, flags, u, px, py, frame_index,
                                              env=env, impl=impl, binned=False, vol=vol)
    return color, rays


def render_batch(scene, flags, u, px, py, frame_index, env=None, impl=None, vol=None):
    """One progressive sample set per pixel -> colour f32[B,3]."""
    return render_batch_stats(scene, flags, u, px, py, frame_index, env=env,
                              impl=impl, vol=vol)[0]


# Mode 2's ramp, from no cost to COST_HEATMAP_MAX primitives a ray: blue,
# cyan, green, yellow, red.
COST_HEATMAP_MAX = 200.0
COST_HEATMAP_STOPS = ((0.0, 0.0, 1.0), (0.0, 1.0, 1.0), (0.0, 1.0, 0.0),
                      (1.0, 1.0, 0.0), (1.0, 0.0, 0.0))


def cost_heatmap(cost):
    """Vis mode 2's colour f32[B,3] of a count i32[B]: the five-stop ramp
    of clip(cost / 200, 0, 1), as the JAX package's render_visualization
    draws it."""
    t = torch.clamp(cost.to(torch.float32) / COST_HEATMAP_MAX, 0.0, 1.0)
    stops = torch.tensor(COST_HEATMAP_STOPS, dtype=torch.float32, device=cost.device)
    seg = torch.clamp(t * 4.0, 0.0, 4.0)
    frac = (seg - torch.floor(seg))[:, None]
    idx = torch.clamp(torch.floor(seg).to(torch.int64), 0, 3)
    return stops[idx] * (1 - frac) + stops[idx + 1] * frac


def pixel_centre_rays(u, px, py):
    """The visualisation's pixel rays (origin, direction): through the
    pixel's centre with no jitter, plus the reference's extra +0.5."""
    fragx = px.to(torch.float32) + 0.5
    fragy = py.to(torch.float32) + 0.5
    uvx = (fragx + 0.5) / u.resolution[0] * 2.0 - 1.0
    uvy = (fragy + 0.5) / u.resolution[1] * 2.0 - 1.0
    fwd, right, up = u.cam_forward, u.cam_right, u.cam_up
    direction = V.normalize((
        fwd[0] + uvx * right[0] + uvy * up[0],
        fwd[1] + uvx * right[1] + uvy * up[1],
        fwd[2] + uvx * right[2] + uvy * up[2],
    ))
    return tuple(u.cam_origin[c].expand(px.shape) for c in range(3)), direction


def render_visualization(scene, flags, u, px, py, frame_index=0, env=None, impl=None,
                         vol=None):
    """The debug view of flags.vis_mode, f32[B,3] (the JAX package's
    render_visualization): 1 normals, (n + 1) / 2, black on a miss; 2 the
    heatmap of the primary closest hit's count (cost_heatmap; the
    trace_closest_cost kernel on the card, the walk's own count under the
    stack tracer, K * C under use_bvh=False); 3 depth, 1 - clip(t / 10,
    0, 1), 0 on a miss. The rays are pixel_centre_rays, clip plane
    applied; no env, volume or frame index enters the view, and any other
    mode is black."""
    origin, direction = pixel_centre_rays(u, px, py)
    rec = _closest_hit(scene, flags, origin, direction, u.t_min, _clip_tuple(flags, u),
                       impl=impl, with_cost=flags.vis_mode == 2)
    hit = rec.prim_type >= 0
    if flags.vis_mode == 1:
        pos = V.add(origin, V.scale(direction, rec.t))
        _, sn, _, _ = _surface_attributes(scene, flags, rec, pos, direction, u)
        color = V.scale(V.add(sn, (1.0, 1.0, 1.0)), 0.5)
        return V.to_array(V.where(hit, color, V.zeros_like(color[0])))
    if flags.vis_mode == 2:
        return cost_heatmap(rec.cost)
    if flags.vis_mode == 3:
        depth = torch.where(hit, 1.0 - torch.clamp(rec.t / 10.0, 0.0, 1.0), 0.0)
        return V.to_array((depth, depth, depth))
    return torch.zeros(px.shape + (3,), dtype=torch.float32, device=px.device)
