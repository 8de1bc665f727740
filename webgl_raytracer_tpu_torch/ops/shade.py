"""The bounce step's shading as two CUDA kernels (csrc/shade.cu).

render/integrator.py's bounce step on CUDA tensors runs the arithmetic
between its traces as two kernels, one thread a lane, instead of some
2,000 small PyTorch kernels over the whole buffer:

shade_surface
    after the closest hit (and the volume march): the miss radiance
    (ambient, the environment and its MIS weight) added in place, the
    surface of the hit, glass and translucent transmission, the three
    cone-light samples and env NEE's direction. Returns a Surface: the
    shadow fan's and env NEE's operands, and the state so far.
shade_scatter
    after the occlusion queries: direct light, the rim, env NEE's
    contribution, the BRDF lobe sample, the throughput clamp and Russian
    roulette, into the Surface's state in place; radiance in place.

The occlusion queries between them are the tracer's own (the fused fan
trace_any3, or the concatenated batch of the stack walk and the brute
sweep; trace_any / trace_any_perray for env NEE).

The kernels take every configuration the plain step takes; they read
the plain step's operands as they are (surface_args / scatter_args check
each first and raise ValueError before any launch): the state's rows and
the hit record of any transport, the rows of the cluster table, the
stack walk's tables or the attrs kernel's rows. A lane dead on entry
gets alive False and no fan or env NEE candidate; its other state is not
written. Light j of the fan is slot j (a disabled light's slot holds the
direction (1, 0, 0) and no candidate).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import vec3 as V

# Configuration bits (csrc/shade.cuh).
USE_ENV = 1 << 0
IMPORTED_COLOR = 1 << 1
TRI_FLAGS = 1 << 2
ROWS_BY_LANE = 1 << 3
SHADOWS = 1 << 4
RIM = 1 << 5
HAS_SPHERE = 1 << 8
HAS_CYLINDER = 1 << 9
HAS_TRIANGLE = 1 << 10
LIGHT0 = 1 << 12

# The work buffer's rows (csrc/shade.cuh): shadow origin, the fan's three
# directions, env NEE's direction and pdf, the shading normal, the base
# colour.
WORK_ROWS = 22
# The lane buffer's rows: the fan's three masks, env NEE's mask, the lane
# code.
LANE_ROWS_COUNT = 5

# The params vector, in order: (uniform field, values).
PARAM_FIELDS = (("base_color", 3), ("metallic", 1), ("roughness", 1), ("rim_boost", 1),
                ("matte_specular", 1), ("matte_roughness", 1),
                ("matte_diffuse_roughness", 1), ("wrap_diffuse", 1), ("surface_ior", 1),
                ("surface_transmission", 1), ("surface_opacity", 1),
                ("ambient_intensity", 1), ("ambient_color", 3), ("env_intensity", 1),
                ("env_max_luminance", 1), ("ray_bias", 1), ("light_axis", 9),
                ("light_color", 9), ("light_intensity", 3), ("light_angle", 3))
PARAMS = sum(k for _, k in PARAM_FIELDS)


def shade_params(flags, u) -> torch.Tensor:
    """params f32[PARAMS] of one frame: the uniforms the kernels read, and
    each enabled light's axis as the plain step computes it (-ld / |ld|,
    with its tensor sum); a disabled light's axis is 0."""
    axes = []
    for i in range(3):
        ld = u.light_dir[i]
        axes.append(-ld / V.sqrt((ld * ld).sum()) if flags.light_enabled[i]
                    else torch.zeros_like(ld))
    values = []
    for name, _ in PARAM_FIELDS:
        if name == "light_axis":
            values.extend(axes)
        else:
            values.append(getattr(u, name).reshape(-1))
    return torch.cat(values)


def config_bits(scene, flags, lane_rows: bool) -> int:
    """The kernels' configuration bits (csrc/shade.cuh)."""
    bits = ((USE_ENV if flags.use_env else 0)
            | (IMPORTED_COLOR if flags.use_imported_color else 0)
            | (TRI_FLAGS if flags.surface_flag_mode != 0 and scene.tri_count else 0)
            | (ROWS_BY_LANE if lane_rows else 0)
            | (SHADOWS if flags.cast_shadows else 0)
            | (RIM if flags.rim_enabled else 0)
            | (HAS_SPHERE if scene.sphere_count else 0)
            | (HAS_CYLINDER if scene.cylinder_count else 0)
            | (HAS_TRIANGLE if scene.tri_count else 0))
    for i in range(3):
        if flags.light_enabled[i]:
            bits |= LIGHT0 << i
    return bits


def bisect_trips(size: int) -> int:
    """ops/envmap._bisect_cdf's trip count over a CDF of `size` values."""
    return max(1, math.ceil(math.log2(max(2, size))))


def env_operands(env, device) -> tuple:
    """(radiance, marginal, conditional, w, h, trips_v, trips_u), each
    table checked; nulls and zeros without an environment."""
    from .kernels import check_operand

    if env is None:
        return (None, None, None, 0, 0, 0, 0)
    h, w = env.height, env.width
    for x, shape, name in ((env.radiance, (h, w, 3), "env radiance"),
                           (env.marginal_cdf, (h + 1,), "env marginal cdf"),
                           (env.conditional_cdf, (h, w + 1), "env conditional cdf")):
        check_operand(x, torch.float32, device)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, not {tuple(x.shape)}")
    return (env.radiance, env.marginal_cdf, env.conditional_cdf, w, h,
            bisect_trips(h + 1), bisect_trips(w + 1))


def _table(x, dtype, device, name, cols=None):
    from .kernels import check_operand

    check_operand(x, dtype, device)
    if cols is not None and (x.dim() != 2 or x.shape[1] != cols):
        raise ValueError(f"{name} must have {cols} columns, not shape {tuple(x.shape)}")
    return x


def row_operands(scene, flags, attrs, n: int, device) -> tuple:
    """(pa, pb, pc, row stride, colour, its stride, triangle normals, their
    stride, triangle flags, their stride, triangle rows, lane rows): the
    rows _surface_attributes reads, as (view, stride in floats) pairs
    whose views start at the row's first value: the attrs kernel's rows
    (one a lane), the cluster table's or the stack walk's tables (by
    slot)."""
    f32 = torch.float32
    tri_rows = scene.tri_normals.shape[0]
    if attrs is not None:
        a = _table(attrs, f32, device, "attrs", cols=32)
        if a.shape[0] != n:
            raise ValueError(f"attrs must have {n} rows, not {a.shape[0]}")
        return (a, a[:, 4], a[:, 8], 32, a[:, 12], 32, a[:, 15], 32, a[:, 24], 32,
                tri_rows, True)
    if flags.tracer == "wavefront":
        rows = _table(scene.cluster_prims, f32, device, "cluster_prims").reshape(-1, 12)
        pa, pb, pc, stride = rows, rows[:, 4], rows[:, 8], 12
        color = _table(scene.cluster_color, f32, device, "cluster_color", cols=3)
    else:
        tables = scene.walk_tables
        pa, pb, pc = (_table(x, f32, device, name, cols=4) for x, name in (
            (tables.prim_a, "prim_a"), (tables.prim_b, "prim_b"), (tables.prim_c, "prim_c")))
        stride = 4
        color = _table(tables.prim_color, f32, device, "prim_color", cols=3)
    tn = _table(scene.tri_normals, f32, device, "tri_normals")
    if tuple(tn.shape[1:]) != (3, 3):
        raise ValueError(f"tri_normals must have shape (T, 3, 3), not {tuple(tn.shape)}")
    tf = _table(scene.tri_flags, f32, device, "tri_flags")
    if tuple(tf.shape) != (tri_rows,):
        raise ValueError(f"tri_flags must have shape ({tri_rows},), not {tuple(tf.shape)}")
    return (pa, pb, pc, stride, color, 3, tn, 9, tf, 1, tri_rows, False)


def _row(x, n, device, dtype, name):
    from .kernels import check_operand

    if not isinstance(x, torch.Tensor) or tuple(x.shape) != (n,):
        raise ValueError(f"{name} must be a tensor of shape ({n},)")
    check_operand(x, dtype, device)
    return x


def _mask(x, n, device, name):
    """A bool [n] row as the kernels take it (u8 bytes)."""
    return _row(x, n, device, torch.bool, name)


def surface_args(scene, flags, env, params, bounce: int, st, rec, attrs) -> tuple:
    """shade_surface's arguments before its outputs, each operand checked
    first (ValueError: a state row that is neither one f32 value nor a
    contiguous f32 [n] row on the state's device, a seed that is not
    contiguous i64 [n], a radiance row or activity mask, a hit record
    field, attrs rows, a table or the params of another type, shape or
    device). Tensors stand for their pointers (ops/kernels.launch); the
    operands are the callers' tensors themselves, nothing is staged."""
    from .kernels import ray_count, ray_operand

    if not isinstance(st.seed, torch.Tensor) or st.seed.dim() != 1:
        raise ValueError("seed must be a tensor of shape (n,)")
    n = ray_count(st.seed.shape[0])
    device = st.seed.device
    _row(st.seed, n, device, torch.int64, "seed")
    names = ("ox", "oy", "oz", "dx", "dy", "dz", "tpx", "tpy", "tpz", "last_pdf")
    rows = [v for x, name in zip((*st.origin, *st.direction, *st.throughput, st.last_pdf),
                                 names)
            for v in ray_operand(x, n, device, name)]
    rad = [_row(x, n, device, torch.float32, name)
           for x, name in zip(st.radiance, ("rx", "ry", "rz"))]
    alive = _mask(st.alive, n, device, "alive")
    hit = [_row(rec.t, n, device, torch.float32, "t"),
           _row(rec.prim_type, n, device, torch.int32, "prim_type"),
           _row(rec.prim_local, n, device, torch.int32, "prim_local"),
           _row(rec.prim_slot, n, device, torch.int32, "prim_slot"),
           _table(rec.extra, torch.float32, device, "extra", cols=3)]
    if hit[-1].shape[0] != n:
        raise ValueError(f"extra must have {n} rows, not {hit[-1].shape[0]}")
    *tables, lane_rows = row_operands(scene, flags, attrs, n, device)
    _params(params, device)
    return (n, int(bounce), int(flags.material_mode), config_bits(scene, flags, lane_rows),
            st.seed, *rows, *rad, alive, *hit, *tables, *env_operands(env, device), params)


def _params(params, device):
    from .kernels import check_operand

    check_operand(params, torch.float32, device)
    if tuple(params.shape) != (PARAMS,):
        raise ValueError(f"params must have shape ({PARAMS},), not {tuple(params.shape)}")


@dataclass
class Surface:
    """What shade_surface hands the queries and shade_scatter."""
    seed: torch.Tensor          # i64[n]
    state: torch.Tensor         # f32[10, n]: origin, direction, throughput, last pdf
    alive: torch.Tensor         # bool[n]
    work: torch.Tensor          # f32[WORK_ROWS, n]
    lanes: torch.Tensor         # u8[LANE_ROWS_COUNT, n]
    bits: int

    @property
    def shadow_origin(self):
        return (self.work[0], self.work[1], self.work[2])

    @property
    def fan_dirs(self):
        return tuple((self.work[3 + 3 * j], self.work[4 + 3 * j], self.work[5 + 3 * j])
                     for j in range(3))

    @property
    def fan_masks(self):
        """bool [3, n]: light j's candidates in row j."""
        return self.lanes[0:3].view(torch.bool)

    @property
    def env_dir(self):
        return (self.work[12], self.work[13], self.work[14])

    @property
    def env_mask(self):
        return self.lanes[3].view(torch.bool)


def shade_surface(scene, flags, env, params, bounce: int, st, rec, attrs=None) -> Surface:
    """Kernel shade_surface over the bounce's lanes: radiance (st.radiance)
    gets the misses' radiance in place."""
    from .kernels import launch

    args = surface_args(scene, flags, env, params, bounce, st, rec, attrs)
    n, device = args[0], st.seed.device
    out = Surface(seed=torch.empty(n, dtype=torch.int64, device=device),
                  state=torch.empty((10, n), dtype=torch.float32, device=device),
                  alive=torch.empty(n, dtype=torch.bool, device=device),
                  work=torch.empty((WORK_ROWS, n), dtype=torch.float32, device=device),
                  lanes=torch.empty((LANE_ROWS_COUNT, n), dtype=torch.uint8, device=device),
                  bits=args[3])
    if n:
        err = launch("wrt_shade_surface", device, *args, out.seed, out.state, out.alive,
                     out.work, out.lanes)
        if err != 0:
            raise RuntimeError(f"wrt_shade_surface failed: CUDA error {err}")
    return out


def scatter_args(flags, env, params, bounce: int, surf: Surface, occluded, env_occluded,
                 radiance) -> tuple:
    """shade_scatter's arguments, each operand checked first (ValueError):
    occluded, three bool [n] rows or None (a disabled light, or no
    shadows), env_occluded bool [n] under env NEE, radiance three f32 [n]
    rows."""
    from .kernels import check_operand

    n = surf.seed.shape[0]
    device = surf.seed.device
    for x, dt in ((surf.work, torch.float32), (surf.lanes, torch.uint8),
                  (surf.state, torch.float32), (surf.seed, torch.int64),
                  (surf.alive, torch.bool)):
        check_operand(x, dt, device)
    if surf.work.shape != (WORK_ROWS, n) or surf.lanes.shape != (LANE_ROWS_COUNT, n) \
            or surf.state.shape != (10, n) or surf.alive.shape != (n,):
        raise ValueError("the surface's buffers must be shade_surface's")
    occ = []
    for j in range(3):
        need = flags.cast_shadows and flags.light_enabled[j]
        if need != (occluded[j] is not None):
            raise ValueError(f"occluded[{j}] must be {'a mask' if need else 'None'}")
        occ.append(_mask(occluded[j], n, device, f"occluded[{j}]") if need else None)
    if flags.use_env != (env_occluded is not None):
        raise ValueError("env_occluded must be a mask exactly under env NEE")
    env_occ = _mask(env_occluded, n, device, "env_occluded") if flags.use_env else None
    rad = [_row(x, n, device, torch.float32, name)
           for x, name in zip(radiance, ("rx", "ry", "rz"))]
    _params(params, device)
    return (n, int(bounce), int(flags.material_mode), surf.bits, surf.work, surf.lanes,
            *occ, env_occ, *rad, *env_operands(env, device), params, surf.seed, surf.state,
            surf.alive)


def shade_scatter(flags, env, params, bounce: int, surf: Surface, occluded, env_occluded,
                  radiance) -> None:
    """Kernel shade_scatter: surf's state and radiance finished in place."""
    from .kernels import launch

    args = scatter_args(flags, env, params, bounce, surf, occluded, env_occluded, radiance)
    n, device = args[0], surf.seed.device
    if n:
        err = launch("wrt_shade_scatter", device, *args)
        if err != 0:
            raise RuntimeError(f"wrt_shade_scatter failed: CUDA error {err}")
