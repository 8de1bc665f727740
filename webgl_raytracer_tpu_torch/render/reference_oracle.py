"""Reference-faithful oracle: a NumPy transliteration of the WebGL
reference viewer's path-trace fragment shader (webgl.js), the port's own
copy of webgl_raytracer_tpu/render/reference_oracle.py.

It re-implements the reference transport exactly as written in webgl.js:
per-pixel PCG stream (:883-900), camera jitter + thin-lens DoF
(:1508-1544), tracePath's bounce loop (:1173-1441), shadeDirect's three
cone lights (:1094-1145), env NEE + MIS (:1334-1385), GGX/cosine BRDF
sampling (:1387-1429) and Russian roulette (:1434-1441), with the
reference's *divergent* control flow reproduced through masked RNG
advancement: a draw site only advances the uint32 state of lanes whose
per-pixel control path reaches it, exactly like per-pixel GLSL execution.

Because the port's integrator consumes the same PCG stream at the same
sites for the non-glass material modes, this oracle is sample-exact with
it there: images after N progressive frames agree to float32 arithmetic
noise, so a small-N RMSE measures arithmetic fidelity rather than
Monte-Carlo variance. For the glass/translucent modes (material 2/3) the
integrator consumes draws unconditionally (masked lanes), so streams
diverge and parity is only statistical.

Everything is float32 NumPy; traversal is the brute-force loop of the
reference's useBvh=0 path (webgl.js:564-604) vectorized over [rays,
prims]: acceleration structures cannot change results, only speed. The
primitive table is read from the compiled scene's cluster rows (padding
dropped), so a row is the same primitive the port's tracer names.

The [rays, prims] trace dominates the oracle's time. `trace_device` (a
CUDA device) moves the closest-hit and any-hit traces onto the card: the
same all-pairs intersector run on torch tensors, one eager tensor op per
numpy op in the same order (so nothing contracts a multiply into an add),
over the lanes the mask leaves live, in ray chunks. Each op rounds as
IEEE f32 on the card as numpy does on the host, so the card trace gives
the numpy trace's rows and t bit for bit; shading stays in numpy. It is
the oracle's own dense formulation, independent of the port's cluster
traversal. There is no CPU form of it: torch's CPU f32 sqrt is not
correctly rounded on every machine, so on the CPU the oracle is numpy.
A volume frame marches the density grid in numpy (_march_volume, the
shader's in-loop march with its tCurrent > tExit break).
"""

from __future__ import annotations

from dataclasses import fields
from types import SimpleNamespace

import numpy as np

F = np.float32
BIG = F(1e20)
PI = F(np.pi)
TWO_PI = F(2.0 * np.pi)
_MUL = np.uint32(747796405)
_INC = np.uint32(2891336453)
_OUT = np.uint32(277803737)
_INV_U32_MAX = F(1.0 / 4294967295.0)

PRIM_TRIANGLE, PRIM_SPHERE, PRIM_CYLINDER = 0, 1, 2


# --------------------------------------------------------------------------
# RNG (webgl.js:883-900) with per-lane masked advancement.

def pcg_hash(v):
    v = np.asarray(v, np.uint32)
    state = v * _MUL + _INC
    word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) * _OUT
    return (word >> np.uint32(22)) ^ word


def init_seed(px, py, frame_index, sample_index=0):
    px = np.asarray(px, np.uint32)
    py = np.asarray(py, np.uint32)
    seed = px + py * np.uint32(65536) + np.uint32(frame_index) * np.uint32(15485863)
    return pcg_hash(seed) + np.uint32(sample_index) * _MUL


def rand(state, mask=None):
    """One draw. Lanes outside `mask` keep their state (their returned
    uniform is garbage and must not be used)."""
    new = state * _MUL + _INC
    word = ((new >> ((new >> np.uint32(28)) + np.uint32(4))) ^ new) * _OUT
    bits = (word >> np.uint32(22)) ^ word
    u = bits.astype(np.float32) * _INV_U32_MAX
    if mask is not None:
        new = np.where(mask, new, state)
    return new, u


# --------------------------------------------------------------------------
# Small vector helpers over component triples of [N] float32 arrays.

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm(v, eps=F(1e-12)):
    inv = F(1.0) / np.maximum(np.sqrt(_dot(v, v)), eps)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _where(m, a, b):
    return (np.where(m, a[0], b[0]), np.where(m, a[1], b[1]),
            np.where(m, a[2], b[2]))


def _to_world(axis, lx, ly, lz):
    """Local->world with the shader's up convention (webgl.js:992-994)."""
    use_z = np.abs(axis[2]) < F(0.999)
    up = (np.where(use_z, F(0.0), F(1.0)), np.zeros_like(axis[0]),
          np.where(use_z, F(1.0), F(0.0)))
    t = _norm(_cross(up, axis))
    b = _cross(axis, t)
    return _norm((t[0] * lx + b[0] * ly + axis[0] * lz,
                  t[1] * lx + b[1] * ly + axis[1] * lz,
                  t[2] * lx + b[2] * ly + axis[2] * lz))


# --------------------------------------------------------------------------
# Scene table -> NumPy (host copies of the compiled scene's cluster rows).

def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# The intersector's numpy backend (the card's is _CardScene.ops).
_NUMPY_OPS = SimpleNamespace(
    where=np.where, sqrt=np.sqrt, c=F, recip=lambda x: F(1.0) / x,
    misses=lambda n, p: np.full((n, p), F(-1.0)))


class _NpScene:
    """The primitive table of a compiled scene (scene/compile.SceneBuffers):
    its cluster rows [a.xyz, radius | b.xyz, local | c.xyz, type] in row
    order, padding rows (type -1) dropped."""

    def __init__(self, scene, trace_device=None):
        rows = _host(scene.cluster_prims).astype(np.float32).reshape(-1, 12)
        ptype = rows[:, 11].astype(np.int32)
        keep = np.nonzero(ptype >= 0)[0]
        rows = rows[keep]
        self.prim_a = np.ascontiguousarray(rows[:, 0:4])
        self.prim_b = np.concatenate([rows[:, 4:7], np.zeros((keep.size, 1), np.float32)], 1)
        self.prim_c = np.concatenate([rows[:, 8:11], np.zeros((keep.size, 1), np.float32)], 1)
        self.prim_type = ptype[keep]
        self.prim_local = rows[:, 7].astype(np.int32)
        self.prim_color = _host(scene.cluster_color).astype(np.float32)[keep]
        self.tri_normals = _host(scene.tri_normals).astype(np.float32)
        self.tri_flags = _host(scene.tri_flags).astype(np.float32)
        self.tri_count = int(scene.tri_count)
        self.sphere_count = int(scene.sphere_count)
        self.cylinder_count = int(scene.cylinder_count)
        self.prim_count = int(keep.size)
        # Per-type column indices: each intersector evaluates only its own
        # type's columns (bit-identical — the math is elementwise per
        # column; only wasted work over other-type columns is skipped,
        # which on a cartoon scene of ~15k triangles + a handful of HETATM
        # spheres/cylinders is ~3x the whole oracle).
        pt = self.prim_type
        self.idx_sphere = np.nonzero(pt == PRIM_SPHERE)[0]
        self.idx_cylinder = np.nonzero(pt == PRIM_CYLINDER)[0]
        self.idx_triangle = np.nonzero(pt == PRIM_TRIANGLE)[0]
        self.ops = _NUMPY_OPS
        self.card = None if trace_device is None else _CardScene(self, trace_device)


def _intersect_all(sc, o, d, tmin, clip):
    """[N,P] candidate t (-1 = miss): the reference's per-type intersectors
    (sphere webgl.js:425-443, cylinder-with-caps :446-525, Moller-Trumbore
    :364-390 incl. triangle clip rejection) over every primitive, on the
    scene's backend `sc.ops` (numpy arrays for _NpScene, card tensors for
    _CardScene). o, d are triples of [N] f32, tmin [N].

    Dead lanes carry garbage origins (o + d*1e20); their arithmetic may
    overflow to inf/nan but is fully masked, so warnings are suppressed.
    """
    xp = sc.ops
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    tmin = tmin[:, None]
    t = xp.misses(o[0].shape[0], sc.prim_count)

    # Each intersector sees only its own type's columns (sc.idx_*):
    # elementwise math per column, so results are bit-identical to the
    # full-width form while skipping other-type columns entirely.
    if sc.sphere_count:
        pa = sc.prim_a[None, sc.idx_sphere]
        ra = pa[..., 3]
        sx = ox - pa[..., 0]
        sy = oy - pa[..., 1]
        sz = oz - pa[..., 2]
        b = sx * dx + sy * dy + sz * dz
        cterm = sx * sx + sy * sy + sz * sz - ra * ra
        disc = b * b - cterm
        ok = disc >= 0.0
        sq = xp.sqrt(xp.where(ok, disc, xp.c(0.0)))
        t0 = -b - sq
        t1 = -b + sq
        ts = xp.where(t0 > tmin, t0, t1)
        ts = xp.where(ok & (ts > tmin), ts, xp.c(-1.0))
        t[:, sc.idx_sphere] = ts

    if sc.cylinder_count:
        pa = sc.prim_a[None, sc.idx_cylinder]
        pb = sc.prim_b[None, sc.idx_cylinder]
        ra = pa[..., 3]
        p1 = (pa[..., 0], pa[..., 1], pa[..., 2])
        p2 = (pb[..., 0], pb[..., 1], pb[..., 2])
        av = (p2[0] - p1[0], p2[1] - p1[1], p2[2] - p1[2])
        height = xp.sqrt(_dot(av, av))
        degen = height < xp.c(1e-6)
        inv_h = xp.recip(xp.where(degen, xp.c(1.0), height))
        ax = (av[0] * inv_h, av[1] * inv_h, av[2] * inv_h)
        oc = (ox - p1[0], oy - p1[1], oz - p1[2])
        dir_dot = dx * ax[0] + dy * ax[1] + dz * ax[2]
        oc_dot = _dot(oc, ax)
        dp = (dx - ax[0] * dir_dot, dy - ax[1] * dir_dot, dz - ax[2] * dir_dot)
        op = (oc[0] - ax[0] * oc_dot, oc[1] - ax[1] * oc_dot, oc[2] - ax[2] * oc_dot)
        a_q = _dot(dp, dp)
        b_q = xp.c(2.0) * _dot(dp, op)
        c_q = _dot(op, op) - ra * ra
        disc = b_q * b_q - xp.c(4.0) * a_q * c_q
        okq = (a_q > xp.c(1e-8)) & (disc >= 0.0)
        sq = xp.sqrt(xp.where(okq, disc, xp.c(0.0)))
        den = xp.where(okq, xp.c(2.0) * a_q, xp.c(1.0))
        t1c = (-b_q - sq) / den
        t2c = (-b_q + sq) / den
        h1 = oc_dot + t1c * dir_dot
        h2 = oc_dot + t2c * dir_dot
        ok1 = okq & (t1c > tmin) & (h1 >= 0.0) & (h1 <= height)
        ok2 = okq & ~ok1 & (t2c > tmin) & (h2 >= 0.0) & (h2 <= height)
        tc = xp.where(ok1, t1c, xp.where(ok2, t2c, xp.c(-1.0)))
        for cap, sign in ((p1, xp.c(-1.0)), (p2, xp.c(1.0))):
            q = (ox - cap[0], oy - cap[1], oz - cap[2])
            bq = q[0] * dx + q[1] * dy + q[2] * dz
            cq = _dot(q, q) - ra * ra
            dq = bq * bq - cq
            okc = dq >= 0.0
            sqc = xp.sqrt(xp.where(okc, dq, xp.c(0.0)))
            tq = xp.where(-bq - sqc > tmin, -bq - sqc, -bq + sqc)
            tq = xp.where(okc & (tq > tmin), tq, xp.c(-1.0))
            h = ((q[0] + dx * tq) * ax[0] + (q[1] + dy * tq) * ax[1]
                 + (q[2] + dz * tq) * ax[2])
            better = (tq > tmin) & ((tc < 0.0) | (tq < tc)) & ((h * sign) >= 0.0)
            tc = xp.where(better, tq, tc)
        q = (ox - p1[0], oy - p1[1], oz - p1[2])
        bq = q[0] * dx + q[1] * dy + q[2] * dz
        cq = _dot(q, q) - ra * ra
        dq = bq * bq - cq
        okc = dq >= 0.0
        sqc = xp.sqrt(xp.where(okc, dq, xp.c(0.0)))
        tq = xp.where(-bq - sqc > tmin, -bq - sqc, -bq + sqc)
        tq = xp.where(okc & (tq > tmin), tq, xp.c(-1.0))
        tc = xp.where(degen, tq, tc)
        t[:, sc.idx_cylinder] = tc

    if sc.tri_count:
        pa = sc.prim_a[None, sc.idx_triangle]
        pb = sc.prim_b[None, sc.idx_triangle]
        pc = sc.prim_c[None, sc.idx_triangle]
        v0 = (pa[..., 0], pa[..., 1], pa[..., 2])
        e1 = (pb[..., 0] - v0[0], pb[..., 1] - v0[1], pb[..., 2] - v0[2])
        e2 = (pc[..., 0] - v0[0], pc[..., 1] - v0[1], pc[..., 2] - v0[2])
        px = dy * e2[2] - dz * e2[1]
        py = dz * e2[0] - dx * e2[2]
        pz = dx * e2[1] - dy * e2[0]
        det = e1[0] * px + e1[1] * py + e1[2] * pz
        okt = abs(det) >= xp.c(1e-6)
        inv = xp.recip(xp.where(okt, det, xp.c(1.0)))
        tv = (ox - v0[0], oy - v0[1], oz - v0[2])
        u = (tv[0] * px + tv[1] * py + tv[2] * pz) * inv
        qx = tv[1] * e1[2] - tv[2] * e1[1]
        qy = tv[2] * e1[0] - tv[0] * e1[2]
        qz = tv[0] * e1[1] - tv[1] * e1[0]
        v = (dx * qx + dy * qy + dz * qz) * inv
        tt = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
        okt = okt & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > tmin)
        tt = xp.where(okt, tt, xp.c(-1.0))
        if clip is not None:
            normal, offset, side = clip
            hx = ox + dx * tt
            hy = oy + dy * tt
            hz = oz + dz * tt
            s = (hx * xp.c(normal[0]) + hy * xp.c(normal[1]) + hz * xp.c(normal[2])
                 - xp.c(offset))
            tt = xp.where(s * xp.c(side) > 0.0, xp.c(-1.0), tt)
        t[:, sc.idx_triangle] = tt

    return t


# --------------------------------------------------------------------------
# The card trace: _intersect_all on torch tensors on a CUDA device, one
# eager tensor op per numpy op, in the same order, so nothing contracts a
# multiply into an add. A constant enters as the float32 value numpy's F(v)
# holds, and a reciprocal divides by a tensor (a Python-scalar divisor
# becomes a multiply by its reciprocal on CUDA), so each op rounds as
# numpy's does.

_CARD_PAIRS = 1 << 25     # ray-prim pairs a chunk (128 MB per f32 temporary)


def _c(v) -> float:
    return float(np.float32(v))


_BIG = _c(1e20)


def _sqrt(x):
    # IEEE-rounded on the card. CPU tensors (which only the tests hand in)
    # round through float64: torch's CPU f32 sqrt is not correctly rounded
    # on every machine.
    return x.sqrt() if x.is_cuda else x.double().sqrt().float()


class _CardScene:
    """_NpScene's primitive table as tensors on `device`."""

    def __init__(self, sc: _NpScene, device):
        import torch

        self.device = torch.device(device)

        def put(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        self.prim_a, self.prim_b, self.prim_c = put(sc.prim_a), put(sc.prim_b), put(sc.prim_c)
        self.idx_sphere = put(sc.idx_sphere, torch.int64)
        self.idx_cylinder = put(sc.idx_cylinder, torch.int64)
        self.idx_triangle = put(sc.idx_triangle, torch.int64)
        self.sphere_count = sc.sphere_count
        self.cylinder_count = sc.cylinder_count
        self.tri_count = sc.tri_count
        self.prim_count = sc.prim_count
        self.ops = SimpleNamespace(
            where=torch.where, sqrt=_sqrt, c=_c,
            recip=lambda x: torch.div(torch.ones_like(x), x),
            misses=lambda n, p: torch.full((n, p), -1.0, dtype=torch.float32,
                                           device=self.device))


def _card_chunks(cs: _CardScene, mask, n, *arrays):
    """(live lane indices, chunks of the live lanes' operands on the card):
    a masked-off lane's result is fixed (a miss), so only live lanes go."""
    import torch

    live = np.arange(n) if mask is None else np.nonzero(mask)[0]
    ops = [torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.float32)[live]),
                           device=cs.device) for a in arrays]
    step = max(1, _CARD_PAIRS // max(cs.prim_count, 1))
    return live, [[x[s:s + step] for x in ops] for s in range(0, live.size, step)]


def _card_closest(cs: _CardScene, o, d, tmin_b, clip, mask):
    import torch

    n = o[0].shape[0]
    t_out = np.full(n, BIG, np.float32)
    row_out = np.full(n, -1, np.int32)
    live, chunks = _card_chunks(cs, mask, n, *o, *d, tmin_b)
    ts, rows = [], []
    for ch in chunks:
        tall = _intersect_all(cs, ch[0:3], ch[3:6], ch[6], clip)
        tm = torch.where(tall > 0.0, tall, _BIG)
        row = torch.argmin(tm, dim=1)
        tbest = tm.gather(1, row[:, None])[:, 0]
        hit = tbest < _BIG
        ts.append(torch.where(hit, tbest, _BIG))
        rows.append(torch.where(hit, row, -1))
    if ts:
        t_out[live] = torch.cat(ts).cpu().numpy()
        row_out[live] = torch.cat(rows).cpu().numpy()
    return t_out, row_out


def _card_any(cs: _CardScene, o, d, tmin_b, clip, accept_lo, t_hi, mask):
    import torch

    n = o[0].shape[0]
    found = np.zeros(n, bool)
    lo = np.broadcast_to(np.asarray(accept_lo, np.float32), (n,))
    hi = np.broadcast_to(np.asarray(t_hi, np.float32), (n,))
    live, chunks = _card_chunks(cs, mask, n, *o, *d, tmin_b, lo, hi)
    out = []
    for ch in chunks:
        tall = _intersect_all(cs, ch[0:3], ch[3:6], ch[6], clip)
        out.append(((tall > ch[7][:, None]) & (tall < ch[8][:, None])).any(dim=1))
    if out:
        found[live] = torch.cat(out).cpu().numpy()
    return found


def trace_closest(sc: _NpScene, o, d, tmin, clip, mask=None):
    """Closest hit: (t [N], prim_row [N] with -1 miss)."""
    tmin_b = np.broadcast_to(F(tmin), o[0].shape).astype(np.float32)
    if sc.card is not None:
        return _card_closest(sc.card, o, d, tmin_b, clip, mask)
    tall = _intersect_all(sc, o, d, tmin_b, clip)
    valid = tall > 0.0
    if mask is not None:
        valid &= mask[:, None]
    tm = np.where(valid, tall, BIG)
    row = np.argmin(tm, axis=1).astype(np.int32)
    tbest = tm[np.arange(tm.shape[0]), row]
    hit = tbest < BIG
    row = np.where(hit, row, -1)
    return np.where(hit, tbest, BIG), row


def trace_any(sc: _NpScene, o, d, tmin, clip, accept_lo, t_hi, mask=None):
    tmin_b = np.broadcast_to(F(tmin), o[0].shape).astype(np.float32)
    if sc.card is not None:
        return _card_any(sc.card, o, d, tmin_b, clip, accept_lo, t_hi, mask)
    tall = _intersect_all(sc, o, d, tmin_b, clip)
    ok = (tall > accept_lo[:, None]) & (tall < t_hi[:, None])
    found = np.any(ok, axis=1)
    if mask is not None:
        found &= mask
    return found


# --------------------------------------------------------------------------
# BRDF terms (webgl.js:175-209, 1056-1092, 1155-1171).

def distribution_ggx(ndoth, rough):
    a = rough * rough
    a2 = a * a
    denom = (ndoth * ndoth) * (a2 - F(1.0)) + F(1.0)
    return a2 / (PI * denom * denom + F(1e-6))


def geometry_schlick_ggx(ndotv, rough):
    r = rough + F(1.0)
    k = (r * r) / F(8.0)
    return ndotv / (ndotv * (F(1.0) - k) + k + F(0.0001))


def geometry_smith(ndv, ndl, rough):
    return geometry_schlick_ggx(ndv, rough) * geometry_schlick_ggx(ndl, rough)


def fresnel_schlick(cos_theta, f0):
    w = np.power(np.clip(F(1.0) - cos_theta, 0.0, 1.0), F(5.0))
    return (f0[0] + (F(1.0) - f0[0]) * w, f0[1] + (F(1.0) - f0[1]) * w,
            f0[2] + (F(1.0) - f0[2]) * w)


def wrap_ndotl(ndl, wrap):
    return np.clip((ndl + wrap) / (F(1.0) + wrap), 0.0, 1.0)


def eval_diffuse_brdf(n, v, l, base_color, diff_rough, wrap):
    """Lambert or Oren-Nayar + wrap scale (webgl.js:175-209)."""
    if diff_rough > 1e-4:
        ndl = np.maximum(_dot(n, l), F(0.0))
        ndv = np.maximum(_dot(n, v), F(0.0))
        sigma2 = F(diff_rough) * F(diff_rough)
        a = F(1.0) - F(0.5) * (sigma2 / (sigma2 + F(0.33)))
        b = F(0.45) * (sigma2 / (sigma2 + F(0.09)))
        sin_l = np.sqrt(np.maximum(F(0.0), F(1.0) - ndl * ndl))
        sin_v = np.sqrt(np.maximum(F(0.0), F(1.0) - ndv * ndv))
        tan_l = sin_l / np.maximum(ndl, F(1e-4))
        tan_v = sin_v / np.maximum(ndv, F(1e-4))
        sin_alpha = np.maximum(sin_l, sin_v)
        tan_beta = np.minimum(tan_l, tan_v)
        lp = _norm((l[0] - n[0] * ndl, l[1] - n[1] * ndl, l[2] - n[2] * ndl))
        vp = _norm((v[0] - n[0] * ndv, v[1] - n[1] * ndv, v[2] - n[2] * ndv))
        cos_phi = np.maximum(F(0.0), _dot(lp, vp))
        oren = (a + b * cos_phi * sin_alpha * tan_beta) / PI
        lit = (ndl > 0.0) & (ndv > 0.0)
        w = np.where(lit, oren, F(0.0))
        brdf = (base_color[0] * w, base_color[1] * w, base_color[2] * w)
    else:
        brdf = (base_color[0] / PI, base_color[1] / PI, base_color[2] / PI)
    if wrap > 0.0:
        ndl = np.maximum(_dot(n, l), F(0.0))
        scale = np.where(ndl > 1e-4, wrap_ndotl(ndl, F(wrap)) / np.maximum(ndl, F(1e-4)), F(0.0))
        brdf = (brdf[0] * scale, brdf[1] * scale, brdf[2] * scale)
    return brdf


def brdf_pdf(n, v, l, rough, spec_prob):
    ndl = np.maximum(_dot(n, l), F(0.0))
    diff_pdf = ndl / PI
    h = _norm((v[0] + l[0], v[1] + l[1], v[2] + l[2]))
    ndoth = np.maximum(_dot(n, h), F(0.001))
    vdoth = np.maximum(_dot(v, h), F(0.001))
    dd = distribution_ggx(ndoth, rough)
    spec_pdf = dd * ndoth / (F(4.0) * vdoth)
    pdf = spec_prob * spec_pdf + (F(1.0) - spec_prob) * diff_pdf
    return np.where(ndl > 0.0, pdf, F(0.0))


def power_heuristic(pa, pb):
    a2 = pa * pa
    b2 = pb * pb
    return a2 / np.maximum(a2 + b2, F(1e-8))


# --------------------------------------------------------------------------
# Environment (webgl.js:211-268, 910-983): bilinear equirect + CDF sampling.

class _NpEnv:
    def __init__(self, env):
        self.radiance = _host(env.radiance).astype(np.float32)
        self.marginal_cdf = _host(env.marginal_cdf).astype(np.float32)
        self.conditional_cdf = _host(env.conditional_cdf).astype(np.float32)
        self.width = int(env.width)
        self.height = int(env.height)


def _dir_to_uv(d):
    u = np.arctan2(d[2], d[0]).astype(np.float32) / TWO_PI + F(0.5)
    v = np.arccos(np.clip(d[1], -1.0, 1.0)).astype(np.float32) / PI
    return u, v


def sample_env_radiance(env: _NpEnv, d, intensity, max_lum):
    u, v = _dir_to_uv(d)
    h, w = env.height, env.width
    x = u * F(w) - F(0.5)
    y = v * F(h) - F(0.5)
    x0 = np.clip(np.floor(x).astype(np.int32), 0, w - 1)
    y0 = np.clip(np.floor(y).astype(np.int32), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    fx = np.clip(x - np.floor(x), 0.0, 1.0).astype(np.float32)
    fy = np.clip(y - np.floor(y), 0.0, 1.0).astype(np.float32)
    img = env.radiance
    c00 = img[y0, x0]
    c10 = img[y0, x1]
    c01 = img[y1, x0]
    c11 = img[y1, x1]
    color = ((c00 * (1 - fx)[:, None] + c10 * fx[:, None]) * (1 - fy)[:, None]
             + (c01 * (1 - fx)[:, None] + c11 * fx[:, None]) * fy[:, None])
    color = color * F(intensity)
    lum = color[:, 0] * F(0.2126) + color[:, 1] * F(0.7152) + color[:, 2] * F(0.0722)
    if max_lum > 0.0:
        excess = lum - F(max_lum)
        compressed = F(max_lum) + excess / (F(1.0) + excess / F(max_lum))
        scale = np.where(lum > max_lum, compressed / np.maximum(lum, F(1e-12)), F(1.0))
        color = color * scale[:, None]
    return (color[:, 0], color[:, 1], color[:, 2])


def _search_cdf(cdf_rows, row_idx, size, xi):
    """binarySearchCdf (webgl.js:244-268) vectorized; cdf_rows is [R, size]
    or [size] (row_idx ignored)."""
    def fetch(i):
        if cdf_rows.ndim == 1:
            return cdf_rows[i]
        return cdf_rows[row_idx, i]

    lo = np.zeros_like(xi, np.int32)
    hi = np.full_like(lo, size - 1)
    while True:
        cont = lo < hi
        if not np.any(cont):
            break
        mid = (lo + hi) // 2
        val = fetch(mid)
        go_right = cont & (val <= xi)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(cont & ~go_right, mid, hi)
    idx = np.maximum(lo - 1, 0)
    c_lo = fetch(idx)
    c_hi = fetch(idx + 1)
    tt = np.where(c_hi > c_lo,
                  np.clip((xi - c_lo) / np.where(c_hi > c_lo, c_hi - c_lo, F(1.0)), 0.0, 1.0),
                  F(0.0))
    return idx, idx.astype(np.float32) + tt


def sample_env_direction(env: _NpEnv, r1, r2):
    h, w = env.height, env.width
    v_idx_raw, v_float = _search_cdf(env.marginal_cdf, None, h + 1, r1)
    v_idx = np.clip(v_idx_raw, 0, h - 1)
    v = (v_float + F(0.5)) / F(h)
    u_idx_raw, u_float = _search_cdf(env.conditional_cdf, v_idx, w + 1, r2)
    u = (u_float + F(0.5)) / F(w)
    theta = v * PI
    phi = u * TWO_PI - PI
    sin_t = np.sin(theta).astype(np.float32)
    d = (sin_t * np.cos(phi).astype(np.float32), np.cos(theta).astype(np.float32),
         sin_t * np.sin(phi).astype(np.float32))
    marginal_pdf = env.marginal_cdf[v_idx + 1] - env.marginal_cdf[v_idx]
    u_bin = u_float.astype(np.int32)
    conditional_pdf = env.conditional_cdf[v_idx, u_bin + 1] - env.conditional_cdf[v_idx, u_bin]
    pdf_uv = marginal_pdf * F(h) * conditional_pdf * F(w)
    pdf = pdf_uv / (F(2.0) * PI * PI * np.maximum(sin_t, F(1e-4)))
    return d, np.maximum(pdf, F(1e-6))


def env_pdf(env: _NpEnv, d):
    u, v = _dir_to_uv(d)
    w, h = env.width, env.height
    u_idx = np.clip((u * F(w)).astype(np.int32), 0, w - 1)
    v_idx = np.clip((v * F(h)).astype(np.int32), 0, h - 1)
    marginal_pdf = env.marginal_cdf[v_idx + 1] - env.marginal_cdf[v_idx]
    conditional_pdf = env.conditional_cdf[v_idx, u_idx + 1] - env.conditional_cdf[v_idx, u_idx]
    pdf_uv = marginal_pdf * F(h) * conditional_pdf * F(w)
    sin_t = np.maximum(np.sin(v * PI).astype(np.float32), F(1e-4))
    return np.maximum(pdf_uv / (F(2.0) * PI * PI * sin_t), F(1e-6))


# --------------------------------------------------------------------------
# Volume march (webgl.js:1191-1221), trilinear 3D sample (:417-421).

class _NpVol:
    def __init__(self, vol):
        self.data = _host(vol.data).astype(np.float32)
        self.vmin = _host(vol.vmin).astype(np.float32)
        self.vmax = _host(vol.vmax).astype(np.float32)
        self.max_value = float(_host(vol.max_value))
        self.nx, self.ny, self.nz = int(vol.nx), int(vol.ny), int(vol.nz)


def _sample_volume(vol: _NpVol, px, py, pz):
    inv = F(1.0) / np.maximum(vol.vmax - vol.vmin, F(1e-12))
    u = np.clip((px - vol.vmin[0]) * inv[0], 0.0, 1.0)
    v = np.clip((py - vol.vmin[1]) * inv[1], 0.0, 1.0)
    w = np.clip((pz - vol.vmin[2]) * inv[2], 0.0, 1.0)
    dims = (vol.nx, vol.ny, vol.nz)
    xyz = [u * F(dims[0]) - F(0.5), v * F(dims[1]) - F(0.5), w * F(dims[2]) - F(0.5)]
    i0 = [np.clip(np.floor(c).astype(np.int32), 0, dims[k] - 1) for k, c in enumerate(xyz)]
    i1 = [np.clip(i0[k] + 1, 0, dims[k] - 1) for k in range(3)]
    f = [np.clip(c - np.floor(c), 0.0, 1.0).astype(np.float32) for c in xyz]
    d = vol.data
    c000 = d[i0[2], i0[1], i0[0]]
    c100 = d[i0[2], i0[1], i1[0]]
    c010 = d[i0[2], i1[1], i0[0]]
    c110 = d[i0[2], i1[1], i1[0]]
    c001 = d[i1[2], i0[1], i0[0]]
    c101 = d[i1[2], i0[1], i1[0]]
    c011 = d[i1[2], i1[1], i0[0]]
    c111 = d[i1[2], i1[1], i1[0]]
    c00 = c000 * (1 - f[0]) + c100 * f[0]
    c10 = c010 * (1 - f[0]) + c110 * f[0]
    c01 = c001 * (1 - f[0]) + c101 * f[0]
    c11 = c011 * (1 - f[0]) + c111 * f[0]
    c0 = c00 * (1 - f[1]) + c10 * f[1]
    c1 = c01 * (1 - f[1]) + c11 * f[1]
    return c0 * (1 - f[2]) + c1 * f[2]


def _march_volume(vol, o, d, t_surface, u, flags, throughput, radiance, alive):
    """In-loop volume march; returns new (radiance, throughput) triples.
    Follows the GLSL exactly, including the tCurrent > tExit break and the
    1e-3 throughput kill."""
    tmin = F(float(u.t_min))
    # AABB slab range (webgl.js:316-341).
    tn = np.full_like(o[0], -BIG)
    tf = np.full_like(o[0], BIG)
    ok = np.ones(o[0].shape, bool)
    for axis in range(3):
        da = d[axis]
        oa = o[axis]
        lo, hi = F(vol.vmin[axis]), F(vol.vmax[axis])
        parallel = np.abs(da) < F(1e-8)
        inv = F(1.0) / np.where(parallel, F(1.0), da)
        t1 = (lo - oa) * inv
        t2 = (hi - oa) * inv
        tn = np.maximum(tn, np.where(parallel, -BIG, np.minimum(t1, t2)))
        tf = np.minimum(tf, np.where(parallel, BIG, np.maximum(t1, t2)))
        ok &= ~parallel | ((oa >= lo) & (oa <= hi))
    hit_box = ok & (tf >= np.maximum(tn, F(0.0)))
    t_enter = np.maximum(np.maximum(tn, F(0.0)), tmin)
    t_exit = np.minimum(tf, t_surface)
    step = F(float(u.volume_step))
    run = alive & hit_box & (t_exit > t_enter) & (step > 0.0)
    if not np.any(run):
        return radiance, throughput
    inv_max = F(1.0) / max(vol.max_value, 1e-6)
    tp = [c.copy() for c in throughput]
    rad = [c.copy() for c in radiance]
    t_cur = t_enter.copy()
    live = run.copy()
    for _ in range(int(flags.volume_max_steps)):
        live = live & (t_cur <= t_exit)
        if not np.any(live):
            break
        dt = np.minimum(step, t_exit - t_cur)
        px_ = o[0] + d[0] * t_cur
        py_ = o[1] + d[1] * t_cur
        pz_ = o[2] + d[2] * t_cur
        density = _sample_volume(vol, px_, py_, pz_) * inv_max
        density = np.maximum(F(0.0), density - F(float(u.volume_threshold)))
        pos_d = live & (density > 0.0)
        alpha = F(1.0) - np.exp(-density * F(float(u.volume_density)) * dt)
        alpha = np.clip(alpha * F(float(u.volume_opacity)), 0.0, 1.0)
        alpha = np.where(pos_d, alpha, F(0.0))
        vc = np.asarray(u.volume_color, np.float32)
        for c in range(3):
            rad[c] = rad[c] + tp[c] * F(vc[c]) * alpha
            tp[c] = tp[c] * (F(1.0) - alpha)
        mx = np.maximum(tp[0], np.maximum(tp[1], tp[2]))
        dead = pos_d & (mx < F(1e-3))
        for c in range(3):
            tp[c] = np.where(dead, F(0.0), tp[c])
        live = live & ~dead
        t_cur = t_cur + step
    return (rad[0], rad[1], rad[2]), (tp[0], tp[1], tp[2])


# --------------------------------------------------------------------------
# The transport (webgl.js:1173-1441 tracePath + :1508-1549 main).

# _NpScene per (scene object, trace device): render_batch_oracle is called
# once per chunk-frame, and the primitive table (and its card copy) is
# built once. Strong refs are intentional: a dozen scenes per parity run,
# and holding them keeps id() unique.
_NPSCENE_CACHE: dict = {}


def _np_scene(scene, trace_device=None) -> _NpScene:
    if trace_device is not None:
        import torch

        trace_device = torch.device(trace_device)
        if trace_device.type != "cuda":
            raise ValueError(f"the oracle's card trace needs a CUDA device, not "
                             f"{trace_device}: on the CPU the oracle traces with numpy")
    key = (id(scene), str(trace_device))
    hit = _NPSCENE_CACHE.get(key)
    if hit is not None and hit[0] is scene:
        return hit[1]
    sc = _NpScene(scene, trace_device)
    _NPSCENE_CACHE[key] = (scene, sc)
    return sc


def _host_uniforms(u) -> SimpleNamespace:
    """render/config.Uniforms (tensors on any device) as numpy values."""
    return SimpleNamespace(**{f.name: _host(getattr(u, f.name)) for f in fields(u)})


def render_batch_oracle(scene, env, flags, u, px, py, frame_index, trace_device=None,
                        vol=None):
    """One progressive frame: the exact reference estimator, per pixel.

    Mirrors render/integrator.render_batch's inputs (scene, env: EnvBuffers
    or None, flags, uniforms, pixel coordinates, vol: VolumeBuffers or
    None) and returns [N,3] f32 numpy colour with exposure applied
    (webgl.js:1520-1549). trace_device: None traces with numpy; a CUDA
    device traces on that card.
    """
    if flags.volume_enabled and vol is None:
        raise ValueError("flags.volume_enabled is set but no volume was given")
    sc = _np_scene(scene, trace_device)
    np_env = _NpEnv(env) if (flags.use_env and env is not None) else None
    np_vol = _NpVol(vol) if flags.volume_enabled else None
    u = _host_uniforms(u)
    px = _host(px)
    py = _host(py)
    n = px.shape[0]
    total = [np.zeros(n, np.float32) for _ in range(3)]
    for s in range(flags.spp):
        r = _trace_sample(sc, np_env, np_vol, flags, u, px, py, frame_index, s)
        for c in range(3):
            total[c] += r[c]
    inv = F(1.0 / flags.spp) * F(float(u.exposure))
    return np.stack([total[0] * inv, total[1] * inv, total[2] * inv], axis=-1)


def _trace_sample(sc, env, vol, flags, u, px, py, frame_index, s):
    # Dead/masked lanes carry 1e20 positions whose arithmetic overflows
    # harmlessly (results fully masked) — suppress the noise for the whole
    # per-sample transport.
    _err = np.seterr(over="ignore", invalid="ignore")
    try:
        return _trace_sample_impl(sc, env, vol, flags, u, px, py, frame_index, s)
    finally:
        np.seterr(**_err)


def _trace_sample_impl(sc, env, vol, flags, u, px, py, frame_index, s):
    n = px.shape[0]
    f32u = lambda name: F(float(getattr(u, name)))  # noqa: E731
    res = np.asarray(u.resolution, np.float32)
    cam_o = np.asarray(u.cam_origin, np.float32)
    fwd = np.asarray(u.cam_forward, np.float32)
    right = np.asarray(u.cam_right, np.float32)
    up = np.asarray(u.cam_up, np.float32)

    state = init_seed(px, py, frame_index, s)
    state, jx = rand(state)
    state, jy = rand(state)
    pixel_x = px.astype(np.float32) + F(0.5) + (jx - F(0.5))
    pixel_y = py.astype(np.float32) + F(0.5) + (jy - F(0.5))
    uvx = (pixel_x + F(0.5)) / res[0] * F(2.0) - F(1.0)
    uvy = (pixel_y + F(0.5)) / res[1] * F(2.0) - F(1.0)
    d = _norm((fwd[0] + uvx * right[0] + uvy * up[0],
               fwd[1] + uvx * right[1] + uvy * up[1],
               fwd[2] + uvx * right[2] + uvy * up[2]))
    o = (np.full(n, cam_o[0], np.float32), np.full(n, cam_o[1], np.float32),
         np.full(n, cam_o[2], np.float32))

    if flags.dof_enabled:
        fwd_n = fwd / np.linalg.norm(fwd)
        right_n = right / np.linalg.norm(right)
        up_n = up / np.linalg.norm(up)
        denom = np.maximum(d[0] * F(fwd_n[0]) + d[1] * F(fwd_n[1]) + d[2] * F(fwd_n[2]), F(1e-4))
        t_focus = f32u("dof_focus_distance") / denom
        focus = (o[0] + d[0] * t_focus, o[1] + d[1] * t_focus, o[2] + d[2] * t_focus)
        state, l1 = rand(state)
        state, l2 = rand(state)
        r_l = np.sqrt(l1)
        phi_l = TWO_PI * l2
        lx = np.cos(phi_l).astype(np.float32) * r_l * f32u("dof_aperture")
        ly = np.sin(phi_l).astype(np.float32) * r_l * f32u("dof_aperture")
        o = (o[0] + F(right_n[0]) * lx + F(up_n[0]) * ly,
             o[1] + F(right_n[1]) * lx + F(up_n[1]) * ly,
             o[2] + F(right_n[2]) * lx + F(up_n[2]) * ly)
        d = _norm((focus[0] - o[0], focus[1] - o[1], focus[2] - o[2]))

    bias = np.maximum(f32u("ray_bias"), F(1e-4))
    t_min = f32u("t_min")
    clip = None
    if flags.clip_enabled:
        clip = (np.asarray(u.clip_normal, np.float32), float(u.clip_offset),
                float(u.clip_side))

    radiance = (np.zeros(n, np.float32),) * 3
    radiance = tuple(c.copy() for c in radiance)
    throughput = tuple(np.ones(n, np.float32) for _ in range(3))
    last_pdf = np.zeros(n, np.float32)
    alive = np.ones(n, bool)

    ambient = np.asarray(u.ambient_color, np.float32) * f32u("ambient_intensity")

    for bounce in range(flags.max_bounces):
        if not np.any(alive):
            break
        t, row = trace_closest(sc, o, d, t_min, clip, mask=alive)
        hit = row >= 0
        t_surface = np.where(hit, t, BIG)

        if vol is not None:
            radiance, throughput = _march_volume(
                vol, o, d, t_surface, u, flags, throughput, radiance, alive)

        # Miss -> environment + ambient, with MIS after bounce 0 (:1223-1235).
        env_c = [np.full(n, ambient[c], np.float32) for c in range(3)]
        if env is not None:
            er = sample_env_radiance(env, d, f32u("env_intensity"), float(u.env_max_luminance))
            for c in range(3):
                env_c[c] = env_c[c] + er[c]
            mis_w = np.where((bounce > 0) & (last_pdf > 0.0),
                             power_heuristic(last_pdf, env_pdf(env, d)), F(1.0))
        else:
            mis_w = F(1.0)
        miss = alive & ~hit
        for c in range(3):
            radiance[c][miss] += (throughput[c] * env_c[c] * mis_w)[miss]
        alive = alive & hit
        if not np.any(alive):
            break

        # Surface reconstruction (:1244-1272).
        pos = (o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t)
        rsafe = np.maximum(row, 0)
        pa = sc.prim_a[rsafe]
        pb = sc.prim_b[rsafe]
        pc = sc.prim_c[rsafe]
        ptype = sc.prim_type[rsafe]
        plocal = sc.prim_local[rsafe]
        zero = np.zeros(n, np.float32)
        n_raw = (zero.copy(), zero.copy(), zero.copy())
        shading = None

        if sc.sphere_count:
            ns = _norm((pos[0] - pa[:, 0], pos[1] - pa[:, 1], pos[2] - pa[:, 2]))
            n_raw = _where(ptype == PRIM_SPHERE, ns, n_raw)
        if sc.cylinder_count:
            axis = _norm((pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1], pb[:, 2] - pa[:, 2]))
            rel = (pos[0] - pa[:, 0], pos[1] - pa[:, 1], pos[2] - pa[:, 2])
            h = _dot(rel, axis)
            av = (pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1], pb[:, 2] - pa[:, 2])
            height = np.sqrt(_dot(av, av))
            degen = height < F(1e-6)
            cap1 = (~degen) & (h < 0.0)
            cap2 = (~degen) & (h > height)
            side = (rel[0] - axis[0] * h, rel[1] - axis[1] * h, rel[2] - axis[2] * h)
            ncyl = _where(cap1, _norm(rel),
                          _where(cap2, _norm((pos[0] - pb[:, 0], pos[1] - pb[:, 1],
                                              pos[2] - pb[:, 2])), _norm(side)))
            ncyl = _where(degen, _norm(rel), ncyl)
            n_raw = _where(ptype == PRIM_CYLINDER, ncyl, n_raw)
        if sc.tri_count:
            e1 = (pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1], pb[:, 2] - pa[:, 2])
            e2 = (pc[:, 0] - pa[:, 0], pc[:, 1] - pa[:, 1], pc[:, 2] - pa[:, 2])
            ntri = _norm(_cross(e1, e2))
            n_raw = _where(ptype == PRIM_TRIANGLE, ntri, n_raw)

        front = _dot(n_raw, d) < 0.0
        n_geom = _where(front, n_raw, (-n_raw[0], -n_raw[1], -n_raw[2]))
        shading = n_geom

        if sc.tri_count:
            # Barycentric re-derivation for the winning triangle.
            e1 = (pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1], pb[:, 2] - pa[:, 2])
            e2 = (pc[:, 0] - pa[:, 0], pc[:, 1] - pa[:, 1], pc[:, 2] - pa[:, 2])
            pvec = _cross(d, e2)
            det = _dot(e1, pvec)
            inv = F(1.0) / np.where(np.abs(det) >= 1e-6, det, F(1.0))
            tv = (o[0] - pa[:, 0], o[1] - pa[:, 1], o[2] - pa[:, 2])
            bu = _dot(tv, pvec) * inv
            qv = _cross(tv, e1)
            bv = _dot(d, qv) * inv
            b0 = F(1.0) - bu - bv
            tn = sc.tri_normals[np.maximum(plocal, 0)]
            sn_t = _norm((b0 * tn[:, 0, 0] + bu * tn[:, 1, 0] + bv * tn[:, 2, 0],
                          b0 * tn[:, 0, 1] + bu * tn[:, 1, 1] + bv * tn[:, 2, 1],
                          b0 * tn[:, 0, 2] + bu * tn[:, 1, 2] + bv * tn[:, 2, 2]))
            flip = _dot(sn_t, n_geom) < 0.0
            sn_t = _where(flip, (-sn_t[0], -sn_t[1], -sn_t[2]), sn_t)
            shading = _where(ptype == PRIM_TRIANGLE, sn_t, shading)

        if flags.use_imported_color:
            col = sc.prim_color[rsafe]
            base_color = (col[:, 0], col[:, 1], col[:, 2])
        else:
            bc = np.asarray(u.base_color, np.float32)
            base_color = (np.full(n, bc[0], np.float32), np.full(n, bc[1], np.float32),
                          np.full(n, bc[2], np.float32))

        v = (-d[0], -d[1], -d[2])

        # Glass / translucent transmission (:1276-1313) — per-lane draws.
        transmit = np.zeros(n, bool)
        if flags.material_mode in (2, 3):
            if flags.material_mode == 2:
                glass_lane = ptype == PRIM_TRIANGLE
                if flags.surface_flag_mode != 0 and sc.tri_count:
                    glass_lane &= sc.tri_flags[np.maximum(plocal, 0)] > 0.5
            else:
                glass_lane = np.ones(n, bool)
            glass_lane = alive & glass_lane
            state, r_op = rand(state, mask=glass_lane)
            transmit = glass_lane & (r_op >= f32u("surface_opacity"))

            cosi = np.clip(-_dot(d, n_geom), 0.0, 1.0)
            ior = F(float(u.surface_ior))
            f0s = ((ior - F(1.0)) / (ior + F(1.0))) ** 2
            fres = f0s + (F(1.0) - f0s) * np.power(np.clip(F(1.0) - cosi, 0.0, 1.0), F(5.0))
            eta = np.where(front, F(1.0) / np.maximum(ior, F(1e-3)), np.maximum(ior, F(1e-3)))
            sin2 = eta * eta * (F(1.0) - cosi * cosi)
            can_refract = sin2 <= 1.0
            cost = np.sqrt(np.maximum(F(0.0), F(1.0) - sin2))
            k = eta * cosi - cost
            refr = (eta * d[0] + k * n_geom[0], eta * d[1] + k * n_geom[1],
                    eta * d[2] + k * n_geom[2])
            reflect_prob = np.where(can_refract, fres, F(1.0))

            state, r_ref = rand(state, mask=transmit)
            do_reflect = transmit & (r_ref < reflect_prob)
            refl = (d[0] - 2 * _dot(d, n_geom) * n_geom[0],
                    d[1] - 2 * _dot(d, n_geom) * n_geom[1],
                    d[2] - 2 * _dot(d, n_geom) * n_geom[2])
            if flags.material_mode == 3:
                trans_rough = float(np.clip(float(u.roughness), 0.02, 1.0))
                if trans_rough > 0.02:
                    # reflectSample (:1014-1029): 2 draws; sampleAroundDirection
                    # (:1031-1039): 2 draws — same count on both branches.
                    state, s1 = rand(state, mask=transmit)
                    state, s2 = rand(state, mask=transmit)
                    phi = TWO_PI * s1
                    cos_t = np.power(F(1.0) - s2, F(1.0) / (F(trans_rough) * F(4.0) + F(1.0)))
                    sin_t = np.sqrt(np.maximum(F(0.0), F(1.0) - cos_t * cos_t))
                    refl_dir = _to_world(_norm(refl), np.cos(phi).astype(np.float32) * sin_t,
                                         np.sin(phi).astype(np.float32) * sin_t, cos_t)
                    cone_angle = F(np.clip(trans_rough * trans_rough * 0.75, 0.0, 1.2))
                    cos_max = np.cos(cone_angle)
                    cos_tc = cos_max + (F(1.0) - cos_max) * s1
                    sin_tc = np.sqrt(np.maximum(F(0.0), F(1.0) - cos_tc * cos_tc))
                    phic = TWO_PI * s2
                    refr_dir = _to_world(_norm(refr), np.cos(phic).astype(np.float32) * sin_tc,
                                         np.sin(phic).astype(np.float32) * sin_tc, cos_tc)
                else:
                    refl_dir = _norm(refl)
                    refr_dir = _norm(refr)
            else:
                refl_dir = _norm(refl)
                refr_dir = _norm(refr)

            new_dir = _where(do_reflect, refl_dir, refr_dir)
            new_o = _where(do_reflect,
                           (pos[0] + n_geom[0] * bias, pos[1] + n_geom[1] * bias,
                            pos[2] + n_geom[2] * bias),
                           (pos[0] - n_geom[0] * bias, pos[1] - n_geom[1] * bias,
                            pos[2] - n_geom[2] * bias))
            tr = f32u("surface_transmission")
            tint = (F(1.0) + (base_color[0] - F(1.0)) * tr,
                    F(1.0) + (base_color[1] - F(1.0)) * tr,
                    F(1.0) + (base_color[2] - F(1.0)) * tr)
            tmask = transmit & ~do_reflect
            throughput = tuple(np.where(tmask, throughput[c] * tint[c], throughput[c])
                               for c in range(3))
            o = _where(transmit, new_o, o)
            d = _where(transmit, new_dir, d)
            last_pdf = np.where(transmit, F(0.0), last_pdf)

        shade_lane = alive & ~transmit

        # Material params (:1097-1102).
        use_matte = flags.material_mode == 1
        metallic = f32u("metallic") if flags.material_mode == 0 else F(0.0)
        rough = f32u("matte_roughness") if use_matte else f32u("roughness")
        diff_rough = float(u.matte_diffuse_roughness) if use_matte else 0.0
        wrap = float(u.wrap_diffuse) if use_matte else 0.0
        if use_matte:
            ms = f32u("matte_specular")
            f0 = (np.full(n, ms, np.float32),) * 3
        else:
            f0 = tuple((F(1.0) - metallic) * F(0.04) + base_color[c] * metallic
                       for c in range(3))

        # shadeDirect: 3 cone lights (:1094-1145).
        direct = (np.zeros(n, np.float32), np.zeros(n, np.float32), np.zeros(n, np.float32))
        shadow_min = np.maximum(bias, t_min)
        shadow_o = (pos[0] + n_geom[0] * bias, pos[1] + n_geom[1] * bias,
                    pos[2] + n_geom[2] * bias)
        light_dir = np.asarray(u.light_dir, np.float32)
        light_color = np.asarray(u.light_color, np.float32)
        light_int = np.asarray(u.light_intensity, np.float32)
        light_ang = np.asarray(u.light_angle, np.float32)
        for i in range(3):
            if not flags.light_enabled[i]:
                continue
            state, l1 = rand(state, mask=shade_lane)
            state, l2 = rand(state, mask=shade_lane)
            axis_c = -light_dir[i] / np.linalg.norm(light_dir[i])
            axis = (np.full(n, axis_c[0], np.float32), np.full(n, axis_c[1], np.float32),
                    np.full(n, axis_c[2], np.float32))
            cos_max = F(np.cos(light_ang[i]))
            cos_t = cos_max + (F(1.0) - cos_max) * l1
            sin_t = np.sqrt(np.maximum(F(0.0), F(1.0) - cos_t * cos_t))
            phi = TWO_PI * l2
            ldir = _to_world(axis, np.cos(phi).astype(np.float32) * sin_t,
                             np.sin(phi).astype(np.float32) * sin_t, cos_t)
            l_pdf = F(1.0) / max(2.0 * np.pi * (1.0 - float(cos_max)), 1e-6)
            ndl = np.maximum(_dot(shading, ldir), F(0.0))
            candidate = shade_lane & (ndl > 0.0)
            if flags.cast_shadows:
                occluded = trace_any(sc, shadow_o, ldir, t_min, clip,
                                     np.broadcast_to(shadow_min, (n,)).astype(np.float32),
                                     np.full(n, BIG), mask=candidate)
                lit = candidate & ~occluded
            else:
                lit = candidate
            h = _norm((v[0] + ldir[0], v[1] + ldir[1], v[2] + ldir[2]))
            ndv = np.maximum(_dot(shading, v), F(0.001))
            ndh = np.maximum(_dot(shading, h), F(0.001))
            vdh = np.maximum(_dot(v, h), F(0.001))
            dd = distribution_ggx(ndh, rough)
            g = geometry_smith(ndv, ndl, rough)
            fr = fresnel_schlick(vdh, f0)
            kspec = (dd * g) / np.maximum(F(4.0) * ndv * ndl, F(0.001))
            spec = (fr[0] * kspec, fr[1] * kspec, fr[2] * kspec)
            diff = eval_diffuse_brdf(shading, v, ldir, base_color, diff_rough, wrap)
            diff = tuple(c * (F(1.0) - metallic) for c in diff)
            brdf = tuple(spec[c] + diff[c] * (F(1.0) - fr[c]) for c in range(3))
            spec_w = np.maximum(f0[0], np.maximum(f0[1], f0[2]))
            diff_w = (F(1.0) - metallic) * np.maximum(
                base_color[0], np.maximum(base_color[1], base_color[2]))
            sumw = spec_w + diff_w
            spec_prob = np.where(sumw > 0.0, spec_w / np.maximum(sumw, F(1e-12)), F(0.5))
            pdf_b = brdf_pdf(shading, v, ldir, rough, spec_prob)
            mis = power_heuristic(l_pdf, pdf_b)
            w = ndl * mis / max(float(l_pdf), 1e-6) * F(light_int[i])
            for c in range(3):
                direct[c][lit] += (brdf[c] * F(light_color[i][c]) * w)[lit]
        for c in range(3):
            radiance[c][shade_lane] += (throughput[c] * direct[c])[shade_lane]

        # Rim boost at the primary hit (:1326-1331).
        if bounce == 0 and flags.material_mode == 0 and float(u.rim_boost) > 0.0:
            ndv = np.maximum(_dot(shading, v), F(0.0))
            rim = np.power(F(1.0) - ndv, F(3.0)) * f32u("rim_boost")
            for c in range(3):
                radiance[c][shade_lane] += (throughput[c] * base_color[c] * rim)[shade_lane]

        # Env NEE with MIS (:1334-1385).
        if env is not None:
            state, r1 = rand(state, mask=shade_lane)
            state, r2 = rand(state, mask=shade_lane)
            env_dir, env_spdf = sample_env_direction(env, r1, r2)
            ndl_e = _dot(shading, env_dir)
            candidate = shade_lane & (ndl_e > 0.0)
            occluded = trace_any(sc, shadow_o, env_dir, t_min, clip,
                                 np.zeros(n, np.float32), np.full(n, BIG),
                                 mask=candidate)
            open_sky = candidate & ~occluded
            h = _norm((v[0] + env_dir[0], v[1] + env_dir[1], v[2] + env_dir[2]))
            ndv = np.maximum(_dot(shading, v), F(0.001))
            ndh = np.maximum(_dot(shading, h), F(0.001))
            vdh = np.maximum(_dot(v, h), F(0.001))
            dd = distribution_ggx(ndh, rough)
            g = geometry_smith(ndv, np.maximum(ndl_e, F(0.0)), rough)
            fr = fresnel_schlick(vdh, f0)
            kspec = (dd * g) / np.maximum(F(4.0) * ndv * np.maximum(ndl_e, F(0.0)), F(0.001))
            spec = (fr[0] * kspec, fr[1] * kspec, fr[2] * kspec)
            diff = eval_diffuse_brdf(shading, v, env_dir, base_color, diff_rough, wrap)
            diff = tuple(c * (F(1.0) - metallic) for c in diff)
            brdf = tuple(spec[c] + diff[c] * (F(1.0) - fr[c]) for c in range(3))
            env_rad = sample_env_radiance(env, env_dir, f32u("env_intensity"),
                                          float(u.env_max_luminance))
            spec_w = np.maximum(f0[0], np.maximum(f0[1], f0[2]))
            diff_w = (F(1.0) - metallic) * np.maximum(
                base_color[0], np.maximum(base_color[1], base_color[2]))
            sumw = spec_w + diff_w
            spec_prob = np.where(sumw > 0.0, spec_w / np.maximum(sumw, F(1e-12)), F(0.5))
            pdf_b = brdf_pdf(shading, v, env_dir, rough, spec_prob)
            mis = power_heuristic(env_spdf, pdf_b)
            w = np.maximum(ndl_e, F(0.0)) * mis / np.maximum(env_spdf, F(1e-6))
            contrib = tuple(throughput[c] * brdf[c] * env_rad[c] * w for c in range(3))
            mx = np.maximum(contrib[0], np.maximum(contrib[1], contrib[2]))
            cscale = np.where(mx > F(20.0), F(20.0) / np.maximum(mx, F(1e-12)), F(1.0))
            for c in range(3):
                radiance[c][open_sky] += (contrib[c] * cscale)[open_sky]

        # BRDF sampling (:1387-1429).
        spec_w = np.maximum(f0[0], np.maximum(f0[1], f0[2]))
        diff_w = (F(1.0) - metallic) * np.maximum(
            base_color[0], np.maximum(base_color[1], base_color[2]))
        sumw = spec_w + diff_w
        spec_prob = np.clip(np.where(sumw > 0.0, spec_w / np.maximum(sumw, F(1e-12)),
                                     F(1.0)), 0.0, 1.0)
        state, r_lobe = rand(state, mask=shade_lane)
        state, s1 = rand(state, mask=shade_lane)
        state, s2 = rand(state, mask=shade_lane)
        choose_spec = shade_lane & (r_lobe < spec_prob)

        a_g = rough * rough
        a2_g = a_g * a_g
        phi = TWO_PI * s1
        cos_t = np.sqrt((F(1.0) - s2) / (F(1.0) + (a2_g - F(1.0)) * s2))
        sin_t = np.sqrt(np.maximum(F(0.0), F(1.0) - cos_t * cos_t))
        hvec = _to_world(shading, np.cos(phi).astype(np.float32) * sin_t,
                         np.sin(phi).astype(np.float32) * sin_t, cos_t)
        spec_dir = _norm((d[0] - 2 * _dot(d, hvec) * hvec[0],
                          d[1] - 2 * _dot(d, hvec) * hvec[1],
                          d[2] - 2 * _dot(d, hvec) * hvec[2]))
        ndl_s = np.maximum(_dot(shading, spec_dir), F(0.0))
        ndv = np.maximum(_dot(shading, v), F(0.001))
        ndh = np.maximum(_dot(shading, hvec), F(0.001))
        vdh = np.maximum(_dot(v, hvec), F(0.001))
        g = geometry_smith(ndv, ndl_s, rough)
        fr = fresnel_schlick(vdh, f0)
        kw = g * vdh / (ndv * ndh * np.maximum(spec_prob, F(0.01)))
        spec_weight = (fr[0] * kw, fr[1] * kw, fr[2] * kw)
        d_ggx = distribution_ggx(ndh, rough)
        spec_last_pdf = spec_prob * d_ggx * ndh / (F(4.0) * vdh)

        phi_d = TWO_PI * s1
        cos_td = np.sqrt(F(1.0) - s2)
        sin_td = np.sqrt(s2)
        diff_dir = _to_world(shading, np.cos(phi_d).astype(np.float32) * sin_td,
                             np.sin(phi_d).astype(np.float32) * sin_td, cos_td)
        ndl_d = np.maximum(_dot(shading, diff_dir), F(0.0))
        diff_brdf = eval_diffuse_brdf(shading, v, diff_dir, base_color, diff_rough, wrap)
        kd = (F(1.0) - metallic) * PI / np.maximum(F(1.0) - spec_prob, F(0.01))
        diff_weight = tuple(c * kd for c in diff_brdf)
        diff_last_pdf = (F(1.0) - spec_prob) * ndl_d / PI

        new_dir = _where(choose_spec, spec_dir, diff_dir)
        weight = _where(choose_spec, spec_weight, diff_weight)
        dead_spec = choose_spec & (ndl_s <= 0.0)

        throughput = tuple(np.where(shade_lane, throughput[c] * weight[c], throughput[c])
                           for c in range(3))
        mx = np.maximum(throughput[0], np.maximum(throughput[1], throughput[2]))
        tscale = np.where(shade_lane & (mx > F(10.0)), F(10.0) / np.maximum(mx, F(1e-12)),
                          F(1.0))
        throughput = tuple(c * tscale for c in throughput)

        o = _where(shade_lane,
                   (pos[0] + n_geom[0] * bias, pos[1] + n_geom[1] * bias,
                    pos[2] + n_geom[2] * bias), o)
        d = _where(shade_lane, new_dir, d)
        last_pdf = np.where(shade_lane,
                            np.where(choose_spec, spec_last_pdf, diff_last_pdf),
                            last_pdf)

        # Russian roulette from bounce 1 (:1434-1441). The reference draws
        # only for lanes that reached the end of the loop body (shade lanes
        # that did not break on a dead specular sample).
        survivor = shade_lane & ~dead_spec
        if bounce >= 1:
            state, rr = rand(state, mask=survivor)
            p = np.clip(mx * tscale, 0.05, 0.95)
            rr_kill = survivor & (rr > p)
            boost = np.where(survivor, F(1.0) / p, F(1.0))
            throughput = tuple(c * boost for c in throughput)
            survivor = survivor & ~rr_kill

        alive = transmit | survivor

    out = [np.minimum(radiance[c], F(100.0)) for c in range(3)]
    return out
