"""The port's intersectors (ops/intersect.py) against the JAX package's.

The same rays and primitives, made with numpy from a seed, go through
webgl_raytracer_tpu/ops/intersect.py ([N, 3] arrays, run eagerly: jitted
XLA code on the CPU contracts a*b+c into FMAs, which the port never
forms) and the port's component-triple forms. Every output must be equal
bit for bit: both round each operation once, in the same order (the
port's dot sums the products left to right, as jnp.sum does over three
elements), and both take the correctly rounded f32 square root. The
cases: random rays and primitives; rays grazing spheres (discriminant
near 0); zero-height and near-zero-height cylinders; axis-parallel rays
(|d| < 1e-8 on an axis) against boxes around and beside their origin;
rays nearly in a triangle's plane (det around 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.ops import intersect as JX
from webgl_raytracer_tpu_torch.ops import intersect as PX

N = 4096


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rays(rng, n=N, spread=4.0):
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    return o, d


def _aimed(rng, o, targets, jitter):
    """Unit directions from o towards targets, jittered."""
    d = targets - o + rng.normal(size=o.shape) * jitter
    return _unit(d).astype(np.float32)


def _t3(a):
    """[N, 3] numpy -> component triple of CPU tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3))


def _equal_bits(got, want, name):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype == np.float32:
        bad = got.view(np.int32) != want.view(np.int32)
    else:
        bad = got != want
    assert not bad.any(), (name, int(bad.sum()), got[bad][:5], want[bad][:5])


def _sphere_case(kind, rng):
    o, d = _rays(rng)
    c = (rng.normal(size=(N, 3)) * 3).astype(np.float32)
    r = rng.uniform(0.2, 2.0, N).astype(np.float32)
    if kind == "grazing":
        # Aim at a point on the sphere's silhouette seen from o: the ray
        # is tangent up to rounding, the discriminant near 0.
        oc = c - o
        side = _unit(np.cross(oc, rng.normal(size=(N, 3))))
        dist = np.linalg.norm(oc, axis=1, keepdims=True)
        r = np.minimum(r, 0.9 * dist[:, 0]).astype(np.float32)
        tangent = np.sqrt(np.maximum(dist ** 2 - r[:, None] ** 2, 0.0))
        aim = o + _unit(oc) * (tangent ** 2 / dist) + side * (tangent * r[:, None] / dist)
        d = _aimed(rng, o, aim, 1e-7)
    elif kind == "aimed":
        d = _aimed(rng, o, c, 0.5)
    return o, d, c, r


@pytest.mark.parametrize("kind", ["random", "aimed", "grazing"])
def test_intersect_sphere(kind):
    o, d, c, r = _sphere_case(kind, np.random.default_rng(1))
    tmin = np.float32(1e-3)
    with jax.disable_jit():
        want = JX.intersect_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                                   jnp.asarray(r), tmin)
    got = PX.intersect_sphere(_t3(o), _t3(d), _t3(c), torch.from_numpy(r), float(tmin))
    _equal_bits(got.numpy(), want, "t")
    assert (np.asarray(want) > 0).sum() > (0 if kind == "random" else N // 20)


@pytest.mark.parametrize("kind", ["random", "aimed", "zero height", "short", "grazing cap"])
def test_intersect_cylinder(kind):
    rng = np.random.default_rng(2)
    o, d = _rays(rng, spread=5.0)
    p1 = (rng.normal(size=(N, 3)) * 2).astype(np.float32)
    axis = _unit(rng.normal(size=(N, 3)))
    length = rng.uniform(0.5, 3.0, (N, 1))
    if kind == "zero height":
        length = np.zeros((N, 1))
    elif kind == "short":
        length = rng.uniform(0.0, 2e-6, (N, 1))
    p2 = (p1 + axis * length).astype(np.float32)
    r = rng.uniform(0.1, 0.8, N).astype(np.float32)
    if kind != "random":
        mid = 0.5 * (p1 + p2)
        d = _aimed(rng, o, p2 if kind == "grazing cap" else mid, 0.3 if kind == "aimed" else 0.05)
    tmin = np.float32(1e-3)
    with jax.disable_jit():
        wt, wh = JX.intersect_cylinder(jnp.asarray(o), jnp.asarray(d), jnp.asarray(p1),
                                       jnp.asarray(p2), jnp.asarray(r), tmin)
    gt, gh = PX.intersect_cylinder(_t3(o), _t3(d), _t3(p1), _t3(p2), torch.from_numpy(r),
                                   float(tmin))
    _equal_bits(gt.numpy(), wt, "t")
    _equal_bits(gh.numpy(), wh, "hit_type")
    assert (np.asarray(wt) > 0).sum() > (0 if kind == "random" else N // 50)


@pytest.mark.parametrize("kind", ["random", "aimed", "near plane", "degenerate"])
def test_intersect_triangle(kind):
    rng = np.random.default_rng(3)
    o, d = _rays(rng, spread=4.0)
    v0 = (rng.normal(size=(N, 3)) * 2).astype(np.float32)
    v1 = (v0 + rng.normal(size=(N, 3))).astype(np.float32)
    v2 = (v0 + rng.normal(size=(N, 3))).astype(np.float32)
    if kind == "degenerate":
        v2 = (v0 + (v1 - v0) * rng.uniform(0, 1, (N, 1))).astype(np.float32)
    centre = (v0 + v1 + v2) / 3.0
    if kind == "aimed":
        d = _aimed(rng, o, centre, 0.3)
    elif kind == "near plane":
        # Directions inside the triangle's plane, tilted out of it by about
        # 1e-6: det = e1 . (d x e2) near the 1e-6 threshold.
        n = _unit(np.cross(v1 - v0, v2 - v0))
        inplane = _unit(np.cross(n, rng.normal(size=(N, 3))))
        d = _unit(inplane + n * rng.uniform(-3e-6, 3e-6, (N, 1))).astype(np.float32)
        o = (centre - inplane * rng.uniform(1, 3, (N, 1))).astype(np.float32)
    tmin = np.float32(1e-3)
    with jax.disable_jit():
        wt, wu, wv = JX.intersect_triangle(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0),
                                           jnp.asarray(v1), jnp.asarray(v2), tmin)
    gt, gu, gv = PX.intersect_triangle(_t3(o), _t3(d), _t3(v0), _t3(v1), _t3(v2),
                                       float(tmin))
    for name, g, w in (("t", gt, wt), ("u", gu, wu), ("v", gv, wv)):
        _equal_bits(g.numpy(), w, name)
    if kind == "aimed":
        assert (np.asarray(wt) > 0).sum() > N // 10


@pytest.mark.parametrize("kind", ["random", "parallel axes", "flat boxes"])
def test_intersect_aabb_and_range(kind):
    rng = np.random.default_rng(4)
    o, d = _rays(rng, spread=3.0)
    lo = (rng.normal(size=(N, 3)) * 2).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 3.0, (N, 3))).astype(np.float32)
    if kind == "parallel axes":
        # One or two axes of d below 1e-8 (zero or tiny), origins inside
        # and outside the box's slab on those axes.
        small = rng.random((N, 3)) < 0.4
        d = np.where(small, rng.choice([0.0, 5e-9, -5e-9], (N, 3)), d).astype(np.float32)
        inside = rng.random((N, 3)) < 0.5
        o = np.where(small & inside, 0.5 * (lo + hi), o).astype(np.float32)
    elif kind == "flat boxes":
        hi = np.where(rng.random((N, 3)) < 0.3, lo, hi).astype(np.float32)
        d = _aimed(rng, o, 0.5 * (lo + hi), 0.2)
    t_max = rng.uniform(0.5, 20.0, N).astype(np.float32)
    with jax.disable_jit():
        want = JX.intersect_aabb(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(t_max))
        wr = [JX.intersect_aabb_range(jnp.asarray(lo[i]), jnp.asarray(hi[i]),
                                      jnp.asarray(o[i:i + 64]), jnp.asarray(d[i:i + 64]))
              for i in (0, 7)]
    got = PX.intersect_aabb(_t3(lo), _t3(hi), _t3(o), _t3(d), torch.from_numpy(t_max))
    _equal_bits(got.numpy(), want, "hit")
    assert 0 < np.asarray(want).sum() < N
    for i, w in zip((0, 7), wr):
        g = PX.intersect_aabb_range(torch.from_numpy(lo[i]), torch.from_numpy(hi[i]),
                                    _t3(o[i:i + 64]), _t3(d[i:i + 64]))
        for name, gg, ww in zip(("hit", "t_near", "t_far"), g, w):
            _equal_bits(gg.numpy(), ww, name)


@pytest.mark.parametrize("hit_type", [0.0, 1.0, 2.0])
def test_cylinder_normal(hit_type):
    rng = np.random.default_rng(5)
    pos = (rng.normal(size=(N, 3)) * 2).astype(np.float32)
    p1 = rng.normal(size=(N, 3)).astype(np.float32)
    p2 = (p1 + rng.normal(size=(N, 3))).astype(np.float32)
    p2[:16] = p1[:16]                                  # zero-length axes
    ht = np.full(N, hit_type, np.float32)
    with jax.disable_jit():
        want = JX.cylinder_normal(jnp.asarray(pos), jnp.asarray(p1), jnp.asarray(p2),
                                  jnp.asarray(ht))
    got = PX.cylinder_normal(_t3(pos), _t3(p1), _t3(p2), torch.from_numpy(ht))
    _equal_bits(torch.stack(got, dim=1).numpy(), want, "normal")


def test_clip_reject():
    rng = np.random.default_rng(6)
    o, d = _rays(rng)
    t = rng.choice([-1.0, 0.0, 1.0], N).astype(np.float32) * rng.uniform(0, 9, N).astype(
        np.float32)
    normal = _unit(rng.normal(size=3)).astype(np.float32)
    for offset, side in ((0.5, 1.0), (-2.0, -1.0)):
        with jax.disable_jit():
            want = JX.clip_reject(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                                  jnp.asarray(normal), np.float32(offset), np.float32(side))
        got = PX.clip_reject(_t3(o), _t3(d), torch.from_numpy(t),
                             tuple(torch.tensor(x) for x in normal),
                             torch.tensor(offset, dtype=torch.float32),
                             torch.tensor(side, dtype=torch.float32))
        _equal_bits(got.numpy(), want, "rejected")
        assert 0 < np.asarray(want).sum() < N
