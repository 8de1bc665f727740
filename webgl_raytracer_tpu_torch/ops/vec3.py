"""Vectors as component triples of [B] tensors, and the port's f32 maths.

Counterpart of webgl_raytracer_tpu/ops/vec3.py, kept so the integrator's
arithmetic reads (and rounds) the same as the reference's. A V3 is a tuple
(x, y, z) of equal-shape tensors, or 0-d tensors / floats that broadcast.

sqrt, pow, exp, cos, sin, tan, acos and atan2 are the port's only way to
those functions. On CUDA tensors they are torch's, which round as the
kernels' IEEE sqrtf does. On the CPU, torch's vectorised f32 versions are
not correctly rounded on some machines (sqrt differs from
float32(sqrt(float64(x))) on many inputs), and pow and atan2 there even
round a lane by its position in the vector, so a permuted batch would
shade differently. On CPU tensors these helpers compute in float64 and
round once: exactly the correctly rounded f32 for sqrt, and for the
others except where the float64 result lies within its own rounding
error of an f32 tie.
"""

from __future__ import annotations

import torch


def _f32_math(fn):
    def f(x, *rest):
        if x.device.type != "cpu":
            return fn(x, *rest)
        rest = tuple(r.double() if isinstance(r, torch.Tensor) else r for r in rest)
        return fn(x.double(), *rest).to(x.dtype)
    f.__name__ = fn.__name__
    f.__doc__ = f"torch.{fn.__name__}, correctly rounded on CPU tensors."
    return f


sqrt = _f32_math(torch.sqrt)
pow = _f32_math(torch.pow)  # noqa: A001 - the torch name, as V.pow
exp = _f32_math(torch.exp)
cos = _f32_math(torch.cos)
sin = _f32_math(torch.sin)
tan = _f32_math(torch.tan)
acos = _f32_math(torch.acos)
atan2 = _f32_math(torch.atan2)


def from_array(a):
    """[..., 3] -> components."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_array(v):
    return torch.stack(torch.broadcast_tensors(*v), dim=-1)


def splat(const, like=None):
    """3-vector tensor -> component triple (optionally expanded to `like`'s
    shape)."""
    x, y, z = const[..., 0], const[..., 1], const[..., 2]
    if like is not None:
        shape = like.shape
        x, y, z = x.expand(shape), y.expand(shape), z.expand(shape)
    return (x, y, z)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    """Componentwise product."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def neg(a):
    return (-a[0], -a[1], -a[2])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length(a):
    return sqrt(dot(a, a))


def normalize(a, eps=1e-12):
    inv = 1.0 / torch.clamp_min(length(a), eps)
    return scale(a, inv)


def where(mask, a, b):
    """Select per lane; mask is [B]."""
    return (
        torch.where(mask, a[0], b[0]),
        torch.where(mask, a[1], b[1]),
        torch.where(mask, a[2], b[2]),
    )


def blend(a, b, t):
    s = 1.0 - t
    return (a[0] * s + b[0] * t, a[1] * s + b[1] * t, a[2] * s + b[2] * t)


def max_component(a):
    return torch.maximum(a[0], torch.maximum(a[1], a[2]))


def min_with(a, s):
    return (torch.clamp_max(a[0], s), torch.clamp_max(a[1], s),
            torch.clamp_max(a[2], s))


def reflect(d, n):
    k = 2.0 * dot(d, n)
    return (d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2])


def zeros_like(ref):
    z = torch.zeros_like(ref)
    return (z, z.clone(), z.clone())


def full(shape, value, device=None):
    a = torch.full(shape, value, dtype=torch.float32, device=device)
    return (a, a, a)
