"""Float helpers of the reference: component-triple vectors and the
transcendental functions.

On the card sqrt, pow, exp and the trigonometric functions are torch's. On
CPU tensors torch's float32 versions are not correctly rounded on every
machine, so there they are computed in float64 and rounded once. In a
lower precision (the control) they compute in that dtype as torch does.
"""

from __future__ import annotations

import torch


def _rounded(fn):
    def f(x, *rest):
        if x.device.type != "cpu" or x.dtype != torch.float32:
            return fn(x, *rest)
        rest = tuple(r.double() if isinstance(r, torch.Tensor) else r for r in rest)
        return fn(x.double(), *rest).to(x.dtype)
    f.__name__ = fn.__name__
    return f


sqrt = _rounded(torch.sqrt)
pow = _rounded(torch.pow)  # noqa: A001 - torch's name
exp = _rounded(torch.exp)
cos = _rounded(torch.cos)
sin = _rounded(torch.sin)
tan = _rounded(torch.tan)
acos = _rounded(torch.acos)
atan2 = _rounded(torch.atan2)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def norm(v, eps=1e-12):
    inv = 1.0 / torch.clamp_min(sqrt(dot(v, v)), eps)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def scale(v, s):
    return (v[0] * s, v[1] * s, v[2] * s)


def max3(v):
    return torch.maximum(v[0], torch.maximum(v[1], v[2]))


def to_world(axis, lx, ly, lz):
    """Local to world about `axis`, with the shader's choice of up."""
    use_z = torch.abs(axis[2]) < 0.999
    zero = torch.zeros_like(axis[0])
    one = torch.ones_like(axis[0])
    up = (torch.where(use_z, zero, one), zero, torch.where(use_z, one, zero))
    t = norm(cross(up, axis))
    b = cross(axis, t)
    return norm((t[0] * lx + b[0] * ly + axis[0] * lz,
                 t[1] * lx + b[1] * ly + axis[1] * lz,
                 t[2] * lx + b[2] * ly + axis[2] * lz))
