"""The port's elementwise maths (webgl_raytracer_tpu_torch.ops: vec3,
sampling, brdf, tonemap) against the JAX package's functions on the same
numpy inputs, within rtol = atol = 1e-6. The JAX side runs eagerly, op by
op, as calling its functions outside jit does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.ops import brdf as JB
from webgl_raytracer_tpu.ops import sampling as JS
from webgl_raytracer_tpu.ops import tonemap as JT
from webgl_raytracer_tpu.ops import vec3 as JV
from webgl_raytracer_tpu_torch.ops import brdf as PB
from webgl_raytracer_tpu_torch.ops import sampling as PS
from webgl_raytracer_tpu_torch.ops import tonemap as PT
from webgl_raytracer_tpu_torch.ops import vec3 as PV

N = 4096
_rng = np.random.default_rng(21)


def _unit():
    v = _rng.normal(size=(3, N)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    return tuple(v)


def _uniform(lo=0.0, hi=1.0):
    return (lo + (hi - lo) * _rng.random(N)).astype(np.float32)


def _scalar(x):
    return np.float32(x)


N1, N2, D = _unit(), _unit(), _unit()
# A half-space-consistent normal/view/light set for the BRDF terms.
V_ = tuple(np.where(np.sum(np.stack(D) * np.stack(N1), 0) < 0, -c, c) for c in D)
R1, R2 = _uniform(), _uniform()
COLOR = tuple(_uniform() for _ in range(3))
ROUGH = _uniform(0.01, 1.0)
HDR = np.abs(_rng.normal(size=(N, 3)).astype(np.float32)) * 2.0

# (case id, JAX function, port function, arguments). Arguments are numpy
# arrays, tuples of them (component triples) or np.float32 scalars.
CASES = [
    ("vec3.normalize", JV.normalize, PV.normalize, (tuple(2.0 * c for c in D),)),
    ("vec3.cross", JV.cross, PV.cross, (N1, N2)),
    ("vec3.dot", JV.dot, PV.dot, (N1, N2)),
    ("vec3.reflect", JV.reflect, PV.reflect, (D, N1)),
    ("vec3.blend", JV.blend, PV.blend, (N1, N2, R1)),
    ("vec3.max_component", JV.max_component, PV.max_component, (N1,)),
    ("vec3.min_with", JV.min_with, PV.min_with, (N1, _scalar(0.25))),
    ("sampling.disk_from_uv", JS.disk_from_uv,
     lambda a, b: torch.stack(PS.disk_from_uv(a, b), -1), (R1, R2)),
    ("sampling.power_heuristic", JS.power_heuristic, PS.power_heuristic, (R1, R2)),
    ("sampling.onb_v3", JS.onb_v3, PS.onb_v3, (N1,)),
    ("sampling.to_world_v3", JS.to_world_v3, PS.to_world_v3, (N1, R1, R2, _uniform())),
    ("sampling.cosine_hemisphere_from_uv_v3", JS.cosine_hemisphere_from_uv_v3,
     PS.cosine_hemisphere_from_uv_v3, (N1, R1, R2)),
    ("sampling.cone_from_uv_v3", JS.cone_from_uv_v3, PS.cone_from_uv_v3,
     (N1, _scalar(0.384), R1, R2)),
    ("sampling.ggx_half_vector_from_uv_v3", JS.ggx_half_vector_from_uv_v3,
     PS.ggx_half_vector_from_uv_v3, (N1, _scalar(0.4), R1, R2)),
    ("sampling.reflect_from_uv_v3", JS.reflect_from_uv_v3, PS.reflect_from_uv_v3,
     (D, N1, _scalar(0.22), R1, R2)),
    ("sampling.reflect_from_uv_v3 smooth", JS.reflect_from_uv_v3,
     PS.reflect_from_uv_v3, (D, N1, _scalar(0.01), R1, R2)),
    ("sampling.around_direction_from_uv_v3", JS.around_direction_from_uv_v3,
     PS.around_direction_from_uv_v3, (N2, _scalar(0.3), R1, R2)),
    ("brdf.fresnel_schlick", JB.fresnel_schlick, PB.fresnel_schlick,
     (R1, _scalar(0.02))),
    ("brdf.fresnel_schlick_v3", JB.fresnel_schlick_v3, PB.fresnel_schlick_v3,
     (R1, COLOR)),
    ("brdf.distribution_ggx", JB.distribution_ggx, PB.distribution_ggx, (R1, ROUGH)),
    ("brdf.geometry_smith", JB.geometry_smith, PB.geometry_smith, (R1, R2, ROUGH)),
    ("brdf.oren_nayar_diffuse_v3", JB.oren_nayar_diffuse_v3,
     PB.oren_nayar_diffuse_v3, (N1, V_, N2, COLOR, _scalar(0.5))),
    ("brdf.eval_diffuse_brdf_v3 lambert", JB.eval_diffuse_brdf_v3,
     PB.eval_diffuse_brdf_v3, (N1, V_, N2, COLOR, _scalar(0.0), _scalar(0.0))),
    ("brdf.eval_diffuse_brdf_v3 oren-nayar+wrap", JB.eval_diffuse_brdf_v3,
     PB.eval_diffuse_brdf_v3, (N1, V_, N2, COLOR, _scalar(0.5), _scalar(0.2))),
    ("brdf.refract_dir_v3", JB.refract_dir_v3, PB.refract_dir_v3,
     (D, N1, _uniform(0.6, 1.5))),
    ("brdf.brdf_pdf_v3", JB.brdf_pdf_v3, PB.brdf_pdf_v3, (N1, V_, N2, _scalar(0.4), R1)),
    ("brdf.spec_probability_v3", JB.spec_probability_v3, PB.spec_probability_v3,
     (COLOR, COLOR, _scalar(0.3))),
    ("tonemap.linear", lambda c: JT.apply_tonemap(c, "linear"),
     lambda c: PT.apply_tonemap(c, "linear"), (HDR,)),
    ("tonemap.aces", lambda c: JT.apply_tonemap(c, "aces"),
     lambda c: PT.apply_tonemap(c, "aces"), (HDR,)),
    ("tonemap.reinhard", lambda c: JT.apply_tonemap(c, 2),
     lambda c: PT.apply_tonemap(c, 2), (HDR,)),
]


def _to(lib, x):
    if isinstance(x, tuple):
        return tuple(_to(lib, c) for c in x)
    return jnp.asarray(x) if lib == "jax" else torch.as_tensor(np.asarray(x))


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, jax_fn, port_fn, args = case
    ref = _flat(jax_fn(*_to("jax", args)))
    got = _flat(port_fn(*_to("torch", args)))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape or r.size == g.size == 1
        np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                                   rtol=1e-6, atol=1e-6)


def test_sqrt_correctly_rounded_on_cpu():
    """vec3.sqrt on CPU f32 tensors is the correctly rounded square root,
    float32(sqrt(float64(x))), as numpy, JAX and the kernels' IEEE sqrtf
    give it; torch's own vectorised f32 sqrt is not on every CPU."""
    x = np.concatenate([_rng.random(N) * 4.0, _rng.random(N) * 1e-6,
                        _rng.random(N) * 1e6]).astype(np.float32)
    got = PV.sqrt(torch.as_tensor(x)).numpy()
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got, np.sqrt(x))


MATH = [("sqrt", PV.sqrt, 1), ("pow", PV.pow, 2), ("exp", PV.exp, 1),
        ("cos", PV.cos, 1), ("sin", PV.sin, 1), ("tan", PV.tan, 1),
        ("acos", PV.acos, 1), ("atan2", PV.atan2, 2)]


@pytest.mark.parametrize("name,fn,arity", MATH, ids=[m[0] for m in MATH])
def test_math_rounds_independently_of_lane_position(name, fn, arity):
    """The transports shade a lane at another position of the batch than
    the whole-batch frame does; each helper must round a value the same
    wherever it sits (torch's CPU f32 pow and atan2 do not), and round as
    float64 rounded once does."""
    args = [torch.as_tensor(_uniform(0.01, 0.99)) for _ in range(arity)]
    full = fn(*args)
    for shift in (1, 3, 5, 7, 17):
        assert torch.equal(fn(*(a[shift:] for a in args)), full[shift:]), shift
    want = getattr(torch, name)(*(a.double() for a in args)).float()
    assert torch.equal(full, want)
