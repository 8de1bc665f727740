"""BRDF terms in component form: GGX specular with Schlick Fresnel and
Smith geometry, Lambert or Oren-Nayar diffuse with optional wrap
lighting, refraction, and the combined spec/diffuse sampling pdf.

Counterpart of the functions of webgl_raytracer_tpu/ops/brdf.py that the
bounce step calls.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vec3 as V

PI = float(np.float32(np.pi))


def wrap_ndotl(ndotl, wrap):
    return torch.clamp((ndotl + wrap) / (1.0 + wrap), 0.0, 1.0)


def fresnel_schlick(cos_theta, f0):
    """Schlick Fresnel with a scalar (or per-lane) f0."""
    w = V.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)
    return f0 + (1.0 - f0) * w


def distribution_ggx(ndoth, roughness):
    a = roughness * roughness
    a2 = a * a
    denom = (ndoth * ndoth) * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom + 1e-6)


def geometry_schlick_ggx(ndotv, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotv / (ndotv * (1.0 - k) + k + 0.0001)


def geometry_smith(ndotv, ndotl, roughness):
    return geometry_schlick_ggx(ndotv, roughness) * geometry_schlick_ggx(ndotl, roughness)


def oren_nayar_diffuse_v3(n, v, l, base_color, sigma):
    ndl = torch.clamp_min(V.dot(n, l), 0.0)
    ndv = torch.clamp_min(V.dot(n, v), 0.0)
    sigma2 = sigma * sigma
    a = 1.0 - 0.5 * (sigma2 / (sigma2 + 0.33))
    b = 0.45 * (sigma2 / (sigma2 + 0.09))
    sin_l = V.sqrt(torch.clamp_min(1.0 - ndl * ndl, 0.0))
    sin_v = V.sqrt(torch.clamp_min(1.0 - ndv * ndv, 0.0))
    tan_l = sin_l / torch.clamp_min(ndl, 1e-4)
    tan_v = sin_v / torch.clamp_min(ndv, 1e-4)
    sin_alpha = torch.maximum(sin_l, sin_v)
    tan_beta = torch.minimum(tan_l, tan_v)
    lp = V.normalize(V.sub(l, V.scale(n, ndl)))
    vp = V.normalize(V.sub(v, V.scale(n, ndv)))
    cos_phi = torch.clamp_min(V.dot(lp, vp), 0.0)
    oren = (a + b * cos_phi * sin_alpha * tan_beta) / PI
    lit = (ndl > 0.0) & (ndv > 0.0)
    w = torch.where(lit, oren, 0.0)
    return V.scale(base_color, w)


def eval_diffuse_brdf_v3(n, v, l, base_color, diff_rough, wrap):
    """Lambert or Oren-Nayar, times the wrap-lighting scale."""
    lam = V.scale(base_color, 1.0 / PI)
    on = oren_nayar_diffuse_v3(n, v, l, base_color, diff_rough)
    brdf = V.where(torch.as_tensor(diff_rough > 1e-4), on, lam)
    ndl = torch.clamp_min(V.dot(n, l), 0.0)
    scale = torch.where(ndl > 1e-4,
                        wrap_ndotl(ndl, wrap) / torch.clamp_min(ndl, 1e-4), 0.0)
    scale = torch.where(torch.as_tensor(wrap > 0.0), scale, 1.0)
    return V.scale(brdf, scale)


def fresnel_schlick_v3(cos_theta, f0):
    """f0 is a component triple; returns a triple."""
    w = V.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)
    return (f0[0] + (1.0 - f0[0]) * w,
            f0[1] + (1.0 - f0[1]) * w,
            f0[2] + (1.0 - f0[2]) * w)


def refract_dir_v3(incident, normal, eta):
    """(can_refract, refracted triple)."""
    cosi = torch.clamp(-V.dot(incident, normal), 0.0, 1.0)
    sin2 = eta * eta * (1.0 - cosi * cosi)
    can = sin2 <= 1.0
    cost = V.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
    k = eta * cosi - cost
    return can, (eta * incident[0] + k * normal[0],
                 eta * incident[1] + k * normal[1],
                 eta * incident[2] + k * normal[2])


def brdf_pdf_v3(n, v, l, roughness, spec_prob):
    """Combined GGX + cosine pdf of sampling l."""
    ndl = torch.clamp_min(V.dot(n, l), 0.0)
    diff_pdf = ndl / PI
    h = V.normalize(V.add(v, l))
    ndoth = torch.clamp_min(V.dot(n, h), 0.001)
    vdoth = torch.clamp_min(V.dot(v, h), 0.001)
    d = distribution_ggx(ndoth, roughness)
    spec_pdf = d * ndoth / (4.0 * vdoth)
    pdf = spec_prob * spec_pdf + (1.0 - spec_prob) * diff_pdf
    return torch.where(ndl > 0.0, pdf, 0.0)


def spec_probability_v3(f0, base_color, metallic):
    """Spec-vs-diffuse lobe selection probability."""
    spec_w = V.max_component(f0)
    diff_w = (1.0 - metallic) * V.max_component(base_color)
    s = spec_w + diff_w
    return torch.where(s > 0.0, spec_w / torch.clamp_min(s, 1e-12), 0.5)
