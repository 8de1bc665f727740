"""The port's environment lighting (webgl_raytracer_tpu_torch.env and
ops/envmap.py) against the JAX package, on the CPU.

The JAX side runs eagerly (jax.disable_jit). Tolerances: the HDR decode is
exact; the sky image is held to rtol 1e-5 (torch's and XLA's sin, cos,
exp, tan and acos may differ by an ulp, and the Perez terms amplify it a
little); the CDFs to rtol 1e-6, atol 1e-7 (two prefix sums whose
summation order differs between the two libraries). The samplers run on
CDFs carried across with env_from_numpy, so their integer bins and the
PCG states are exact and only the transcendental rounding remains
(rtol 1e-5 on directions, pdfs and radiance).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.env import cdf as JC
from webgl_raytracer_tpu.env import hdr as JH
from webgl_raytracer_tpu.env import sky as JS
from webgl_raytracer_tpu.ops import envmap as JE
from webgl_raytracer_tpu_torch.env import (EnvironmentController, constant_env,
                                           env_from_numpy, make_env_buffers)
from webgl_raytracer_tpu_torch.env import cdf as PC
from webgl_raytracer_tpu_torch.env import hdr as PH
from webgl_raytracer_tpu_torch.env import sky as PSKY
from webgl_raytracer_tpu_torch.ops import envmap as PE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_DIR = os.path.join(REPO, "assets", "env")
HDRS = sorted(f for f in os.listdir(ENV_DIR) if f.endswith(".hdr"))
SKIES = [{"width": 64, "height": 32},
         {"width": 96, "height": 48, "turbidity": 6.0, "sun_elevation_deg": 8.0}]


def _jax_sky(kw):
    with jax.disable_jit():
        return np.asarray(JS.generate_analytic_sky(**kw)["data"])


@pytest.mark.parametrize("kw", SKIES, ids=["default 64x32", "turbid low sun 96x48"])
def test_sky_image_matches_jax(kw):
    port = PSKY.generate_analytic_sky(device="cpu", **kw)
    assert port["version"] == JS.generate_analytic_sky(**kw)["version"]
    np.testing.assert_allclose(port["data"].numpy(), _jax_sky(kw), rtol=1e-5)


@pytest.mark.parametrize("name", HDRS)
def test_hdr_decode_exact(name):
    data = open(os.path.join(ENV_DIR, name), "rb").read()
    jw, jh, jimg = JH.decode_hdr(data)
    pw, ph, pimg = PH.decode_hdr(data)
    assert (jw, jh) == (pw, ph)
    assert np.array_equal(jimg, pimg)
    assert PH.encode_hdr(pimg[..., :3]) == JH.encode_hdr(jimg[..., :3])


@pytest.mark.parametrize("source", ["sky 64x32", "sunny_sky_256x128.hdr"])
def test_cdfs_match_jax(source):
    if source.startswith("sky"):
        img = _jax_sky(SKIES[0])
    else:
        img = JH.load_hdr(os.path.join(ENV_DIR, source))["data"]
    with jax.disable_jit():
        jm, jc, jt = JC.build_env_sampling(img)
    pm, pc, pt = PC.build_env_sampling(img, device="cpu")
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt, jt, rtol=1e-6)
    assert pm[-1] == 1.0 and bool((pc[:, -1] == 1.0).all())


@pytest.fixture(scope="module")
def envs():
    """(JAX EnvBuffers, the port's copy) of the sunny HDR."""
    img = JH.load_hdr(os.path.join(ENV_DIR, "sunny_sky_256x128.hdr"))["data"]
    je = JC.make_env_buffers(img)
    fields = {f.name: np.asarray(getattr(je, f.name)) for f in dataclasses.fields(je)}
    return je, env_from_numpy(fields, device="cpu")


def _directions(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


def test_bisect_bins_exact(envs):
    je, pe = envs
    xi = np.random.default_rng(3).random(4096).astype(np.float32)
    jm = je.marginal_cdf
    ji, jf = JE._bisect_cdf(lambda i: jm[i], je.height + 1, jnp.asarray(xi))
    pi, pf = PE._bisect_cdf(lambda i: pe.marginal_cdf[i], pe.height + 1,
                            torch.as_tensor(xi))
    assert np.array_equal(np.asarray(ji), pi.numpy())
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=1e-6)


def test_sample_env_direction_matches_jax(envs):
    je, pe = envs
    state = np.random.default_rng(5).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    with jax.disable_jit():
        js, jd, jp = JE.sample_env_direction_v3(je, jnp.asarray(state.astype(np.uint32)))
    ps, pd, pp = PE.sample_env_direction_v3(pe, torch.as_tensor(state.astype(np.int64)))
    assert np.array_equal(np.asarray(js).astype(np.int64), ps.numpy())
    for c in range(3):
        np.testing.assert_allclose(pd[c].numpy(), np.asarray(jd[c]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-5)


def test_conditional_pdf_clamps_like_jax(envs):
    """A column fraction that rounds up to W reads the clamped last column
    (pdf 0), as JAX's out-of-range gather does, instead of faulting."""
    je, pe = envs
    w = pe.width
    v = np.array([0, 5, pe.height - 1], np.int64)
    u = np.array([w, w - 1, 0.5], np.float32)
    jc = je.conditional_cdf
    ju = u.astype(np.int32)
    want = np.asarray(jc[v, ju + 1] - jc[v, ju])
    got = PE.conditional_pdf(pe.conditional_cdf, torch.as_tensor(v), torch.as_tensor(u))
    assert np.array_equal(got.numpy(), want) and got[0] == 0.0


def test_env_pdf_and_radiance_match_jax(envs):
    je, pe = envs
    d = _directions(4096, 9)
    jd = tuple(jnp.asarray(d[i]) for i in range(3))
    pd = tuple(torch.as_tensor(d[i]) for i in range(3))
    with jax.disable_jit():
        jpdf = JE.env_pdf_v3(je, jd)
        jrad = JE.sample_env_radiance_v3(je, jd, jnp.float32(0.7), jnp.float32(2.0))
    ppdf = PE.env_pdf_v3(pe, pd)
    prad = PE.sample_env_radiance_v3(pe, pd, torch.tensor(0.7), torch.tensor(2.0))
    np.testing.assert_allclose(ppdf.numpy(), np.asarray(jpdf), rtol=1e-5)
    for c in range(3):
        np.testing.assert_allclose(prad[c].numpy(), np.asarray(jrad[c]), rtol=1e-5,
                                   atol=1e-7)


def test_controller_caches_and_clears():
    ec = EnvironmentController(device="cpu")
    a = ec.load_analytic_sky(width=32, height=16)
    assert ec.load_analytic_sky(width=32, height=16) is a
    assert a.radiance.shape == (16, 32, 3) and a.device.type == "cpu"
    h = ec.load_hdr_file(os.path.join(ENV_DIR, "white_1x1.hdr"))
    assert ec.current is h and (h.width, h.height) == (1, 1)
    ec.clear()
    assert ec.current is None and ec.current_key is None
    white = constant_env(2.0, 8, 4, device="cpu")
    assert torch.equal(white.marginal_cdf, make_env_buffers(
        np.full((4, 8, 3), 2.0, np.float32), device="cpu").marginal_cdf)


def test_env_builders_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnvironmentController()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        constant_env()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PSKY.generate_analytic_sky(width=8, height=4)
