"""The port's integrator and Renderer against the JAX package.

Whole frames: render_batch_stats of the port against the JAX package's on
the same scene, camera, settings and pixels. The JAX side runs eagerly
(jax.disable_jit): fused XLA code on the CPU contracts a*b+c into FMAs,
which the port's separate tensor ops (and its -fmad=false kernels) never
form, and on the benchmark's small distant spheres the hit quadratic is
ill-conditioned enough for that to move shading normals by up to 2e-2.
Eager JAX rounds op by op like the port. What remains are decision flips
(the port rounds trace t in scene-centred coordinates, the XLA path in
world coordinates): a path that flips may change every later bounce of its
pixel. So the frame test asks for >= 99% of pixels within 1e-4, the image
mean within 1e-3 relative over the other pixels, and ray-count differences
bounded by what the flipped pixels can account for (one path segment and
three shadow candidates per bounce each); flipped pixels are listed.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import random_sphere_geometry as bench_spheres
from webgl_raytracer_tpu.env import generate_analytic_sky, load_hdr, make_env_buffers
from webgl_raytracer_tpu.models import get_builtin_molecule, molecule_to_geometry
from webgl_raytracer_tpu.ops import traversal as JT
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import integrator as JI
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu_torch.env import env_from_numpy
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.scene.compile import numpy_fields, scene_from_numpy

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    threads would oversubscribe them, and the many small tensor ops here
    run fastest on one thread. The setting is process-wide, so the
    previous value comes back after this module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)


def _env(kind):
    """(JAX EnvBuffers, the port's copy with the same CDFs) or (None, None):
    kind "sky WxH" bakes the default analytic sky at that size, anything
    else names an HDR under assets/env/."""
    if kind is None:
        return None, None
    if kind.startswith("sky"):
        w, h = (int(x) for x in kind.split()[1].split("x"))
        img = generate_analytic_sky(width=w, height=h)["data"]
    else:
        img = load_hdr(os.path.join(REPO, "assets", "env", kind))["data"]
    je = make_env_buffers(img)
    fields = {f.name: np.asarray(getattr(je, f.name)) for f in dataclasses.fields(je)}
    return je, env_from_numpy(fields, device="cpu")


def _pair(geo, width, height, tri_verts=None, env=None, **settings):
    """(JAX renderer, flags, uniforms, px, py) and the port's renderer and
    frame inputs for the same scene, environment and settings."""
    js = j_compile(geo, tri_verts=tri_verts)
    je, pe = _env(env)
    jr = JRenderer(js, env=je, width=width, height=height)
    pr = Renderer(scene_from_numpy(numpy_fields(js), device="cpu"), env=pe,
                  width=width, height=height, device="cpu")
    for k, v in settings.items():
        setattr(jr.settings, k, v)
        setattr(pr.settings, k, v)
    basis = jr.camera.basis()
    jflags, ju = j_split(jr.settings, basis, j_lights(jr.settings.lights, basis),
                         has_env=je is not None, has_volume=False,
                         clip=jr.active_clip_plane(basis))
    jx, jy = jr._pixel_grids()
    return (jr, jflags, ju, jx, jy), (pr, *pr.frame_inputs())


@pytest.mark.parametrize("dof", [False, True], ids=["pinhole", "dof"])
def test_generate_camera_rays(dof):
    (jr, jf, ju, jx, jy), (pr, pf, pu, px, py) = _pair(
        bench_spheres(1000), 40, 24, dof_enabled=dof, dof_aperture=0.3)
    assert jf.dof_enabled == pf.dof_enabled == dof
    js, jo, jd = JI.generate_camera_rays(ju, jf, jx, jy, jnp.uint32(5), 1)
    ps, po, pd = PI.generate_camera_rays(pu, pf, px, py, 5, 1)
    assert np.array_equal(np.asarray(js).astype(np.int64), ps.numpy())
    for c in range(3):
        np.testing.assert_allclose(pd[c].numpy(), np.asarray(jd[c]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(po[c].numpy(), np.asarray(jo[c]), rtol=1e-6, atol=1e-6)


FRAMES = [
    ("spheres1000 64x48 metallic", lambda: bench_spheres(1000), 64, 48, {}),
    ("caffeine 48x32 matte",
     lambda: molecule_to_geometry(get_builtin_molecule("caffeine")), 48, 32,
     {"material_mode": "matte"}),
    ("caffeine 40x32 translucent-plastic",
     lambda: molecule_to_geometry(get_builtin_molecule("caffeine")), 40, 32,
     {"material_mode": "translucent-plastic", "roughness": 0.22,
      "surface_opacity": 0.15}),
    ("caffeine+tris 40x32 clip plane",
     lambda: molecule_to_geometry(get_builtin_molecule("caffeine")), 40, 32,
     {"tri_verts": TRIS, "clip_enabled": True, "clip_distance": 14.0}),
    ("spheres1000 64x48 sky 64x32", lambda: bench_spheres(1000), 64, 48,
     {"env": "sky 64x32", "env_intensity": 0.4}),
    ("caffeine 48x32 sunny_sky_256x128.hdr",
     lambda: molecule_to_geometry(get_builtin_molecule("caffeine")), 48, 32,
     {"env": "sunny_sky_256x128.hdr"}),
]


@pytest.mark.parametrize("case", FRAMES, ids=[c[0] for c in FRAMES])
def test_frame_matches_jax(case):
    _, geo, w, h, settings = case
    (jr, jf, ju, jx, jy), (pr, pf, pu, px, py) = _pair(geo(), w, h, **settings)
    assert pf.use_env == jf.use_env == (jr.env is not None)
    with jax.disable_jit():
        jc, (jn, jo) = JI.render_batch_stats(jr.scene, jr.env, None, jf, ju, jx, jy,
                                             jnp.uint32(0))
    pc, (pn, po) = PI.render_batch_stats(pr.scene, pf, pu, px, py, 0, env=pr.env)
    jc, pc = np.asarray(jc), pc.numpy()
    assert np.isfinite(pc).all() and pc.mean() > 0

    diff = np.abs(pc - jc).max(axis=1)
    flipped = np.nonzero(diff > 1e-4)[0]
    assert len(flipped) <= 0.01 * diff.size, f"flipped rays: {flipped.tolist()}"
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * jc[keep].mean()
    bounces = pf.max_bounces
    assert abs(int(pn) - int(jn)) <= bounces * len(flipped), \
        (int(pn), int(jn), flipped.tolist())
    # Shadow candidates per bounce: three cone lights, plus env NEE.
    per_bounce = 3 + int(pf.use_env)
    assert abs(int(po) - int(jo)) <= per_bounce * bounces * len(flipped), \
        (int(po), int(jo), flipped.tolist())


def test_renderer_accumulates_running_mean():
    r = Renderer(scene_from_numpy(numpy_fields(j_compile(bench_spheres(200))), device="cpu"),
                 width=32, height=16, device="cpu")
    flags, u, px, py = r.frame_inputs()
    frames = [PI.render_batch(r.scene, flags, u, px, py, f) for f in range(3)]
    r.render_frames(3)
    mean = (frames[0] * 1.0 + frames[1]) / 2.0
    mean = (mean * 2.0 + frames[2]) / 3.0
    assert torch.equal(r._accum, mean)
    img = r.image_u8()
    assert img.shape == (16, 32, 3) and img.dtype == np.uint8


@pytest.fixture
def jitted_jax_walk(monkeypatch):
    """The JAX integrator's stack walk (traversal._traverse) jitted inside
    the otherwise eager JAX frame: run op by op, the walk takes seconds a
    trace. Jitted XLA code contracts FMAs, so the JAX walk's t may differ
    from the port's by ulps, which the frame criterion's flipped-pixel
    allowance covers on the molecules' near, well-conditioned hits (on the
    1000 distant spheres it flips 2% of the pixels, which an eager JAX
    frame does not). The walk itself is compared bit for bit, eagerly, in
    tests/test_torch_traversal.py."""
    walk = jax.jit(JT._traverse, static_argnames=("any_hit", "max_steps", "max_leaf"))

    def jitted(scene, origin, direction, t_min, clip, **kw):
        with jax.disable_jit(False):
            return walk(scene, origin, direction, t_min, clip, **kw)

    monkeypatch.setattr(JI, "_traverse", jitted)


TRACER_FRAMES = [
    ("stack caffeine 24x16", "caffeine", 24, 16, {"tracer": "stack"}, None),
    ("brute caffeine 24x16", "caffeine", 24, 16, {"use_bvh": False}, None),
    ("stack caffeine+tris 24x16 clip plane", "caffeine", 24, 16,
     {"tracer": "stack", "tri_verts": TRIS, "clip_enabled": True, "clip_distance": 14.0},
     None),
    ("stack caffeine 32x16 permuted matte", "caffeine", 32, 16,
     {"tracer": "stack", "material_mode": "matte"}, "2"),
    ("brute caffeine+tris 32x16 permuted glass", "caffeine", 32, 16,
     {"use_bvh": False, "tri_verts": TRIS, "material_mode": "surface-glass"}, "2"),
]


@pytest.mark.parametrize("case", TRACER_FRAMES, ids=[c[0] for c in TRACER_FRAMES])
def test_tracer_frames_match_jax(case, jitted_jax_walk, monkeypatch):
    """Frames of the stack tracer and of the brute sweep (use_bvh=False)
    against the JAX package's, whole batch and, with WRT_CHUNKS, through
    the permuted transport (neither takes the binned one), under the frame
    criterion of test_frame_matches_jax."""
    _, geo, w, h, settings, chunks = case
    if chunks:
        monkeypatch.setenv("WRT_CHUNKS", chunks)
    geo = molecule_to_geometry(get_builtin_molecule(geo))
    (jr, jf, ju, jx, jy), (pr, pf, pu, px, py) = _pair(geo, w, h, **settings)
    assert (pf.tracer, pf.use_bvh) == (jf.tracer, jf.use_bvh)
    with jax.disable_jit():
        jc, (jn, jo) = JI.render_batch_stats(jr.scene, jr.env, None, jf, ju, jx, jy,
                                             jnp.uint32(0))
    with _transports() as taken:
        pc, (pn, po) = PI.render_batch_stats(pr.scene, pf, pu, px, py, 0, env=pr.env)
    assert taken == (["permuted"] if chunks else [])
    jc, pc = np.asarray(jc), pc.numpy()
    assert np.isfinite(pc).all() and pc.mean() > 0
    diff = np.abs(pc - jc).max(axis=1)
    flipped = np.nonzero(diff > 1e-4)[0]
    assert len(flipped) <= 0.01 * diff.size, f"flipped rays: {flipped.tolist()}"
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * jc[keep].mean()
    assert abs(int(pn) - int(jn)) <= pf.max_bounces * len(flipped)
    assert abs(int(po) - int(jo)) <= 3 * pf.max_bounces * len(flipped)
    assert int(po) > 0


class _transports:
    """The chunked transports a frame takes inside the block."""

    def __enter__(self):
        self.taken, self.real = [], (PI._run_permuted, PI._binned_transport)

        def spy(name, fn):
            return lambda *a, **k: self.taken.append(name) or fn(*a, **k)

        PI._run_permuted = spy("permuted", self.real[0])
        PI._binned_transport = spy("binned", self.real[1])
        return self.taken

    def __exit__(self, *exc):
        PI._run_permuted, PI._binned_transport = self.real


def test_port_imports_and_renders_without_jax():
    """With the JAX package blocked, the port builds the caffeine and
    random-sphere scenes and renders them (one under a sky) on the CPU,
    then a 64x64 frame in four chunks through the binned transport, imports
    the sweep probe, and loads no module of JAX or of the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['webgl_raytracer_tpu'] = None\n"
        "from webgl_raytracer_tpu_torch.env import EnvironmentController\n"
        "from webgl_raytracer_tpu_torch.scene import (compile_scene, molecule_geometry,\n"
        "                                             random_sphere_geometry)\n"
        "from webgl_raytracer_tpu_torch.render import Renderer\n"
        "sky = EnvironmentController(device='cpu').load_analytic_sky(width=32, height=16)\n"
        "for geo, env in ((random_sphere_geometry(300), sky), (molecule_geometry('caffeine'), None)):\n"
        "    r = Renderer(compile_scene(geo, device='cpu'), env=env, width=16, height=16,\n"
        "                 device='cpu')\n"
        "    img = r.render(1)\n"
        "    assert img.shape == (16, 16, 3) and img.mean() > 0\n"
        "import os\n"
        "import webgl_raytracer_tpu_torch.tools.sweep_sol\n"
        "from webgl_raytracer_tpu_torch.render import integrator\n"
        "os.environ['WRT_CHUNKS'] = '4'\n"
        "binned, real = [], integrator._binned_transport\n"
        "integrator._binned_transport = lambda *a, **k: binned.append(1) or real(*a, **k)\n"
        "r = Renderer(compile_scene(random_sphere_geometry(300), device='cpu'), width=64,\n"
        "             height=64, device='cpu')\n"
        "assert r.render(1).mean() > 0 and binned\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
        "             or (m.split('.')[0] == 'webgl_raytracer_tpu' and sys.modules[m] is not None))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
