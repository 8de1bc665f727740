"""The port's visualisation modes (render/integrator.render_visualization
and the Renderer's vis branch) against the JAX package's.

Modes 1 (normals) and 3 (depth) are held to JAX render_visualization on a
32x32 caffeine frame, with and without the clip plane, under the frame
tests' tolerances (tests/test_torch_render.py test_frame_matches_jax): at
least 99% of the pixels within 1e-4 and the image mean within 1e-3
relative over the rest. The JAX side runs eagerly (jax.disable_jit), as
there, since fused XLA code contracts FMAs the port never forms. Mode 2
draws a count, and the two packages count differently (ops/trace.py,
"Counts": the port per ray, the JAX CPU path per 256-ray tile), so its
ramp is held to JAX's on JAX's own count, within 1e-6, and the port's
image to the ramp of its own count. Under the stack tracer both packages
draw the walk's own count (node visits plus primitive tests), counted the
same way per ray: there mode 2 must equal JAX's image bit for bit. Under
use_bvh=False the count is K * C.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import random_sphere_geometry as bench_spheres
from webgl_raytracer_tpu.models import get_builtin_molecule, molecule_to_geometry
from webgl_raytracer_tpu.ops import wavefront as JW
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import integrator as JI
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu.scene import compile_scene as j_compile
from webgl_raytracer_tpu_torch.ops import trace as T
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


SIZE = 32
# Closer than the fitted camera, so that depth (1 - t / 10) is not 0.
DISTANCE = 7.0
_SCENES = {}


def _scenes(name="caffeine"):
    """(JAX scene, the port's) of caffeine, or of bench.py's 5000 random
    spheres: 63 clusters, more than the JAX CPU path's dense sweep takes
    (32), so its count varies by 256-ray tile."""
    if name not in _SCENES:
        geo = (molecule_to_geometry(get_builtin_molecule("caffeine")) if name == "caffeine"
               else bench_spheres(5000))
        js = j_compile(geo)
        _SCENES[name] = (js, scene_from_numpy(numpy_fields(js), device="cpu"))
    return _SCENES[name]


def _pair(mode, clip, name="caffeine", **settings):
    """The JAX and port renderers of the scene's frame in vis mode `mode`,
    and each one's frame inputs."""
    js, ps = _scenes(name)
    jr = JRenderer(js, width=SIZE, height=SIZE)
    pr = Renderer(ps, width=SIZE, height=SIZE, device="cpu")
    for r in (jr, pr):
        if name == "caffeine":
            r.camera.distance = DISTANCE
        for k, v in settings.items():
            setattr(r.settings, k, v)
        r.settings.vis_mode = mode
        r.settings.clip_enabled = clip
        r.settings.clip_distance = 6.5
    basis = jr.camera.basis()
    jf, ju = j_split(jr.settings, basis, j_lights(jr.settings.lights, basis),
                     has_env=False, has_volume=False, clip=jr.active_clip_plane(basis))
    jx, jy = jr._pixel_grids()
    return (jr, jf, ju, jx, jy), (pr, *pr.frame_inputs())


@pytest.mark.parametrize("clip", [False, True], ids=["no clip", "clip"])
@pytest.mark.parametrize("mode", [1, 3], ids=["normals", "depth"])
def test_vis_mode_matches_jax(mode, clip):
    (jr, jf, ju, jx, jy), (pr, pf, pu, px, py) = _pair(mode, clip)
    assert jf.vis_mode == pf.vis_mode == mode and pf.clip_enabled == clip
    with jax.disable_jit():
        jc = np.asarray(JI.render_visualization(jr.scene, None, None, jf, ju, jx, jy,
                                                jnp.uint32(0)))
    pc = PI.render_visualization(pr.scene, pf, pu, px, py).numpy()
    assert pc.shape == jc.shape == (SIZE * SIZE, 3) and np.isfinite(pc).all()
    hit = (pc > 0).any(axis=1)
    assert 0.05 * hit.size < hit.sum() < hit.size
    diff = np.abs(pc - jc).max(axis=1)
    assert (diff <= 1e-4).mean() >= 0.99, np.nonzero(diff > 1e-4)[0].tolist()
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * jc[keep].mean()


@pytest.mark.parametrize("clip", [False, True], ids=["no clip", "clip"])
def test_stack_tracer_vis_mode2_matches_jax(clip):
    """Under the stack tracer mode 2 is JAX's image bit for bit: the same
    walk, the same count per ray."""
    (jr, jf, ju, jx, jy), (pr, pf, pu, px, py) = _pair(2, clip, tracer="stack")
    assert jf.tracer == pf.tracer == "stack"
    with jax.disable_jit():
        jc = np.asarray(JI.render_visualization(jr.scene, None, None, jf, ju, jx, jy,
                                                jnp.uint32(0)))
    pc = PI.render_visualization(pr.scene, pf, pu, px, py).numpy()
    assert pc.shape == jc.shape == (SIZE * SIZE, 3)
    assert pc.tobytes() == jc.tobytes()
    assert len(np.unique(pc, axis=0)) > 10


def test_brute_vis_mode2_draws_k_times_c():
    """Under use_bvh=False every ray's count is K * C (the JAX package's
    _dense_trace cost), the ramp of which mode 2 draws on every pixel."""
    _, (pr, pf, pu, px, py) = _pair(2, False, use_bvh=False)
    img = PI.render_visualization(pr.scene, pf, pu, px, py)
    k_c = pr.scene.num_clusters * pr.scene.cluster_size
    want = PI.cost_heatmap(torch.full((px.shape[0],), k_c, dtype=torch.int32))
    assert torch.equal(img, want)


def test_cost_heatmap_matches_jax_on_its_count():
    """JAX's mode-2 image is the port's cost_heatmap of JAX's own CPU
    count (wf_trace_closest_v3's rec.cost) within 1e-6; the ramp's stops
    and ends are exact."""
    (jr, jf, ju, jx, jy), _ = _pair(2, False, "spheres5000")
    with jax.disable_jit():
        jc = np.asarray(JI.render_visualization(jr.scene, None, None, jf, ju, jx, jy,
                                                jnp.uint32(0)))
        fragx = jx.astype(jnp.float32) + 0.5
        fragy = jy.astype(jnp.float32) + 0.5
        uvx = (fragx + 0.5) / ju.resolution[0] * 2.0 - 1.0
        uvy = (fragy + 0.5) / ju.resolution[1] * 2.0 - 1.0
        d = [ju.cam_forward[i] + uvx * ju.cam_right[i] + uvy * ju.cam_up[i] for i in range(3)]
        norm = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        d3 = tuple(x / norm for x in d)
        o3 = tuple(jnp.broadcast_to(ju.cam_origin[i], jx.shape) for i in range(3))
        rec = JW.wf_trace_closest_v3(jr.scene, o3, d3, ju.t_min, None)
    cost = np.array(rec.cost)
    assert len(np.unique(cost)) > 1
    ramp = PI.cost_heatmap(torch.as_tensor(cost)).numpy()
    np.testing.assert_allclose(ramp, jc, rtol=0, atol=1e-6)
    ends = PI.cost_heatmap(torch.tensor([0, 50, 100, 150, 200, 400], dtype=torch.int32))
    # At 200 and above the ramp's last segment has frac 0: yellow, as in
    # the reference (its red stop is never reached).
    assert ends.tolist() == [list(c) for c in PI.COST_HEATMAP_STOPS[:4]] + [[1.0, 1.0, 0.0]] * 2


@pytest.mark.parametrize("clip", [False, True], ids=["no clip", "clip"])
def test_vis_mode2_is_the_ramp_of_the_plain_count(clip):
    """The port's mode-2 image is cost_heatmap of its own closest-hit count
    on the same pixel rays, bit for bit."""
    _, (pr, pf, pu, px, py) = _pair(2, clip, "spheres5000")
    img = PI.render_visualization(pr.scene, pf, pu, px, py)
    o3, d3 = PI.pixel_centre_rays(pu, px, py)
    _, row, cost = T.trace_closest(pr.scene, o3, d3, pu.t_min.expand(px.shape),
                                   clip=PI._clip_tuple(pf, pu), with_cost=True)
    assert torch.equal(img, PI.cost_heatmap(cost))
    assert bool((cost[row >= 0] >= 128).all()) and int(cost.max()) > 0


def test_renderer_vis_frames():
    """A vis frame replaces the accumulator (in place) and sets frame_index
    to 1; render_frames captures nothing in vis modes; image() is linear
    there whatever the tone map; back in mode 0 the path-traced frames
    are the ones a fresh renderer gives."""
    _, ps = _scenes()
    r = Renderer(ps, width=SIZE, height=SIZE, device="cpu")
    r.camera.distance = DISTANCE
    r.settings.tone_map = "aces"
    r.render_frames(2)
    accum = r._accum
    traced = r.image()
    r._captured = None              # a capture in a vis mode would fail here
    for mode in (1, 2, 3):
        r.settings.vis_mode = mode
        assert r.render_frames(3)
        assert r.frame_index == 1 and r._accum is accum
        flags, u, px, py = r.frame_inputs()
        want = PI.render_visualization(ps, flags, u, px, py)
        assert torch.equal(r._accum, want)
        img = r.image()
        assert np.array_equal(img, r.accumulated())
        assert not np.array_equal(img, traced)
    del r._captured
    r.settings.vis_mode = 0
    r.reset_accumulation()
    r.render_frames(2)
    fresh = Renderer(ps, width=SIZE, height=SIZE, device="cpu")
    fresh.camera.distance = DISTANCE
    fresh.settings.tone_map = "aces"
    fresh.render_frames(2)
    assert torch.equal(r._accum, fresh._accum) and r.frame_index == 2
    assert np.array_equal(r.image(), traced)
