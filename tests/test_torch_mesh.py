"""The port's tile mesh (parallel/mesh.py) and the Renderer's mesh path,
on the CPU.

A mesh of n CPU shards (make_mesh(["cpu"] * n)) stands in for n cards, as
the JAX package's tests use conftest's 8 virtual CPU devices. Every shard
runs the single-device frame on its own contiguous part of the rays, and
no op mixes rays, so a mesh frame must equal the single-device frame bit
for bit, ray counts included, whatever the shard sizes.

(a) Mesh frames against the single-device Renderer for 2, 3 (uneven) and
    8 shards; a frame where one shard's binned buffer overflows and is
    redone alone; and the JAX package's mesh Renderer, under
    tests/test_torch_render.py's frame tolerance.
(b) render_spp_sharded within 2e-5 of the single-device render_batch (the
    JAX package's bound), and against the JAX package's render_spp_sharded.
(c) render_tiles_sharded equals the unsharded render_batch.
(d) The Renderer's surface with a mesh: set_env, set_scene, set_scale, a
    vis mode, checkpoints saved on a mesh and loaded on one device and the
    reverse, all equal to the single-device Renderer.
(e) The CLI's --devices N: render, bench, pick and serve.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.app.pipeline import load_test_primitives as j_primitives
from webgl_raytracer_tpu.env import constant_env as j_constant_env
from webgl_raytracer_tpu.parallel import make_mesh as j_make_mesh
from webgl_raytracer_tpu.parallel.mesh import render_spp_sharded as j_spp_sharded
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render.config import split_settings as j_split
from webgl_raytracer_tpu.render.lights import light_dirs_for_camera as j_lights
from webgl_raytracer_tpu_torch.app import cli as PCLI
from webgl_raytracer_tpu_torch.app import server as PSV
from webgl_raytracer_tpu_torch.app.pipeline import load_test_primitives
from webgl_raytracer_tpu_torch.env.cdf import constant_env
from webgl_raytracer_tpu_torch.models import Geometry
from webgl_raytracer_tpu_torch.parallel import (make_mesh, render_tiles_sharded,
                                                replicate_scene, shard_rays)
from webgl_raytracer_tpu_torch.parallel.mesh import render_spp_sharded, shard_sizes, spp_split
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.scene import compile_scene, random_sphere_geometry
from webgl_raytracer_tpu_torch.utils import decode_png


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per test worker, as in tests/test_torch_render.py;
    the previous value comes back after this module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def _primitives_pair(n, width=32, height=32):
    """(mesh Renderer over n CPU shards, single-device Renderer) of the
    primitives scene under constant_env(0.5), linear tone map: the JAX
    package's mesh test case."""
    scene = load_test_primitives(device="cpu").scene
    env = constant_env(0.5, device="cpu")
    rm = Renderer(scene, env=env, width=width, height=height, mesh=cpu_mesh(n))
    r1 = Renderer(scene, env=env, width=width, height=height, device="cpu")
    for r in (rm, r1):
        r.settings.tone_map = "linear"
    return rm, r1


def _same_frames(rm, r1):
    assert rm.frame_index == r1.frame_index
    assert rm.ray_counts == r1.ray_counts
    a, b = rm.accumulated(), r1.accumulated()
    assert a.tobytes() == b.tobytes(), float(np.abs(a - b).max())
    assert a.mean() > 0


# (a) Frames.

def test_mesh_shapes():
    """make_mesh normalises its devices; replicate_scene shares one copy a
    device; shard_rays splits in ray order, the first n % size shards one
    ray longer, and in whole binned blocks (1024 rays) where there is one
    a shard, the last shard taking what is left."""
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis_name == "tiles"
    assert make_mesh(["cuda"]).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError):
        make_mesh([])
    scene = load_test_primitives(device="cpu").scene
    assert all(copy is scene for copy in replicate_scene(scene, mesh))
    assert replicate_scene(None, mesh) == [None] * 3
    parts = shard_rays(torch.arange(10), mesh)
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9]]
    assert shard_sizes(1920 * 1080, 2) == [1013 * 1024, 1012 * 1024]
    assert shard_sizes(2500, 2) == [1024, 1476]
    assert shard_sizes(2047, 2) == [1024, 1023]
    assert spp_split(5, 3) == [(0, 2), (2, 2), (4, 1)]
    assert spp_split(3, 2) == [(0, 2), (2, 1)]


@pytest.mark.parametrize("n", [2, 3, 8])
def test_mesh_frames_equal_single_device(n):
    """4 progressive frames of the 32x32 primitives scene: 1024 rays, so 3
    shards are uneven (342, 341, 341)."""
    rm, r1 = _primitives_pair(n)
    rm.render_frames(4)
    r1.render_frames(4)
    _same_frames(rm, r1)
    assert [len(s._px) for s in rm._shards] == [len(p) for p in
                                                torch.tensor_split(torch.arange(1024), n)]
    assert rm.stats == r1.stats


def test_block_aligned_shards_take_the_binned_transport(monkeypatch):
    """A frame with a binned block a shard splits into whole blocks: at
    64x48 in 4 chunks (WRT_CHUNKS), two shards of 2048 and 1024 rays, each
    on the binned transport as the single-device frame is, and the frames
    equal bit for bit."""
    monkeypatch.setenv("WRT_CHUNKS", "4")
    binned = []
    real = PI._binned_transport
    monkeypatch.setattr(PI, "_binned_transport",
                        lambda *a, **kw: binned.append(a[4].shape[0]) or real(*a, **kw))
    rm, r1 = _primitives_pair(2, 64, 48)
    r1.render_frames(2)
    assert binned == [3072, 3072]
    binned.clear()
    rm.render_frames(2)
    assert [len(s._px) for s in rm._shards] == [2048, 1024]
    assert sorted(binned) == [1024, 1024, 2048, 2048]
    _same_frames(rm, r1)


def test_mesh_frames_match_jax_mesh():
    """The port's 8-shard frames against the JAX Renderer on conftest's 8
    virtual devices (its shard_map tile path), under the frame tolerance
    of tests/test_torch_render.py: at most 1% of pixels off by more than
    1e-4, the mean of the rest within 1e-3 relative."""
    jr = JRenderer(j_primitives().scene, env=j_constant_env(0.5), width=32, height=32,
                   mesh=j_make_mesh())
    assert jr.mesh.devices.size == 8
    rm, _ = _primitives_pair(8)
    jr.settings.tone_map = "linear"
    jr.render_frames(4)
    rm.render_frames(4)
    jc, pc = np.asarray(jr.accumulated()), rm.accumulated()
    assert np.isfinite(pc).all() and pc.mean() > 0
    diff = np.abs(pc - jc).max(axis=2)
    assert (diff > 1e-4).sum() <= 0.01 * diff.size, np.argwhere(diff > 1e-4).tolist()
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * jc[keep].mean()


def _left_heavy():
    """200 spheres, all but 10 on the -x side of the origin: at 128x64,
    with the camera at half its fitted distance from the origin, the
    second half of the rays in Morton order (the second of two shards)
    has 2,040 primary hits, more than a 4096-ray shard's binned buffer of
    1024 lanes (WRT_BIN_CAP_DIV=4), and the first half 656; the whole
    frame's 2,696 overflow its buffer of 2048."""
    rng = np.random.default_rng(7)
    n = 200
    centres = (rng.random((n, 3)) - 0.5) * np.array([6.0, 4.0, 4.0])
    centres[10:, 0] = -np.abs(centres[10:, 0]) - 0.5
    centres[:10, 0] = 2.5 + rng.random(10)
    z3, z1 = np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    return Geometry(centres.astype(np.float32), (0.5 + rng.random(n) * 0.3).astype(np.float32),
                    rng.random((n, 3)).astype(np.float32), z3, z3, z1, z3)


def test_overflow_in_one_shard_is_redone_alone(monkeypatch):
    """Two shards in 4 chunks each, binned, where only the second shard's
    buffer overflows: that shard's block is redone through the permuted
    transport, the other's replayed frames stand, and the frames equal
    the single-device Renderer's (whose one buffer overflows too)."""
    for k, v in {"WRT_CHUNKS": "4", "WRT_BIN_CAP_DIV": "4"}.items():
        monkeypatch.setenv(k, v)
    scene = compile_scene(_left_heavy(), device="cpu")
    rm = Renderer(scene, width=128, height=64, mesh=cpu_mesh(2))
    r1 = Renderer(scene, width=128, height=64, device="cpu")
    for r in (rm, r1):
        r.settings.max_bounces = 2
        r.camera.target = np.zeros(3)
        r.camera.distance *= 0.5
        r.render_frames(2)
    _same_frames(rm, r1)
    assert rm.stats == {"captures": 0, "overflowed_blocks": 1, "redone_frames": 2}
    assert r1.stats == {"captures": 0, "overflowed_blocks": 1, "redone_frames": 2}


# (b) Samples sharded.

def _frame_inputs(spp, size=16):
    r = Renderer(load_test_primitives(device="cpu").scene, width=size, height=size,
                 device="cpu")
    r.settings.samples_per_bounce = spp
    return r, r.frame_inputs()


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("spp", [8, 5, 3])
def test_spp_sharded_matches_single_device(spp, n):
    """Every global sample index traced once across the shards, for
    divisible and non-divisible spp: within 2e-5 of render_batch."""
    r, (flags, u, px, py) = _frame_inputs(spp)
    assert flags.spp == spp
    single = PI.render_batch(r.scene, flags, u, px, py, 0)
    sharded = render_spp_sharded(cpu_mesh(n), r.scene, None, None, flags, u, px, py, 0)
    assert sharded.shape == single.shape and float(single.mean()) > 0
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=0, atol=2e-5)


def test_spp_sharded_matches_jax():
    """render_spp_sharded at spp 5 on 3 shards against the JAX package's on
    its 8 virtual devices, same pixels and uniforms, within 2e-5."""
    jr = JRenderer(j_primitives().scene, width=16, height=16)
    jr.settings.samples_per_bounce = 5
    basis = jr.camera.basis()
    jflags, ju = j_split(jr.settings, basis, j_lights(jr.settings.lights, basis),
                         has_env=False, has_volume=False, clip=None, distributed=True)
    jx, jy = jr._pixel_grids()
    want = np.asarray(j_spp_sharded(j_make_mesh(), jr.scene, None, None, jflags, ju,
                                    np.asarray(jx), np.asarray(jy), jnp.uint32(0)))
    r, (flags, u, px, py) = _frame_inputs(5)
    assert np.array_equal(px.numpy(), np.asarray(jx))
    got = render_spp_sharded(cpu_mesh(3), r.scene, None, None, flags, u, px, py, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


# (c) Tiles sharded.

@pytest.mark.parametrize("n", [2, 3])
def test_render_tiles_sharded_equals_unsharded(n):
    r, (flags, u, px, py) = _frame_inputs(1, size=32)
    env = constant_env(0.5, device="cpu")
    r.set_env(env)
    flags, u, px, py = r.frame_inputs()
    single = PI.render_batch(r.scene, flags, u, px, py, 3, env=env)
    tiles = render_tiles_sharded(PI.render_batch, cpu_mesh(n), r.scene, env, None, flags,
                                 u, px, py, 3)
    assert torch.equal(tiles, single) and float(single.mean()) > 0


# (d) The Renderer's surface.

def _spheres(count, seed=2):
    return compile_scene(random_sphere_geometry(count, seed=seed), device="cpu")


SURFACE = ["set_env", "set_scene", "set_scale", "vis mode 1"]


@pytest.mark.parametrize("op", SURFACE)
def test_mesh_renderer_surface_equals_single_device(op):
    """A frame, the operation, two more frames: the mesh Renderer (3
    shards) equals the single-device one bit for bit."""
    rm, r1 = _primitives_pair(3, 48, 32)
    other = _spheres(60)
    for r in (rm, r1):
        r.render_frames(1)
        if op == "set_env":
            r.set_env(constant_env(0.2, device="cpu"))
        elif op == "set_scene":
            r.set_scene(other)
        elif op == "set_scale":
            r.set_scale(0.5)
        else:
            r.settings.vis_mode = 1
        r.render_frames(2)
    _same_frames(rm, r1)
    assert rm.accumulated().shape == (r1.height, r1.width, 3)
    if op == "set_scene":
        assert rm.scene is other and all(s.scene is other for s in rm._shards)


@pytest.mark.parametrize("direction", ["mesh to single", "single to mesh"])
def test_checkpoints_cross_mesh_and_single_device(tmp_path, direction):
    """A checkpoint saved on one side loads on the other (the JAX
    package's keys, accum in ray order) and resumed frames equal
    uninterrupted ones bit for bit."""
    rm, r1 = _primitives_pair(3, 48, 32)
    saver, loader = (rm, r1) if direction == "mesh to single" else (r1, rm)
    saver.render_frames(2)
    saver.save_checkpoint(tmp_path / "state.npz")
    loader.load_checkpoint(tmp_path / "state.npz")
    assert loader.frame_index == 2
    assert loader.accumulated().tobytes() == saver.accumulated().tobytes()
    with np.load(tmp_path / "state.npz") as data:
        assert data["accum"].shape == (48 * 32, 3)
    for r in (saver, loader):
        r.render_frames(1)
    assert loader.accumulated().tobytes() == saver.accumulated().tobytes()


# (e) The CLI.

def _cli(argv, capsys):
    assert PCLI.main(argv) == 0
    return capsys.readouterr().out


BASE = ["--scene", "spheres50", "--width", "64", "--height", "48", "--frames", "2",
        "--no-env", "--tone-map", "linear", "--device", "cpu"]


def test_cli_render_devices_2_writes_the_single_device_png(tmp_path, capsys):
    images = []
    for n in (2, 1):
        out = tmp_path / f"devices{n}.png"
        _cli(["render", *BASE, "--devices", str(n), "--out", str(out)], capsys)
        images.append(decode_png(out.read_bytes()))
    assert images[0].shape == (48, 64, 3) and images[0].max() > 0
    assert np.array_equal(images[0], images[1])


def test_cli_bench_reports_its_devices(capsys):
    bench = json.loads(_cli(["bench", *BASE, "--devices", "2"], capsys))
    assert bench["devices"] == 2 and bench["frame_ms"] > 0
    assert (bench["device"], bench["card"]) == ("cpu", None)


def test_cli_pick_on_a_mesh_gives_the_single_device_answer(capsys):
    argv = ["pick", "--molecule", "caffeine", "--px", "40", "--py", "30", "--width", "80",
            "--height", "60", "--no-env", "--device", "cpu"]
    want = _cli(argv, capsys)
    got = _cli(argv + ["--devices", "3"], capsys)
    assert got == want and json.loads(got)["hit"] is not None


def test_cli_serve_builds_a_mesh_renderer(monkeypatch):
    served = []
    monkeypatch.setattr(PSV, "serve", lambda renderer, **kw: served.append(renderer))
    PCLI.main(["serve", *BASE, "--devices", "2", "--port", "0"])
    (r,) = served
    assert r.mesh.size == 2 and r.mesh.devices == (torch.device("cpu"),) * 2


@pytest.mark.parametrize("command", ["render", "bench", "pick", "serve"])
def test_cli_refuses_more_cards_than_visible(command):
    """--devices N beyond the visible cards exits before any work, with
    the JAX CLI's message; --device cpu takes any N."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(2, visible + 1)
    pick = ["--px", "1", "--py", "1"] if command == "pick" else []
    with pytest.raises(SystemExit) as exc:
        PCLI.main([command, "--scene", "primitives", "--devices", str(n), *pick])
    assert f"--devices {n} requested but only {visible}" in str(exc.value.code)
