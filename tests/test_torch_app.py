"""The port's app surface against the JAX package's: the viewer's state
machine route by route, the HTTP and ASGI front ends, the CLI, the PNG
codec, and the imports.

ViewerState: one scripted session (orbit with the axis lock, the preview
scale and its settling, fly, settings coercion and rejection, lights,
sky, env, vis mode 1, hover, focus, load and its errors) runs through the
port's and the JAX package's ViewerState. After every step the answer
(the route's JSON), state(), the settings and the log lines must be
equal; after every frame the accumulated radiance must agree under
tests/test_torch_render.py's frame tolerance (at most 1% of pixels off by
more than 1e-4, the mean of the rest within 1e-3 relative), and the
served PNG must decode to the port's image_u8, upsampled to the base size
while the preview renders smaller. The JAX side runs eagerly
(jax.disable_jit), as in the other frame comparisons. The tracer
settings (tracer "stack", use_bvh false) run through a session of their
own against the JAX ViewerState, and the port's refusal of pdb:ID is
tested on its own.
Vis mode 2 draws a count that the two packages take differently
(tests/test_torch_vis.py), so the session shows mode 1.
"""

import asyncio
import copy
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import threading
import urllib.request
import zlib

import jax
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.app import cli as JCLI
from webgl_raytracer_tpu.app import pipeline as JP
from webgl_raytracer_tpu.app.server import ViewerState as JState
from webgl_raytracer_tpu.ops import traversal as JT
from webgl_raytracer_tpu.render import Renderer as JRenderer
from webgl_raytracer_tpu.render import integrator as JI
from webgl_raytracer_tpu.utils import create_logger as j_logger
from webgl_raytracer_tpu.utils import format_poly_count as j_format
from webgl_raytracer_tpu_torch.app import cli as PCLI
from webgl_raytracer_tpu_torch.app import pipeline as PP
from webgl_raytracer_tpu_torch.app import server as PSV
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.utils import (create_logger, decode_png, encode_png,
                                             format_poly_count, upsample_nearest)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSTP = os.path.join(REPO, "assets", "proteins", "TSTP.pdb")
SKY = {"width": 64, "height": 32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """As in tests/test_torch_render.py: one torch thread for the many
    small tensor ops, restored after this module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _states(width=64, height=48, scene="primitives"):
    """(JAX ViewerState, the port's) over the same scene and size, each
    with its own silent logger; the preview stays until a "settle" step."""
    jl, pl = j_logger(echo=False), create_logger(echo=False)
    jloaded = JP.load_test_primitives() if scene == "primitives" else JP.load_random_spheres(300)
    ploaded = (PP.load_test_primitives(device="cpu") if scene == "primitives"
               else PP.load_random_spheres(300, device="cpu"))
    js = JState(JRenderer(jloaded.scene, width=width, height=height), jl, sky_params=SKY)
    ps = PSV.ViewerState(Renderer(ploaded.scene, width=width, height=height, device="cpu"),
                         pl, sky_params=SKY)
    for s in (js, ps):
        s.SETTLE_SECONDS = 1e9
        s.renderer.settings.max_frames = 1000
    return js, ps


def _settings(jax_renderer):
    """The JAX renderer's settings without surface_show_atoms, a field no
    code of either package reads (the port has no such field)."""
    out = dataclasses.asdict(jax_renderer.settings)
    del out["surface_show_atoms"]
    return out


def _messages(logger):
    return [re.sub(r"^\[\d\d:\d\d:\d\d\] ", "", line) for line in logger.lines]


def _close_frames(jr, pr):
    jc, pc = jr.accumulated(), pr.accumulated()
    assert jc.shape == pc.shape and np.isfinite(pc).all()
    diff = np.abs(pc - jc).max(axis=2)
    assert (diff > 1e-4).sum() <= 0.01 * diff.size, np.argwhere(diff > 1e-4).tolist()
    keep = diff <= 1e-4
    assert abs(pc[keep].mean() - jc[keep].mean()) <= 1e-3 * max(jc[keep].mean(), 1e-6)


def _call(state, step):
    op, *args = step
    if op == "frame":
        return state.frame_png()
    if op == "settle":
        state.SETTLE_SECONDS = 0.0
        return None
    if op == "preview":
        state.SETTLE_SECONDS = 1e9
        return None
    method = {"settings": "update_settings", "light": "update_light", "sky": "update_sky",
              "env": "update_env", "envs": "env_manifest", "load": "load_scene"}.get(op, op)
    return getattr(state, method)(*[json.loads(json.dumps(a)) for a in args])


SESSION = [
    ("state",), ("frame",), ("frame",),
    ("orbit", 1.0, 0.5, True),          # under the lock threshold: ignored
    ("orbit", 6.0, 2.0), ("orbit", 3.0, 9.0),   # yaw lock: dy ignored
    ("frame",),                          # the 16x16 preview, upsampled
    ("hover", 32, 24), ("hover", 1, 1), ("hover", 40.5, 20.25), ("hover", 300, -4),
    ("orbit", 0.0, -8.0, True), ("orbit", 5.0, -3.0),   # pitch lock
    ("fly", ["w", "d"], 0.1), ("fly", ["x"], 0.1), ("fly", ["q", "s"], 0.5),
    ("settings", {"exposure": "1.5", "samples_per_bounce": "2", "cast_shadows": 0,
                  "base_color": [1, 0.5, "0.25"], "tone_map": "reinhard"}),
    ("settings", {"tone_map": "bogus", "exposure": "abc", "base_color": [1, 2],
                  "max_frames": 99999, "clip_distance": 1e6, "bogus": 1, "_x": 2,
                  "lights": 3, "material_mode": "plastic"}),
    ("settings", {"clip_distance": -1e6, "clip_enabled": 1, "max_frames": 500}),
    ("settings", {"clip_enabled": False, "material_mode": "translucent-plastic"}),
    ("light", 0, {"azimuth": -10, "intensity": 2, "enabled": 0}),
    ("light", 1, {"angle": "bogus", "color": [1, 1]}), ("light", 9, {"azimuth": 0.0}),
    ("light", 2, {"color": [0.5, 0.5, 1], "elevation": "12"}),
    ("sky", {"turbidity": 4.0, "sun_elevation_deg": 10.0, "width": 16}),
    ("sky", {"turbidity": 99.0}), ("sky", {"sun_azimuth_deg": "x"}),
    ("settle",), ("frame",),             # full size under the sky
    ("envs",),
    ("env", {"mode": "hdr", "file": "sky_floor_64x32.hdr"}),
    ("env", {"mode": "hdr", "file": "../../secrets.hdr"}), ("env", {"mode": "bogus"}),
    ("env", {"mode": "hdr", "file": "sky floor 64x32"}), ("envs",),
    ("frame",),
    ("focus", 32, 24), ("focus", 0, 0), ("hover", 31.5, 23.5),
    ("preview",), ("sky", {"turbidity": 3.0}), ("envs",),   # back to the sky
    ("settings", {"vis_mode": 1}), ("frame",), ("settings", {"vis_mode": 0}),
    ("env", {"mode": "off"}), ("sky", {"enabled": True}), ("env", {"mode": "sky"}),
    ("sky", {"enabled": False}), ("state",),
    ("load", {"scene": "caffeine"}), ("load", {"scene": "nope"}),
    ("load", {"scene": "caffeine", "style": "bogus"}), ("load", {"scene": "spheres0"}),
    ("load", {"scene": "ethanol", "surface": True, "surface_resolution": 0.01}),
    ("load", {"scene": "ethanol", "surface": True, "probe_radius": 99}),
    ("load", {"scene": "caffeine", "volume": True, "grid_spacing": 0.05}),
    ("load", {"scene": "caffeine", "volume": True, "gaussian_scale": 9.0}),
    ("load", {"scene": "caffeine", "probe_radius": "x"}),
    ("load", {"scene": "protein:NOPE"}),
    ("load", {"scene": "caffeine", "volume": True, "grid_spacing": 0.8}),
    ("load", {"scene": "ethanol", "style": "stick"}),
    ("settle",), ("frame",), ("hover", 32, 24), ("focus", 20, 30),
    ("load", {"scene": "spheres200"}), ("frame",), ("state",), ("hover", 32, 24),
]


def test_viewer_state_session_matches_jax():
    js, ps = _states()
    frames = 0
    for i, step in enumerate(SESSION):
        with jax.disable_jit():
            ja = _call(js, step)
        pa = _call(ps, step)
        jr, pr = js.renderer, ps.renderer
        if step[0] == "frame":
            frames += 1
            _close_frames(jr, pr)
            img = pr.image_u8()
            if (pr.width, pr.height) != (pr.base_width, pr.base_height):
                img = upsample_nearest(img, pr.base_width, pr.base_height)
            assert np.array_equal(decode_png(pa), img), i
        else:
            assert json.dumps(ja) == json.dumps(pa), (i, step, ja, pa)
        assert json.dumps(js.state()) == json.dumps(ps.state()), (i, step)
        assert _settings(jr) == dataclasses.asdict(pr.settings), (i, step)
        assert (jr.env is None) == (pr.env is None), (i, step)
        assert (jr.scale, jr.base_width, jr.base_height) == \
            (pr.scale, pr.base_width, pr.base_height), (i, step)
    assert frames == 8
    assert _messages(js.logger) == _messages(ps.logger)


TRACER_SESSION = [
    ("frame",),
    ("settings", {"tracer": "stack"}), ("frame",), ("frame",), ("hover", 8, 8),
    ("settings", {"tracer": "bogus", "use_bvh": 0}), ("frame",), ("state",),
    ("settings", {"tracer": "wavefront"}), ("frame",),
    ("settings", {"use_bvh": True, "tracer": "stack", "vis_mode": 1}), ("frame",),
    ("settings", {"vis_mode": 0, "tracer": "wavefront"}), ("frame",), ("state",),
]


def test_viewer_tracer_settings_match_jax(monkeypatch):
    """/settings tracer "stack" and use_bvh false through the port's and the
    JAX package's ViewerState, step by step as in
    test_viewer_state_session_matches_jax: the same answers, state,
    settings and log lines, the frames within the frame tolerance. The
    JAX stack walk runs jitted inside its eager frame, as in
    tests/test_torch_render.py test_tracer_frames_match_jax."""
    walk = jax.jit(JT._traverse, static_argnames=("any_hit", "max_steps", "max_leaf"))

    def jitted(*args, **kw):
        with jax.disable_jit(False):
            return walk(*args, **kw)

    monkeypatch.setattr(JI, "_traverse", jitted)
    js, ps = _states(16, 16)
    js.SETTLE_SECONDS = ps.SETTLE_SECONDS = 0.0
    seen = set()
    for i, step in enumerate(TRACER_SESSION):
        with jax.disable_jit():
            ja = _call(js, step)
        pa = _call(ps, step)
        jr, pr = js.renderer, ps.renderer
        seen.add((pr.settings.tracer, pr.settings.use_bvh))
        if step[0] == "frame":
            _close_frames(jr, pr)
            assert np.array_equal(decode_png(pa), pr.image_u8()), i
        else:
            assert json.dumps(ja) == json.dumps(pa), (i, step, ja, pa)
        assert json.dumps(js.state()) == json.dumps(ps.state()), (i, step)
        assert _settings(jr) == dataclasses.asdict(pr.settings), (i, step)
    assert seen == {("wavefront", True), ("stack", True), ("stack", False),
                    ("wavefront", False)}
    assert _messages(js.logger) == _messages(ps.logger)
    assert any("rejected setting tracer='bogus'" in line for line in _messages(ps.logger))


def test_viewer_refusals():
    """The port's own behaviour: pdb:ID answers an error that points to a
    local file, and the scene stays."""
    _, ps = _states(16, 16)
    r = ps.renderer
    prims = r.scene.prim_count
    out = ps.load_scene({"scene": "pdb:1STP"})
    assert out["ok"] is False and "network" in out["error"] and "pdb:1STP" in out["error"]
    assert r.scene.prim_count == prims


def test_viewer_state_threads_lose_no_drag():
    """More threads than cores, a short switch interval: drag threads,
    frame threads and hover threads drive one ViewerState at once. Every
    drag lands (the rotation equals the same drags applied in a row, bit
    for bit), every thread ends and none raised."""
    from webgl_raytracer_tpu_torch.scene.camera import apply_orbit_drag

    loaded = PP.load_test_primitives(device="cpu")
    state = PSV.ViewerState(Renderer(loaded.scene, width=16, height=16, device="cpu"))
    state.orbit(5.0, 0.0, start=True)               # the lock resolves to yaw
    want = state.renderer.camera.rotation
    workers = max(8, (os.cpu_count() or 1) + 2)
    drags, errors = 20, []

    def run(kind):
        try:
            for i in range(drags if kind == "drag" else 3):
                if kind == "drag":
                    state.orbit(3.0, 1.0)
                elif kind == "frame":
                    state.frame_png()
                else:
                    state.hover(8.0 + i, 8.0)
        except Exception as exc:   # reported below
            errors.append(repr(exc))

    kinds = ["drag", "frame", "hover"] * (workers // 3 + 1)
    threads = [threading.Thread(target=run, args=(k,)) for k in kinds]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for _ in range(drags * kinds.count("drag")):
        want = apply_orbit_drag(want, 3.0, 0.0)
    assert state.renderer.camera.rotation.tobytes() == want.tobytes()


def _serve(state_scene=16):
    loaded = PP.load_test_primitives(device="cpu")
    r = Renderer(loaded.scene, width=state_scene, height=state_scene, device="cpu")
    server = PSV.make_server(r, port=0, logger=create_logger(echo=False), sky_params=SKY)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


ROUTES = [
    ("GET", "/", None), ("GET", "/frame.png", None), ("GET", "/state", None),
    ("GET", "/envs", None), ("GET", "/hover?x=8&y=8", None), ("GET", "/hover?x=0&y=0", None),
    ("POST", "/orbit", {"dx": 5, "dy": 1, "start": True}),
    ("POST", "/fly", {"keys": ["w"], "dt": 0.1}), ("POST", "/settings", {"exposure": 1.2}),
    ("POST", "/light", {"index": 0, "intensity": 3}), ("POST", "/sky", {"turbidity": 3}),
    ("POST", "/env", {"mode": "off"}), ("POST", "/focus", {"x": 8, "y": 8}),
    ("POST", "/load", {"scene": "ethanol"}), ("GET", "/frame.png", None),
]


# Malformed requests: (method, path, raw body). Each answers 400 and
# changes nothing; the JAX server raises on them.
BAD_REQUESTS = {
    "hover x": ("GET", "/hover?x=abc&y=8", None),
    "hover y inf": ("GET", "/hover?x=8&y=inf", None),
    "light index str": ("POST", "/light", b'{"index": "x", "intensity": 3}'),
    "light index overflow": ("POST", "/light", b'{"index": 1e999}'),
    "orbit dx str": ("POST", "/orbit", b'{"dx": "x", "dy": 1}'),
    "orbit dy nan": ("POST", "/orbit", b'{"dx": 1, "dy": NaN}'),
    "fly dt null": ("POST", "/fly", b'{"keys": ["w"], "dt": null}'),
    "fly keys int": ("POST", "/fly", b'{"keys": 5, "dt": 0.1}'),
    "fly keys unhashable": ("POST", "/fly", b'{"keys": [["w"]], "dt": 0.1}'),
    "focus x list": ("POST", "/focus", b'{"x": [8], "y": 8}'),
    "settings not an object": ("POST", "/settings", b'[1, 2]'),
    "load not an object": ("POST", "/load", b'"spheres10"'),
    "sky bad json": ("POST", "/sky", b'{bad'),
    "env not utf-8": ("POST", "/env", b'\xff\xfe'),
}


@pytest.mark.parametrize("case", list(BAD_REQUESTS))
def test_malformed_request_answers_400_and_changes_nothing(case):
    method, path, body = BAD_REQUESTS[case]
    loaded = PP.load_test_primitives(device="cpu")
    r = Renderer(loaded.scene, width=16, height=16, device="cpu")
    state = PSV.ViewerState(r, create_logger(echo=False), sky_params=SKY)
    before = (state.state(), copy.deepcopy(r.settings), r.camera.target.copy())
    path, _, query = path.partition("?")
    code, out, ctype = PSV.handle(state, method, path, query, body or b"")
    assert (code, ctype) == (400, "application/json")
    assert json.loads(out)["error"]
    after = (state.state(), r.settings, r.camera.target)
    assert after[:2] == before[:2] and np.array_equal(after[2], before[2])


def test_http_handler_answers_every_route():
    server, thread = _serve()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for method, path, body in ROUTES:
            data = None if body is None else json.dumps(body).encode()
            with urllib.request.urlopen(urllib.request.Request(base + path, data=data,
                                                               method=method)) as resp:
                assert resp.status == 200, path
                out = resp.read()
            if path == "/frame.png":
                assert decode_png(out).shape == (16, 16, 3)
            elif path == "/":
                assert b"webgl_raytracer_tpu_torch" in out and b"pdb:" not in out
            else:
                json.loads(out)
        for method, path, code in (("GET", "/nope", 404), ("POST", "/nope", 404)):
            req = urllib.request.Request(base + path, data=b"{}" if method == "POST" else None,
                                         method=method)
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req)
            assert err.value.code == code
        for method, path, body in BAD_REQUESTS.values():
            req = urllib.request.Request(base + path, data=body, method=method)
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req)
            assert err.value.code == 400, path
        assert server.state.renderer.scene.prim_count == 17     # ethanol: 9 atoms, 8 bonds
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def test_asgi_app_answers_every_route():
    loaded = PP.load_test_primitives(device="cpu")
    app = PSV.asgi_app(Renderer(loaded.scene, width=16, height=16, device="cpu"),
                       sky_params=SKY)

    async def call(method, path, body):
        path, _, query = path.partition("?")
        raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        events = [{"type": "http.request", "body": raw[:5], "more_body": True},
                  {"type": "http.request", "body": raw[5:]}]
        sent = []

        async def receive():
            return events.pop(0)

        async def send(message):
            sent.append(message)

        await app({"type": "http", "method": method, "path": path,
                   "query_string": query.encode()}, receive, send)
        return sent[0]["status"], dict(sent[0]["headers"]), sent[1]["body"]

    for method, path, body in ROUTES:
        status, headers, out = asyncio.run(call(method, path, body or {}))
        assert status == 200, path
        if path == "/frame.png":
            assert headers[b"content-type"] == b"image/png"
            assert decode_png(out).shape == (16, 16, 3)
    assert asyncio.run(call("GET", "/nope", {}))[0] == 404
    for method, path, body in BAD_REQUESTS.values():
        assert asyncio.run(call(method, path, body or b""))[0] == 400, path
    assert app.state.renderer.settings.exposure == 1.2


def _cli(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


CLI_CASES = {
    "pick caffeine": ["pick", "--molecule", "caffeine", "--px", "40", "--py", "30",
                      "--width", "80", "--height", "60", "--no-env"],
    "pick caffeine miss": ["pick", "--molecule", "caffeine", "--px", "1", "--py", "1",
                           "--width", "80", "--height", "60", "--no-env"],
    "pick primitives orbit clip": ["pick", "--scene", "primitives", "--px", "47.5", "--py",
                                   "31", "--width", "96", "--height", "64", "--orbit", "30",
                                   "-20", "--clip", "4", "--no-env"],
    "pick spheres300 sky": ["pick", "--scene", "spheres300", "--px", "32", "--py", "24",
                            "--width", "64", "--height", "48"],
    "info caffeine": ["info", "--molecule", "caffeine"],
    "info TSTP cartoon": ["info", "--pdb-file", TSTP, "--style", "cartoon"],
    "info primitives": ["info", "--scene", "primitives"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_pick_and_info_print_the_jax_json(case, capsys, monkeypatch):
    monkeypatch.setenv("WRT_NO_COMPILE_CACHE", "1")
    argv = CLI_CASES[case]
    with jax.disable_jit():
        want = _cli(JCLI.main, argv, capsys)
    got = _cli(PCLI.main, argv + ["--device", "cpu"], capsys)
    assert json.loads(got) == json.loads(want)
    assert got == want


def test_cli_render_ascii_png_checkpoint_and_bench(tmp_path, capsys):
    base = ["--scene", "spheres50", "--width", "32", "--height", "24", "--frames", "2",
            "--device", "cpu", "--no-env"]
    ascii_art = _cli(PCLI.main, ["render", *base], capsys)
    assert len(ascii_art.splitlines()) == 24 and set(ascii_art) - set(" .:-=+*#%@\n") == set()
    out, ckpt = tmp_path / "out.png", tmp_path / "state.npz"
    _cli(PCLI.main, ["render", *base, "--out", str(out), "--save-checkpoint", str(ckpt),
                     "--tone-map", "linear"], capsys)
    img = decode_png(out.read_bytes())
    assert img.shape == (24, 32, 3) and img.max() > 0
    _cli(PCLI.main, ["render", *base, "--resume", str(ckpt), "--out", str(out)], capsys)
    assert decode_png(out.read_bytes()).shape == (24, 32, 3)
    bench = json.loads(_cli(PCLI.main, ["bench", *base], capsys))
    assert bench["frame_ms"] > 0 and bench["resolution"] == "32x24"
    assert (bench["device"], bench["card"], bench["devices"]) == ("cpu", None, 1)


REFUSED = {
    "--pdb-id": (["--pdb-id", "1STP"], "--pdb-file"),
}


@pytest.mark.parametrize("command", ["render", "bench", "pick", "serve"])
@pytest.mark.parametrize("option", list(REFUSED))
def test_cli_refuses_unported_options(option, command):
    extra, message = REFUSED[option]
    pick = ["--px", "1", "--py", "1"] if command == "pick" else []
    with pytest.raises(SystemExit) as exc:
        PCLI.main([command, *extra, *pick, "--device", "cpu"])
    assert message in str(exc.value.code)


def test_cli_render_stack_tracer(capsys):
    """cli render --tracer stack: the port's CLI renders through the stack
    walk (the JAX package's --tracer stack), the same ASCII frame shape
    as the wavefront tracer's, and a PNG-free run on the CPU."""
    base = ["--molecule", "caffeine", "--width", "24", "--height", "12", "--frames", "1",
            "--device", "cpu", "--no-env", "--bounces", "2"]
    art = _cli(PCLI.main, ["render", *base, "--tracer", "stack"], capsys)
    wave = _cli(PCLI.main, ["render", *base], capsys)
    assert len(art.splitlines()) == len(wave.splitlines()) == 12
    assert set(art) - set(" .:-=+*#%@\n") == set() and art.strip()


def test_png_codec_and_upsample():
    """decode_png(encode_png(img)) is img; Pillow, where it is installed,
    reads the same pixels; upsample_nearest is Pillow's NEAREST resize
    (the JAX viewer's) at the preview sizes the viewer serves."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (27, 33, 3), dtype=np.uint8)
    data = encode_png(img)
    assert np.array_equal(decode_png(data), img)
    rows = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
    assert np.frombuffer(rows, np.uint8).reshape(27, -1)[:, 0].tolist() == [0] * 27
    with pytest.raises(ValueError):
        decode_png(data[:-5] + b"\0" * 5)
    Image = pytest.importorskip("PIL.Image")
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    for (h, w), (H, W) in (((272, 480), (1080, 1920)), ((16, 16), (48, 64)),
                           ((48, 64), (48, 64)), ((33, 17), (1000, 999))):
        small = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(small, "RGB").resize((W, H), Image.NEAREST))
        assert np.array_equal(upsample_nearest(small, W, H), want), (h, w, H, W)


@pytest.mark.parametrize("count", [0, 999, 1000, 56000, 1_234_567, float("nan"), "x"])
def test_format_poly_count(count):
    assert format_poly_count(count) == j_format(count)


def test_app_imports_no_jax_and_no_pillow():
    """With the JAX package blocked, the port's CLI and server import and
    answer a CPU render, and no module of JAX, of the JAX package or of
    Pillow is loaded."""
    code = (
        "import sys\n"
        "sys.modules['webgl_raytracer_tpu'] = None\n"
        "from webgl_raytracer_tpu_torch.app import cli, server\n"
        "assert cli.main(['render', '--scene', 'primitives', '--width', '16', '--height',\n"
        "                 '16', '--frames', '1', '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'PIL')\n"
        "             or (m.split('.')[0] == 'webgl_raytracer_tpu' and sys.modules[m] is not None))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
