"""The bounce step's shading kernels (ops/shade.py, csrc/shade.cu): what
the CPU can check of the CUDA path.

The kernels run only on the card (tests/test_torch_kernels_cuda.py holds
them against the plain step bit for bit). Here, on CPU tensors:
  - the wrappers' operand checks refuse every malformed operand (type,
    shape, device, contiguity, lane count) before any launch, with
    ops/kernels.launch replaced by a trap;
  - the kernels get the callers' tensors themselves, nothing staged;
  - every batch a frame's bounce step hands over, on each transport and
    tracer, with and without the sky, passes those checks (the fused step
    forced onto CPU tensors, its launches stubbed);
  - on CPU tensors, and with impl="plain", the plain step runs and
    nothing launches;
  - the Python side's layout (params, rows, bits) is csrc/shade.cuh's.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from webgl_raytracer_tpu_torch.env import EnvironmentController
from webgl_raytracer_tpu_torch.ops import kernels
from webgl_raytracer_tpu_torch.ops import shade as SH
from webgl_raytracer_tpu_torch.render import Renderer
from webgl_raytracer_tpu_torch.render import integrator as PI
from webgl_raytracer_tpu_torch.scene import compile_scene, molecule_geometry

TRIS = np.array([[[-4, -3.0, -4], [4, -3.0, -4], [0, -3.0, 4]],
                 [[-4, 3.0, -4], [0, 3.0, 4], [4, 3.0, -4]]], np.float32)
HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "webgl_raytracer_tpu_torch", "csrc", "shade.cuh")

_CACHE = {}


def _scene():
    if "scene" not in _CACHE:
        _CACHE["scene"] = compile_scene(molecule_geometry("caffeine"), tri_verts=TRIS,
                                        tri_flags=np.array([1.0, 0.0], np.float32),
                                        device="cpu")
    return _CACHE["scene"]


def _sky():
    if "sky" not in _CACHE:
        _CACHE["sky"] = EnvironmentController(device="cpu").load_analytic_sky(width=64,
                                                                              height=32)
    return _CACHE["sky"]


def _renderer(sky=True, size=(32, 24)):
    r = Renderer(_scene(), env=_sky() if sky else None, width=size[0], height=size[1],
                 device="cpu")
    r.settings.env_intensity = 0.4
    return r


def _batch(sky=True, attrs=False):
    """(flags, env, params, state, record, attrs) of a frame's bounce 0 as
    the whole-batch transport hands it over: camera rays, the expanded
    camera origin, a full record."""
    r = _renderer(sky)
    flags, u, px, py = r.frame_inputs()
    seed, o3, d3 = PI.generate_camera_rays(u, flags, px, py, 0, 0)
    st = PI._initial_state(seed, o3, d3, px.device)
    rec = PI._closest_hit(r.scene, flags, o3, d3, u.t_min, None, with_attrs=attrs)
    rows = None
    if attrs:
        rec, rows = rec
    return flags, r.env, SH.shade_params(flags, u), st, rec, rows


@pytest.fixture
def trap(monkeypatch):
    def launched(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(kernels, "launch", launched)


def _strided(x):
    """The same values as a row with stride 2."""
    return torch.stack([x, x], 1)[:, 0]


def _state(st, **kw):
    return dataclasses.replace(st, **kw)


BAD_SURFACE_OPERANDS = {
    "f64 origin": lambda st, rec, a, p: (
        _state(st, origin=(st.origin[0].double(), *st.origin[1:])), rec, a, p),
    "short direction row": lambda st, rec, a, p: (
        _state(st, direction=(st.direction[0], st.direction[1][:-1], st.direction[2])),
        rec, a, p),
    "non-contiguous throughput row": lambda st, rec, a, p: (
        _state(st, throughput=(_strided(st.throughput[0]), *st.throughput[1:])), rec, a, p),
    "f64 last pdf": lambda st, rec, a, p: (_state(st, last_pdf=st.last_pdf.double()),
                                           rec, a, p),
    "i32 seed": lambda st, rec, a, p: (_state(st, seed=st.seed.int()), rec, a, p),
    "seed of two dimensions": lambda st, rec, a, p: (_state(st, seed=st.seed[:, None]),
                                                     rec, a, p),
    "radiance row on another device": lambda st, rec, a, p: (
        _state(st, radiance=(st.radiance[0].to("meta"), *st.radiance[1:])), rec, a, p),
    "non-contiguous radiance row": lambda st, rec, a, p: (
        _state(st, radiance=(*st.radiance[:2], _strided(st.radiance[2]))), rec, a, p),
    "radiance of one value": lambda st, rec, a, p: (
        _state(st, radiance=(torch.zeros(()).expand(st.seed.shape[0]),
                             *st.radiance[1:])), rec, a, p),
    "int alive mask": lambda st, rec, a, p: (_state(st, alive=st.alive.int()), rec, a, p),
    "short alive mask": lambda st, rec, a, p: (_state(st, alive=st.alive[:-1]), rec, a, p),
    "f64 hit t": lambda st, rec, a, p: (st, dataclasses.replace(rec, t=rec.t.double()), a, p),
    "i64 prim_slot": lambda st, rec, a, p: (
        st, dataclasses.replace(rec, prim_slot=rec.prim_slot.long()), a, p),
    "short prim_type": lambda st, rec, a, p: (
        st, dataclasses.replace(rec, prim_type=rec.prim_type[:-1]), a, p),
    "extra of two columns": lambda st, rec, a, p: (
        st, dataclasses.replace(rec, extra=rec.extra[:, :2].contiguous()), a, p),
    "non-contiguous extra": lambda st, rec, a, p: (
        st, dataclasses.replace(rec, extra=rec.extra.t().contiguous().t()), a, p),
    "short params": lambda st, rec, a, p: (st, rec, a, p[:-1]),
    "f64 params": lambda st, rec, a, p: (st, rec, a, p.double()),
    "params on another device": lambda st, rec, a, p: (st, rec, a, p.to("meta")),
}
BAD_ATTRS = {
    "attrs of 31 columns": lambda a: a[:, :31].contiguous(),
    "attrs of other lanes": lambda a: a[:-1],
    "f64 attrs": lambda a: a.double(),
}


@pytest.mark.parametrize("case", list(BAD_SURFACE_OPERANDS))
def test_surface_kernel_refuses_operands_before_any_launch(case, trap):
    """shade_surface's wrapper checks every operand it hands the kernel and
    raises before it allocates or launches."""
    flags, env, params, st, rec, _ = _batch()
    st, rec, attrs, params = BAD_SURFACE_OPERANDS[case](st, rec, None, params)
    with pytest.raises(ValueError):
        SH.shade_surface(_scene(), flags, env, params, 0, st, rec, attrs)


@pytest.mark.parametrize("case", list(BAD_ATTRS))
def test_surface_kernel_refuses_attrs_rows_before_any_launch(case, trap):
    flags, env, params, st, rec, attrs = _batch(attrs=True)
    with pytest.raises(ValueError):
        SH.shade_surface(_scene(), flags, env, params, 0, st, rec, BAD_ATTRS[case](attrs))


def _surface(n, bits=0):
    return SH.Surface(seed=torch.zeros(n, dtype=torch.int64),
                      state=torch.zeros((10, n)), alive=torch.zeros(n, dtype=torch.bool),
                      work=torch.zeros((SH.WORK_ROWS, n)),
                      lanes=torch.zeros((SH.LANE_ROWS_COUNT, n), dtype=torch.uint8),
                      bits=bits)


def _scatter_operands(sky=True):
    flags, env, params, st, _, _ = _batch(sky)
    n = st.seed.shape[0]
    occ = [torch.zeros(n, dtype=torch.bool) for _ in range(3)]
    env_occ = torch.zeros(n, dtype=torch.bool) if sky else None
    return flags, env, params, _surface(n), occ, env_occ, st.radiance


BAD_SCATTER_OPERANDS = {
    "no occlusion of an enabled light": lambda f, s, occ, e, rad: (
        f, s, [None, *occ[1:]], e, rad),
    "occlusion of a disabled light": lambda f, s, occ, e, rad: (
        dataclasses.replace(f, light_enabled=(True, False, True)), s, occ, e, rad),
    "occlusion without shadows": lambda f, s, occ, e, rad: (
        dataclasses.replace(f, cast_shadows=False), s, occ, e, rad),
    "int occlusion mask": lambda f, s, occ, e, rad: (f, s, [occ[0].int(), *occ[1:]], e, rad),
    "short env occlusion": lambda f, s, occ, e, rad: (f, s, occ, e[:-1], rad),
    "env occlusion without the env": lambda f, s, occ, e, rad: (
        dataclasses.replace(f, use_env=False), s, occ, e, rad),
    "f64 radiance row": lambda f, s, occ, e, rad: (f, s, occ, e, (rad[0].double(), *rad[1:])),
    "lane rows of another shape": lambda f, s, occ, e, rad: (
        f, dataclasses.replace(s, lanes=s.lanes[:4]), occ, e, rad),
    "i32 seed": lambda f, s, occ, e, rad: (f, dataclasses.replace(s, seed=s.seed.int()), occ,
                                           e, rad),
    "short state": lambda f, s, occ, e, rad: (
        f, dataclasses.replace(s, state=s.state[:9].contiguous()), occ, e, rad),
}


@pytest.mark.parametrize("case", list(BAD_SCATTER_OPERANDS))
def test_scatter_kernel_refuses_operands_before_any_launch(case, trap):
    flags, env, params, surf, occ, env_occ, rad = _scatter_operands()
    flags, surf, occ, env_occ, rad = BAD_SCATTER_OPERANDS[case](flags, surf, occ, env_occ,
                                                                 rad)
    with pytest.raises(ValueError):
        SH.shade_scatter(flags, env, params, 1, surf, occ, env_occ, rad)


def test_surface_kernel_takes_the_callers_tensors(monkeypatch):
    """Nothing is staged: the kernel gets the state's rows (the camera
    origin as one value, step 0), radiance, mask and record themselves,
    the cluster table's rows as views, the environment's tables, and the
    outputs the wrapper allocates."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a) or 0)
    flags, env, params, st, rec, _ = _batch()
    n = st.seed.shape[0]
    surf = SH.shade_surface(_scene(), flags, env, params, 2, st, rec)
    (entry, device, *args), = calls
    assert entry == "wrt_shade_surface" and device == st.seed.device
    assert args[:4] == [n, 2, 0, SH.config_bits(_scene(), flags, False)]
    assert args[4] is st.seed
    rows = args[5:25]
    assert all(a is b for a, b in zip(rows[0::2], (*st.origin, *st.direction,
                                                    *st.throughput, st.last_pdf)))
    assert rows[1::2] == [0, 0, 0] + [1] * 7
    assert all(a is b for a, b in zip(args[25:29], (*st.radiance, st.alive)))
    assert all(a is b for a, b in zip(args[29:34], (rec.t, rec.prim_type, rec.prim_local,
                                                    rec.prim_slot, rec.extra)))
    table = _scene().cluster_prims
    assert [a.data_ptr() - table.data_ptr() for a in args[34:37]] == [0, 16, 32]
    assert args[37] == 12 and args[38] is _scene().cluster_color and args[39] == 3
    assert args[40] is _scene().tri_normals and args[42] is _scene().tri_flags
    assert args[45:48] == [env.radiance, env.marginal_cdf, env.conditional_cdf]
    assert args[48:52] == [env.width, env.height, SH.bisect_trips(env.height + 1),
                           SH.bisect_trips(env.width + 1)]
    assert args[52] is params
    assert args[53:] == [surf.seed, surf.state, surf.alive, surf.work, surf.lanes]
    assert surf.state.shape == (10, n) and surf.work.shape == (SH.WORK_ROWS, n)
    assert surf.fan_masks.dtype == torch.bool and surf.fan_masks.shape == (3, n)


def test_surface_kernel_reads_attrs_rows_by_lane(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a) or 0)
    flags, env, params, st, rec, attrs = _batch(attrs=True)
    SH.shade_surface(_scene(), flags, env, params, 0, st, rec, attrs)
    (_, _, *args), = calls
    assert args[3] & SH.ROWS_BY_LANE
    offsets = [a.data_ptr() - attrs.data_ptr() for a in args[34:37]]
    assert offsets == [0, 16, 32] and args[37] == 32
    assert [args[i].data_ptr() - attrs.data_ptr() for i in (38, 40, 42)] == [48, 60, 96]


# (settings, knobs) of the frames whose every bounce step's batches the
# kernels must take as they are.
FRAMES = {
    "whole batch": ({}, {"WRT_CHUNKS": "1"}),
    "binned": ({}, {"WRT_CHUNKS": "4", "WRT_BINNED": "1"}),
    "permuted": ({}, {"WRT_CHUNKS": "4", "WRT_BINNED": "0"}),
    "attrs rows": ({}, {"WRT_CHUNKS": "4", "WRT_ATTRS": "1"}),
    "stack tracer": ({"tracer": "stack"}, {"WRT_CHUNKS": "1"}),
    "brute sweep": ({"use_bvh": False}, {"WRT_CHUNKS": "1"}),
}


@pytest.mark.parametrize("sky", [False, True], ids=["ambient", "sky"])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_shade_operands_take_every_batch_a_frame_hands_over(frame, sky, monkeypatch):
    """The fused step forced onto CPU tensors, its two launches stubbed
    (shade_surface's outputs zeroed: every lane ends its path): each
    bounce of each chunk hands both kernels operands their checks take,
    bounces after the first the fused step's own state."""
    settings, knobs = FRAMES[frame]
    for k in PI.TRANSPORT_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    seen = []

    def launch(entry, device, *args):
        seen.append(entry)
        if entry == "wrt_shade_surface":
            for out in args[-5:]:
                out.zero_()
        return 0

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(PI, "_use_kernel", lambda x, impl: impl is None)
    r = _renderer(sky, size=(64, 64))
    for k, v in settings.items():
        setattr(r.settings, k, v)
    r.render(1)
    chunks = 4 if frame in ("permuted", "attrs rows") else 1
    assert seen == ["wrt_shade_surface", "wrt_shade_scatter"] * (4 * chunks)


def test_volume_frame_operands_after_the_march(monkeypatch):
    """A volume frame (the march's throughput rows, then the shading)."""
    from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
    from webgl_raytracer_tpu_torch.models import get_builtin_molecule

    seen = []

    def launch(entry, device, *args):
        seen.append(entry)
        if entry == "wrt_shade_surface":
            for out in args[-5:]:
                out.zero_()
        return 0

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(PI, "_use_kernel", lambda x, impl: impl is None)
    loaded = load_molecule_scene(get_builtin_molecule("caffeine"), display_style="stick",
                                 volume_enabled=True, volume_options=dict(spacing=0.8),
                                 device="cpu")
    r = Renderer(loaded.scene, volume=loaded.volume.to_device_buffers("cpu"), width=16,
                 height=16, device="cpu")
    r.settings.volume_enabled = True
    r.settings.max_bounces = 2
    r.render(1)
    assert seen == ["wrt_shade_surface", "wrt_shade_scatter"] * 2


@pytest.mark.parametrize("impl", [None, "plain"])
def test_cpu_tensors_take_the_plain_step_and_launch_nothing(impl, trap):
    """On CPU tensors, and with impl="plain", the factory returns the
    plain step, and a frame renders without a launch."""
    r = _renderer()
    flags, u, px, py = r.frame_inputs()
    step = PI._make_bounce_step(r.scene, r.env, flags, u, px.shape[0], impl=impl)
    assert step.__name__ == "bounce_body"
    r.impl = impl
    assert float(r.render(1).mean()) > 0.0


def test_params_are_the_uniforms_in_the_kernels_order():
    """params: PARAM_FIELDS' uniforms in order, each enabled light's axis
    -ld / |ld| and a disabled light's 0."""
    r = _renderer()
    r.settings.lights[1].enabled = False
    flags, u, _, _ = r.frame_inputs()
    p = SH.shade_params(flags, u)
    assert p.shape == (SH.PARAMS,) and p.dtype == torch.float32
    at = 0
    for name, size in SH.PARAM_FIELDS:
        got = p[at:at + size]
        if name == "light_axis":
            for i in range(3):
                ld = u.light_dir[i].double()
                want = -ld / ld.norm() if flags.light_enabled[i] else torch.zeros(3)
                assert torch.allclose(got[3 * i:3 * i + 3].double(), want.double(),
                                      atol=1e-6)
            assert not bool(got[3:6].any())
        else:
            assert torch.equal(got, getattr(u, name).reshape(-1))
        at += size
    assert at == SH.PARAMS


def _header_constants():
    text = open(HEADER, encoding="utf-8").read()
    return {m.group(1): int(eval(m.group(2)))  # noqa: S307 - integer literals and shifts
            for m in re.finditer(r"constexpr (?:int|unsigned char) (\w+) = ([0-9 <<]+);",
                                 text)}


def test_python_layout_is_the_headers():
    """Bits, buffer rows and the params size as csrc/shade.cuh has them."""
    c = _header_constants()
    assert c["kParams"] == SH.PARAMS
    assert c["kWorkRows"] == SH.WORK_ROWS and c["kLaneRowsCount"] == SH.LANE_ROWS_COUNT
    for py, cc in (("USE_ENV", "kUseEnv"), ("IMPORTED_COLOR", "kImportedColor"),
                   ("TRI_FLAGS", "kTriFlags"), ("ROWS_BY_LANE", "kRowsByLane"),
                   ("SHADOWS", "kShadows"), ("RIM", "kRim"), ("HAS_SPHERE", "kHasSphere"),
                   ("HAS_CYLINDER", "kHasCylinder"), ("HAS_TRIANGLE", "kHasTriangle"),
                   ("LIGHT0", "kLight0")):
        assert getattr(SH, py) == c[cc], py
    assert c["kEnvDir"] == 12 and c["kEnvMask"] == 3   # Surface.env_dir, env_mask


def test_config_bits_follow_the_flags_and_the_scene():
    r = _renderer()
    r.settings.material_mode = "surface-glass"
    r.settings.surface_flag_mode = 1
    r.settings.lights[2].enabled = False
    flags, _, _, _ = r.frame_inputs()
    bits = SH.config_bits(_scene(), flags, lane_rows=False)
    assert bits == (SH.USE_ENV | SH.IMPORTED_COLOR | SH.TRI_FLAGS | SH.SHADOWS | SH.RIM
                    | SH.HAS_SPHERE | SH.HAS_CYLINDER | SH.HAS_TRIANGLE | SH.LIGHT0
                    | SH.LIGHT0 << 1)
