"""Time the trace kernels' default forms alone (CUDA events, 50 launches
after a warm one) on chip_smoke.py's main-path cases, and volume_march,
trace_stack_closest and trace_stack_any alone and through their entry
points on the cases of PERF.md rows 8, 9 and 9b, for the
webgl_raytracer_tpu_torch package of the checkout given:

    python3 kernel_ab.py TREE TAG [--out FILE]

TREE is a checkout (this one, or another unpacked beside it with `git
archive`); the helpers that make the scenes and record the frames'
batches come from this checkout's chip_smoke.py. The march and the walk
launch alone as the tree's own wrappers launch them: on staged operands
(march_operands, walk_operand) in a tree that has them, else on the
callers' rows (march_args, walk_args), the walk's live list's count
zeroed first. To compare two commits
on one card, run both on the same machine, in turns (parent, change,
change, parent): each run builds its own checkout's kernels. Prints one
JSON line: the card's name and power limit and each case's ms."""
import argparse
import importlib.util
import json
import os
import sys

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("tree")
ap.add_argument("tag")
ap.add_argument("--out")
args = ap.parse_args()
tree, tag = os.path.abspath(args.tree), args.tag
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location(
    "smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
C = importlib.util.module_from_spec(spec)
spec.loader.exec_module(C)

import torch  # noqa: E402

from webgl_raytracer_tpu_torch.device import card_line  # noqa: E402
from webgl_raytracer_tpu_torch.models.density import (  # noqa: E402
    build_nitrogen_density_volume)
from webgl_raytracer_tpu_torch.ops import kernels  # noqa: E402
from webgl_raytracer_tpu_torch.ops import trace as T  # noqa: E402
from webgl_raytracer_tpu_torch.ops import traversal as PT  # noqa: E402
from webgl_raytracer_tpu_torch.ops import volume as PV  # noqa: E402
from webgl_raytracer_tpu_torch.ops.wavefront import scene_types  # noqa: E402
from webgl_raytracer_tpu_torch.render import Renderer  # noqa: E402
from webgl_raytracer_tpu_torch.render.integrator import generate_camera_rays  # noqa: E402
from webgl_raytracer_tpu_torch.scene import compile_scene, random_sphere_geometry  # noqa: E402

assert kernels.PACKAGE_DIR.parent == type(kernels.PACKAGE_DIR)(tree), kernels.PACKAGE_DIR
REPS = 50
dev = torch.device("cuda", 0)
kernels.build()
W, H = 1920, 1080
sky = __import__("webgl_raytracer_tpu_torch.env", fromlist=["x"]).EnvironmentController(
    device=dev).load_analytic_sky()
s1k = compile_scene(random_sphere_geometry(1000), device=dev)
s10k = compile_scene(random_sphere_geometry(10000), device=dev)
s150k = compile_scene(random_sphere_geometry(150000), device=dev)
out = {}


def alone(key, name, scene, od, clip, outs, **kw):
    out[key] = C.kernel_ms(name, scene, od, clip, outs, REPS, **kw)


def closest(key, scene, o3, d3, tmin, clip, active, perray=False):
    od = T.closest_operand(o3, d3, tmin, active, scene.trace_operands.mid)
    n = od.shape[1]
    outs = (torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev))
    alone(key, "trace_closest_perray" if perray else "trace_closest", scene, od, clip, outs,
          group=perray)


def attrs(key, scene, o3, d3, tmin, clip, active):
    ops = scene.trace_operands
    od = T.closest_operand(o3, d3, tmin, active, ops.mid)
    n = od.shape[1]
    outs = (torch.empty(n, device=dev), torch.empty((n, 32), device=dev))
    alone(key, "trace_closest_attrs", scene, od, clip, outs, tables=((ops.attr, torch.float32),))


def any_(key, scene, b, perray=False, schedules=False):
    od = T.any_operand(b["o3"], b["d3"], b["t_min"], b["t_max"],
                       0.0 if b["accept_min"] is None else b["accept_min"], b["active"],
                       scene.trace_operands.mid)
    n = od.shape[1]
    outs = (torch.empty(n, dtype=torch.int32, device=dev),)
    alone(key, "trace_any_perray" if perray else "trace_any", scene, od, b["clip"], outs,
          group=perray)
    if schedules:
        plain = T.trace_any(scene, b["o3"], b["d3"], b["t_min"], t_max=b["t_max"],
                            accept_min=b["accept_min"], clip=b["clip"], active=b["active"])
        for sched, v in C.forced_schedules(scene, od, b["clip"], plain, REPS).items():
            out[f"{key} forced {sched}"] = v["kernel_ms"]


def any3(key, scene, f):
    od = T.any3_operand(f["o3"], f["d3s"], f["t_min"],
                        0.0 if f["accept_min"] is None else f["accept_min"], f["actives"],
                        scene.trace_operands.mid)
    alone(key, "trace_any3", scene, od, f["clip"],
          (torch.empty(od.shape[1], dtype=torch.int32, device=dev),))


r = Renderer(s1k, width=W, height=H, device=dev)
flags, u, px, py = r.frame_inputs()
_, o3, d3 = generate_camera_rays(u, flags, px, py, 0, 0)
tmin = u.t_min.expand(px.shape[0])
closest("1 trace_closest 1000 primary", s1k, o3, d3, tmin, None, None)
attrs("6 trace_closest_attrs 1000 primary", s1k, o3, d3, tmin, None, None)
any3("2 trace_any3 1000 fan", s1k, C.record_frame(r).any3[0])
rec = C.record_frame(C.sky_renderer(s1k, sky, W, H, dev))
any_("3 trace_any 1000 sky env NEE", s1k, next(b for b in rec.any if b["divergent"]),
     schedules=True)
rec = C.record_frame(C.sky_renderer(s10k, sky, W, H, dev))
prim = next(b for b in rec.closest if not b["secondary"])
closest("1b trace_closest 10k primary", s10k, prim["o3"], prim["d3"], prim["t_min"],
        prim["clip"], prim["active"])
attrs("6b trace_closest_attrs 10k primary", s10k, prim["o3"], prim["d3"], prim["t_min"],
      prim["clip"], prim["active"])
any3("2b trace_any3 10k fan", s10k, rec.any3[0])
sec = next(b for b in rec.closest if b["secondary"])
closest("4 trace_closest_perray 10k bounce-1", s10k, sec["o3"], sec["d3"], sec["t_min"],
        sec["clip"], sec["active"], perray=True)
nee = next(b for b in rec.any if b["divergent"])
any_("5 trace_any_perray 10k env NEE", s10k, nee, perray=True)
any_("3b trace_any 10k env NEE forced", s10k, nee, schedules=True)
o3, d3, tmin = C.random_rays(1 << 16, 11, dev, extent=2 * 150000 ** (1 / 3))
closest("4b trace_closest_perray 150k random", s150k, o3, d3, tmin, None, None, perray=True)
any_("5b trace_any_perray 150k random", s150k,
     dict(o3=o3, d3=d3, t_min=tmin, t_max=20.0, accept_min=torch.full_like(tmin, 0.01),
          clip=None, active=None), perray=True)


def stack(key, scene, o3, d3, tmin, active, lo, any_hit):
    """The stack walk alone and through its entry point (t_max BIG)."""
    n = o3[0].shape[0]
    name = "wrt_trace_stack_" + ("any" if any_hit else "closest")
    outs = ([torch.empty(n, dtype=torch.bool, device=dev)] if any_hit else
            [torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
             torch.empty((n, 3), device=dev)])
    outs.append(torch.empty(n, dtype=torch.int32, device=dev))
    tables, types = scene.walk_tables, scene_types(scene)
    if hasattr(PT, "walk_args"):
        args = PT.walk_args(tables, types, o3, d3, tmin, 1e20, lo, None, active, 2048, 4)
        live = (None, None) if active is None else kernels.live_list(n, dev)
        launch = C.alone(lambda: kernels.launch(name, dev, *args, *live, *outs), live[1])
    else:
        od = PT.walk_operand(o3, d3, tmin, 1e20, lo, active)
        cp, clip_on = PT.clip_operand(None, dev)
        tabs = [tables.node_bmin, tables.node_bmax, tables.node_meta, tables.prim_a,
                tables.prim_b, tables.prim_c, tables.prim_type]
        fn, stream = getattr(kernels.library(), name), kernels.stream_handle(dev)
        launch = C.alone(lambda: fn(od.data_ptr(), n, *(x.data_ptr() for x in tabs),
                                    PT.type_mask(types), cp.data_ptr(), int(clip_on), 2048,
                                    4, *(x.data_ptr() for x in outs), stream))
    out[f"{key} alone"] = C.timed_ms(launch, REPS)
    if any_hit:
        out[f"{key} wrapper"] = C.timed_ms(lambda: PT.trace_any(
            scene, o3, d3, tmin, accept_min=lo, active=active), REPS)
    else:
        out[f"{key} wrapper"] = C.timed_ms(lambda: PT.trace_closest(
            scene, o3, d3, tmin, active=active), REPS)


def march(key, vol, o3, d3, ts, uniforms, tp, active, max_steps):
    """The march alone and through its entry point."""
    n = ts.shape[0]
    buf = torch.empty((6, n), device=dev)
    if hasattr(PV, "march_args"):
        args = PV.march_args(vol, o3, d3, ts, *uniforms, tp, active, max_steps)
        launch = C.alone(lambda: kernels.launch("wrt_volume_march", dev, *args, buf))
    else:
        od, params = PV.march_operands(vol, o3, d3, ts, *uniforms, tp, active)
        lib, stream = kernels.library(), kernels.stream_handle(dev)
        launch = C.alone(lambda: lib.wrt_volume_march(
            od.data_ptr(), n, params.data_ptr(), vol.data.data_ptr(), vol.nx, vol.ny, vol.nz,
            max_steps, buf.data_ptr(), stream))
    out[f"{key} alone"] = C.timed_ms(launch, REPS)
    out[f"{key} wrapper"] = C.timed_ms(lambda: PV.march_volume(
        vol, o3, d3, ts, *uniforms, tp, active, max_steps), REPS)


r = Renderer(s1k, width=W, height=H, device=dev)
flags, u, px, py = r.frame_inputs()
_, o3, d3 = generate_camera_rays(u, flags, px, py, 0, 0)
stack("9 trace_stack_closest 1000 primary", s1k, o3, d3, u.t_min.expand(px.shape[0]), None,
      None, False)
fo3, fd3, ftmin, fact, flo, _ = C.stack_fan(s1k, W, H, dev)
stack("9b trace_stack_any 1000 shadow fan [3N]", s1k, fo3, fd3, ftmin, fact, flo, True)
del fo3, fd3, ftmin, fact, flo
tstp, _, mol = C.load_tstp(dev)
vol = build_nitrogen_density_volume(mol).to_device_buffers(dev)
*batch, _ = C.volume_bounce0(C.volume_renderer(tstp, vol, W, H, dev))
march("8 volume_march tstp bounce-0", *batch)
res = {"tree": tag, "card": card_line(), "reps": REPS, "kernel_ms": out}
if args.out:
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(res, f, indent=1)
print(json.dumps(res))
