"""Time the trace kernels' default forms alone (CUDA events, 50 launches
after a warm one) on chip_smoke.py's main-path cases, for the
webgl_raytracer_tpu_torch package of the checkout given:

    python3 kernel_ab.py TREE TAG [--out FILE]

TREE is a checkout (this one, or another unpacked beside it with `git
archive`); the helpers that make the scenes and record the frames'
batches come from this checkout's chip_smoke.py. To compare two commits
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
from webgl_raytracer_tpu_torch.ops import kernels  # noqa: E402
from webgl_raytracer_tpu_torch.ops import trace as T  # noqa: E402
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
res = {"tree": tag, "card": card_line(), "reps": REPS, "kernel_ms": out}
if args.out:
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(res, f, indent=1)
print(json.dumps(res))
