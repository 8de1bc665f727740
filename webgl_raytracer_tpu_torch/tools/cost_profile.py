"""Mean primitives tested per ray, by ray population: the port's
counterpart of tools/cost_profile.py, read from the trace kernels' cost
forms (ops/trace.py, "Counts"; the reference's per-pixel BVH walk tests
about 30-60 primitives a ray, webgl.js:556-686).

    python -m webgl_raytracer_tpu_torch.tools.cost_profile --scene spheres1000 \\
        [--perray] [--width W --height H] [--out F] [--device cpu]

The populations come from a real frame, as the JAX tool builds them:
the camera rays of frame 0 (primary); from their hits, cone-jittered
shadow rays toward light 0 (shadow, hit-masked) and hemisphere rays
(secondary, hit-masked); the same two tiled over the whole batch from
the hit lanes only (dense_*), the shape of a compacted batch; those
sorted by compact.bin_key, the binned transport's re-pack order
(binned_*); and, as the port's own population, the three lights' shadow
fan from the hits through trace_any3 (shadow_fan, each direction
cone-jittered; per ray, its lane's count over three). The block kernels
count each ray's own clusters in index order (the TPU kernels charged
every ray its 1024-ray block's union); --perray also reads the per-ray
kernels. On the card every count comes from a kernel's cost form; with
--device cpu from the plain versions, which count the same. The JSON
names the card and its power limit (nvidia-smi), or the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

REFERENCE = "~30-60 (per-pixel BVH walk, webgl.js:556-686)"


def _unit(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def populations(scene, width, height, device):
    """{name: (origins, directions, active mask or None, kind)} with kind
    "closest", "any" or "fan" (directions: three triples); t_min f32[n]; the
    primary hit mask."""
    from ..ops.wavefront import wf_trace_closest_v3
    from ..render import Renderer
    from ..render import compact as CP
    from ..render.integrator import generate_camera_rays

    r = Renderer(scene, width=width, height=height, device=device)
    flags, u, px, py = r.frame_inputs()
    n = px.shape[0]
    _, o3, d3 = generate_camera_rays(u, flags, px, py, 0, 0)
    tmin = u.t_min.expand(n)
    rec = wf_trace_closest_v3(scene, o3, d3, u.t_min, None)
    hit = rec.prim_type >= 0
    t = torch.where(hit, rec.t, 1.0)
    hx = tuple(o3[i] + d3[i] * t for i in range(3))
    bias = torch.clamp_min(u.ray_bias, 1e-4)

    def rays(dirs):
        d = tuple(torch.as_tensor(np.ascontiguousarray(dirs[:, i]), device=device)
                  for i in range(3))
        return tuple(hx[i] + d[i] * bias for i in range(3)), d

    rng = np.random.default_rng(3)
    lights = u.light_dir.cpu().numpy()
    so3, sd3 = rays(_unit(lights[0][None, :]
                          + rng.normal(size=(n, 3)).astype(np.float32) * 0.08))
    bo3, bd3 = rays(_unit(rng.normal(size=(n, 3)).astype(np.float32)))
    fan = [rays(_unit(lights[j][None, :] + rng.normal(size=(n, 3)).astype(np.float32)
                      * 0.08))[1] for j in range(3)]

    hidx = hit.nonzero().squeeze(1)
    reps = -(-n // max(1, hidx.numel()))
    dense = hidx.repeat(reps)[:n] if hidx.numel() else torch.zeros(n, dtype=torch.int64,
                                                                    device=device)

    def take(v):
        return tuple(x[dense] for x in v)

    lo = scene.cluster_bmin.min(dim=0).values
    inv_extent = 1.0 / torch.clamp_min(scene.cluster_bmax.max(dim=0).values - lo, 1e-6)

    def binned(o, d):
        order = torch.argsort(CP.bin_key(o, d, lo, inv_extent), stable=True)
        return tuple(x[order] for x in o), tuple(x[order] for x in d)

    pops = {
        "primary": (o3, d3, None, "closest"),
        "secondary": (bo3, bd3, hit, "closest"),
        "shadow": (so3, sd3, hit, "any"),
        "shadow_fan": (so3, tuple(fan), hit, "fan"),
        "dense_secondary": (take(bo3), take(bd3), None, "closest"),
        "dense_shadow": (take(so3), take(sd3), None, "any"),
        "binned_secondary": (*binned(take(bo3), take(bd3)), None, "closest"),
        "binned_shadow": (*binned(take(so3), take(sd3)), None, "any"),
    }
    return pops, tmin, hit


def profile(scene, name, width=1920, height=1080, perray=False, device=None) -> dict:
    """The report of one scene: mean primitives tested per live ray, by
    population, for the block kernels and (perray, where the scene takes
    the per-ray kernels) the per-ray ones."""
    from ..device import card_line, resolve_device
    from ..ops import trace as T

    device = resolve_device(device)
    if scene.device != device:
        scene = scene.to(device)
    pops, tmin, hit = populations(scene, width, height, device)
    n = tmin.shape[0]
    variants = [False] + ([True] if perray and T.perray_supported(scene) else [])
    report = {"scene": name, "clusters": int(scene.num_clusters), "rays": n,
              "size": f"{width}x{height}", "hit_fraction": float(hit.float().mean()),
              "mean_prims_tested_per_ray": {}, "reference_for_scale": REFERENCE,
              "device": str(device), "card": card_line(device)}
    for per in variants:
        sub = {}
        for pop, (o, d, act, kind) in pops.items():
            if kind == "closest":
                cost = T.trace_closest(scene, o, d, tmin, active=act, perray=per,
                                       with_cost=True)[-1]
            elif kind == "any":
                cost = T.trace_any(scene, o, d, tmin, active=act, perray=per,
                                   with_cost=True)[-1]
            elif per:
                continue
            else:
                cost = T.trace_any3(scene, o, d, tmin, actives=(act, act, act),
                                    with_cost=True)[-1] / 3.0
            live = torch.ones(n, dtype=torch.bool, device=device) if act is None else act
            sub[pop] = float(cost[live].double().mean()) if bool(live.any()) else 0.0
        report["mean_prims_tested_per_ray"]["perray" if per else "block"] = sub
    return report


def load_scene(args, device):
    """(scene, name) from the command line, as the JAX tool loads it:
    spheresN by the reference viewer's mulberry32 scene, a bundled
    molecule, or a PDB file in a display style."""
    from ..app.pipeline import load_molecule_scene, load_random_spheres

    if args.pdb_file:
        from ..models import parse_auto_detect

        with open(args.pdb_file, encoding="utf-8") as f:
            mol = parse_auto_detect(f.read(), args.pdb_file)
        return (load_molecule_scene(mol, display_style=args.style, device=device).scene,
                args.pdb_file)
    if args.molecule:
        from ..models import get_builtin_molecule

        return (load_molecule_scene(get_builtin_molecule(args.molecule),
                                    display_style=args.style, device=device).scene,
                args.molecule)
    return (load_random_spheres(int(args.scene.replace("spheres", "")), device=device).scene,
            args.scene)


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="spheres1000")
    ap.add_argument("--molecule")
    ap.add_argument("--pdb-file", help="PDB file (e.g. assets/proteins/TSTP.pdb)")
    ap.add_argument("--style", default="ball-and-stick")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--perray", action="store_true",
                    help="also measure the per-ray kernels")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    scene, name = load_scene(args, device)
    report = profile(scene, name, args.width, args.height, args.perray, device)
    print(json.dumps(report, indent=2), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
