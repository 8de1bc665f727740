"""Headless CLI: render / bench / pick / info / serve.

Counterpart of webgl_raytracer_tpu/app/cli.py, with its subcommands,
arguments and defaults, on the card unless `--device cpu` is given (the
one option the JAX CLI lacks):

  python -m webgl_raytracer_tpu_torch.app.cli render --molecule caffeine \\
      --width 512 --height 512 --frames 16 --out caffeine.png
  python -m webgl_raytracer_tpu_torch.app.cli render --pdb-file TSTP.pdb \\
      --style cartoon --sky --out cartoon.png
  python -m webgl_raytracer_tpu_torch.app.cli bench --scene spheres1000 --frames 5
  python -m webgl_raytracer_tpu_torch.app.cli pick --molecule caffeine --px 128 --py 128
  python -m webgl_raytracer_tpu_torch.app.cli info --pdb-file TSTP.pdb --style cartoon
  python -m webgl_raytracer_tpu_torch.app.cli serve --scene spheres1000 --port 8000

--telemetry FILE (render, bench) turns the recorder on before the scene
loads and writes its spans, counters and frame rows to FILE as JSON at
the end (utils/telemetry.py).

--devices N renders over the first N cards (parallel/mesh.py: the scene
copied to each, the rays split into one contiguous shard a card), or
with --device cpu over N shards on the CPU; more cards than are visible
is refused. The port refuses --pdb-id with SystemExit and a message
before any work: fetching from RCSB needs the network, so pass the
downloaded file with --pdb-file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..device import card_line
from ..env import EnvironmentController
from ..models import get_builtin_molecule, parse_auto_detect
from ..models.molecular import BUILTIN_MOLECULE_NAMES
from ..parallel import make_mesh
from ..render import Renderer, RenderSettings
from ..render.picking import hover_at_pixel
from ..utils import create_logger, encode_png, format_poly_count, telemetry
from .pipeline import DISPLAY_STYLES, load_molecule_scene, load_random_spheres, load_test_primitives

REFUSED = {
    "pdb_id": "--pdb-id fetches from RCSB over the network, which the port does not "
              "use: download the file and pass it with --pdb-file",
}


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    src = p.add_argument_group("scene source (pick one)")
    src.add_argument("--molecule", choices=BUILTIN_MOLECULE_NAMES,
                     help="built-in molecule")
    src.add_argument("--pdb-file", help="local PDB/SDF/MOL file")
    src.add_argument("--pdb-id", help="4-letter RCSB id (network fetch; refused by "
                                      "the port: use --pdb-file)")
    src.add_argument("--scene", help="test scene: primitives | spheres1000 | spheres10000 | spheresN")
    p.add_argument("--style", choices=DISPLAY_STYLES, default="ball-and-stick")
    p.add_argument("--atom-scale", type=float, default=0.4)
    p.add_argument("--bond-radius", type=float, default=0.12)
    p.add_argument("--surface", action="store_true", help="SES surface")
    p.add_argument("--probe-radius", type=float, default=1.4)
    p.add_argument("--surface-resolution", type=float, default=0.25)
    p.add_argument("--volume", action="store_true", help="nitrogen density volume")
    p.add_argument("--sheet-hbonds", action="store_true", help="debug H-bond cylinders")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0; 'cpu' runs the plain traces)")


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--material", default="metallic",
                   choices=("metallic", "matte", "surface-glass", "translucent-plastic"))
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--tone-map", default="aces", choices=("linear", "aces", "reinhard"))
    p.add_argument("--sky", action="store_true", help="analytic Preetham sky env")
    sky = p.add_argument_group(
        "analytic sky parameters (the reference's sky block, "
        "index.html:702-788; defaults analytic_sky.js:3-14)")
    sky.add_argument("--sky-turbidity", type=float, default=2.5)
    sky.add_argument("--sun-az", type=float, default=30.0,
                     help="sun azimuth, degrees")
    sky.add_argument("--sun-el", type=float, default=35.0,
                     help="sun elevation, degrees")
    sky.add_argument("--sky-intensity", type=float, default=1.0)
    sky.add_argument("--sun-intensity", type=float, default=20.0)
    sky.add_argument("--sun-radius", type=float, default=0.27,
                     help="sun angular radius, degrees")
    sky.add_argument("--ground-albedo", type=float, default=0.2)
    p.add_argument("--no-env", action="store_true",
                   help="disable environment lighting (lights only)")
    p.add_argument("--hdr", help="path to a .hdr environment map")
    p.add_argument("--env-intensity", type=float, default=0.1)
    p.add_argument("--dof", action="store_true")
    p.add_argument("--aperture", type=float, default=0.03)
    p.add_argument("--focus", type=float, default=None)
    p.add_argument("--clip", type=float, default=None,
                   help="camera-forward clip plane at this distance")
    p.add_argument("--vis", type=int, default=0, choices=(0, 1, 2, 3),
                   help="0 render, 1 normals, 2 traversal cost, 3 depth")
    p.add_argument("--tracer", default="wavefront", choices=("wavefront", "stack"))
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="render distributed over the first N GPUs (with --device "
                        "cpu: N CPU shards): scene copied to each, rays "
                        "tile-sharded over a 1-D mesh (parallel/mesh.py). "
                        "Default 1 = single device")
    p.add_argument("--render-scale", type=float, default=1.0,
                   help="internal render resolution scale (renderScale)")
    p.add_argument("--fast-scale", type=float, default=0.25,
                   help="interactive preview scale used by `serve`")
    p.add_argument("--orbit", type=float, nargs=2, metavar=("DX", "DY"),
                   default=None, help="initial orbit drag in pixels")


def _check_ported(args) -> None:
    """SystemExit with its message, before any work, for an option the
    port refuses or more cards than are visible."""
    if getattr(args, "pdb_id", None):
        raise SystemExit(REFUSED["pdb_id"])
    if getattr(args, "devices", 1) > 1:
        _mesh_devices(args)


def _load_scene(args, logger):
    if args.scene:
        name = args.scene.lower()
        if name == "primitives":
            return load_test_primitives(device=args.device), None
        if name.startswith("spheres"):
            count = int(name[len("spheres"):] or 1000)
            logger.info(f"Creating test scene with {count} random spheres")
            return load_random_spheres(count, device=args.device), None
        raise SystemExit(f"unknown test scene: {args.scene}")

    if args.molecule:
        mol = get_builtin_molecule(args.molecule)
    elif args.pdb_file:
        with open(args.pdb_file, "r", encoding="utf-8", errors="replace") as f:
            try:
                mol = parse_auto_detect(f.read(), args.pdb_file)
            except ValueError as exc:
                raise SystemExit(f"failed to parse {args.pdb_file}: {exc}")
    else:
        raise SystemExit("no scene source given (--molecule/--pdb-file/--scene)")

    logger.info(f"Parsed {mol.num_atoms} atoms, {mol.num_bonds} bonds")
    loaded = load_molecule_scene(
        mol,
        display_style=args.style,
        atom_scale=args.atom_scale,
        bond_radius=args.bond_radius,
        show_surface=args.surface,
        probe_radius=args.probe_radius,
        surface_resolution=args.surface_resolution,
        volume_enabled=args.volume,
        show_sheet_hbonds=args.sheet_hbonds,
        logger=logger,
        device=args.device,
    )
    return loaded, mol


def sky_kwargs(args) -> dict:
    """CLI sky flags -> normalize_analytic_sky_settings kwargs."""
    return dict(
        turbidity=args.sky_turbidity,
        sun_azimuth_deg=args.sun_az,
        sun_elevation_deg=args.sun_el,
        sky_intensity=args.sky_intensity,
        sun_intensity=args.sun_intensity,
        sun_angular_radius_deg=args.sun_radius,
        ground_albedo=args.ground_albedo,
    )


def _make_renderer(args, loaded, logger) -> Renderer:
    settings = RenderSettings(
        material_mode=args.material,
        max_bounces=args.bounces,
        samples_per_bounce=args.spp,
        max_frames=max(1, args.frames),
        exposure=args.exposure,
        tone_map=args.tone_map,
        env_intensity=args.env_intensity,
        dof_enabled=args.dof,
        dof_aperture=args.aperture,
        vis_mode=args.vis,
        tracer=args.tracer,
        render_scale=args.render_scale,
        fast_scale=args.fast_scale,
        volume_enabled=loaded.volume is not None,
    )
    # The reference viewer always has an environment bound, by default the
    # analytic sky at envIntensity 0.1; --no-env opts out.
    env = None
    if args.hdr:
        env = EnvironmentController(logger=logger, device=args.device).load_hdr_file(args.hdr)
    elif args.sky or not args.no_env:
        env = EnvironmentController(logger=logger, device=args.device).load_analytic_sky(
            **sky_kwargs(args))

    mesh = _mesh(args, logger) if args.devices > 1 else None
    volume = (loaded.volume.to_device_buffers(args.device)
              if loaded.volume is not None else None)
    r = Renderer(loaded.scene, settings=settings, env=env, volume=volume,
                 width=args.width, height=args.height, device=args.device, mesh=mesh)
    if args.render_scale != 1.0:
        r.set_scale(args.render_scale)
    if args.focus is not None:
        r.settings.dof_focus_distance = args.focus
    elif args.dof:
        r.settings.dof_focus_distance = float(r.camera.distance)
    if args.clip is not None:
        r.settings.clip_enabled = True
        r.settings.clip_distance = args.clip
    if args.orbit:
        r.camera.drag(args.orbit[0], args.orbit[1])
    return r


def _mesh_devices(args) -> list:
    """The devices of --devices N: the first N cards, or N CPU shards with
    --device cpu. SystemExit when fewer cards are visible."""
    if args.device is not None and torch.device(args.device).type == "cpu":
        return [torch.device("cpu")] * args.devices
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < args.devices:
        raise SystemExit(f"--devices {args.devices} requested but only {visible} "
                         "cuda device(s) visible")
    return [torch.device("cuda", i) for i in range(args.devices)]


def _mesh(args, logger):
    devices = _mesh_devices(args)
    logger.info(f"Distributed over {args.devices} {devices[0].type} devices "
                "(tile-sharded mesh)")
    return make_mesh(devices)


def save_png(path: str, image_u8) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image_u8))


def cmd_render(args) -> int:
    logger = create_logger()
    loaded, _ = _load_scene(args, logger)
    logger.info(
        f"Scene: {format_poly_count(loaded.stats.get('triangles', 0))} tris, "
        f"{loaded.stats.get('spheres', 0)} spheres, "
        f"{loaded.stats.get('cylinders', 0)} cylinders, "
        f"{loaded.scene.num_clusters} clusters"
    )
    r = _make_renderer(args, loaded, logger)
    if args.resume:
        r.load_checkpoint(args.resume)
        logger.info(f"Resumed from {args.resume} at frame {r.frame_index}")
        r.settings.max_frames = max(r.settings.max_frames, r.frame_index + args.frames)
    t0 = time.perf_counter()
    frames = 0
    while frames < args.frames and r.render_frame():
        frames += 1
    dt = time.perf_counter() - t0
    logger.info(f"Rendered {frames} progressive frames in {dt:.2f}s "
                f"({dt / max(1, frames) * 1000:.0f} ms/frame)")
    if args.save_checkpoint:
        r.save_checkpoint(args.save_checkpoint)
        logger.info(f"Checkpoint saved to {args.save_checkpoint}")
    img = r.image_u8()
    if args.out:
        save_png(args.out, img)
        logger.info(f"Wrote {args.out}")
    else:
        lum = img.mean(axis=2) / 255.0
        chars = " .:-=+*#%@"
        step_y = max(1, args.height // 32)
        step_x = max(1, args.width // 96)
        for row in lum[::step_y]:
            print("".join(chars[min(9, int(v * 10))] for v in row[::step_x]))
    return 0


def cmd_bench(args) -> int:
    """Steady-state frame time: blocks of --frames frames (on the card,
    replays of the captured frame) between device synchronisations, best
    of 3 after a warm block that captures."""
    logger = create_logger()
    loaded, _ = _load_scene(args, logger)
    r = _make_renderer(args, loaded, logger)
    r.settings.max_frames = 10 ** 9
    cuda = r.device.type == "cuda"
    devices = list(dict.fromkeys(r.mesh.devices if r.mesh is not None else (r.device,)))

    def sync():
        for d in devices if cuda else ():
            torch.cuda.synchronize(d)

    n = max(1, args.frames)
    r.render_frames(n)
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        r.render_frames(n)
        sync()
        best = min(best, (time.perf_counter() - t0) / n)
    print(json.dumps({
        "frame_ms": best * 1000,
        "mpixels_per_s": args.width * args.height / best / 1e6,
        "resolution": f"{args.width}x{args.height}",
        "device": torch.cuda.get_device_name(r.device) if cuda else str(r.device),
        "card": (card_line(r.device) if len(devices) == 1
                 else "; ".join(f"{d}: {card_line(d)}" for d in devices)),
        "devices": args.devices,
    }))
    return 0


def hover_json(hover) -> dict:
    """What `pick` prints for a hover_at_pixel result (None: a miss)."""
    if hover is None:
        return {"hit": None}
    return {
        "hit": {
            "t": round(hover.hit.t, 6),
            "prim_type": hover.hit.prim_type,
            "prim_index": hover.hit.prim_index,
            "label": hover.label,
        },
        "bounds_min": [round(float(v), 4) for v in hover.bounds_min],
        "bounds_max": [round(float(v), 4) for v in hover.bounds_max],
        "rect": hover.rect,
    }


def cmd_pick(args) -> int:
    logger = create_logger(echo=False)
    loaded, _ = _load_scene(args, logger)
    r = _make_renderer(args, loaded, logger)
    print(json.dumps(hover_json(hover_at_pixel(r, args.px, args.py))))
    return 0


def cmd_serve(args) -> int:
    logger = create_logger()
    loaded, _ = _load_scene(args, logger)
    r = _make_renderer(args, loaded, logger)
    from .server import serve

    serve(r, host=args.host, port=args.port, logger=logger, sky_params=sky_kwargs(args),
          env_enabled=not args.no_env and not args.hdr)
    return 0


def cmd_info(args) -> int:
    logger = create_logger(echo=False)
    loaded, mol = _load_scene(args, logger)
    print(json.dumps(scene_info(loaded, mol)))
    return 0


def scene_info(loaded, mol=None) -> dict:
    """What `info` prints, in the JAX CLI's key order: the scene's stats
    and, for a molecule, the node count of the scene's BVH of picking
    (built here, not at load) and the molecule's counts."""
    info = dict(loaded.stats)
    if mol is not None:
        clusters = info.pop("clusters")
        info.update(bvh_nodes=loaded.scene.pick_tables.node_count, clusters=clusters,
                    atoms=mol.num_atoms, bonds=mol.num_bonds,
                    helices=len(mol.helices), sheets=len(mol.sheets))
    return info


def _add_telemetry_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--telemetry", metavar="FILE",
                   help="record spans and counters (utils/telemetry.py) from before the "
                        "scene loads and write them to FILE as JSON at the end")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="webgl_raytracer_tpu_torch",
        description="molecular path tracer on an NVIDIA GPU (PyTorch/CUDA port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="render a scene to PNG/ASCII")
    _add_scene_args(p_render)
    _add_render_args(p_render)
    p_render.add_argument("--out", help="output PNG path")
    p_render.add_argument("--save-checkpoint", help="write accumulation state (.npz)")
    p_render.add_argument("--resume", help="resume accumulation from a checkpoint")
    _add_telemetry_arg(p_render)
    p_render.set_defaults(func=cmd_render)

    p_serve = sub.add_parser("serve", help="interactive web viewer (HTTP)")
    _add_scene_args(p_serve)
    _add_render_args(p_serve)
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.set_defaults(func=cmd_serve)

    p_bench = sub.add_parser("bench", help="time steady-state frames")
    _add_scene_args(p_bench)
    _add_render_args(p_bench)
    _add_telemetry_arg(p_bench)
    p_bench.set_defaults(func=cmd_bench)

    p_pick = sub.add_parser("pick", help="CPU ray pick at a pixel")
    _add_scene_args(p_pick)
    _add_render_args(p_pick)
    p_pick.add_argument("--px", type=float, required=True)
    p_pick.add_argument("--py", type=float, required=True)
    p_pick.set_defaults(func=cmd_pick)

    p_info = sub.add_parser("info", help="scene statistics as JSON")
    _add_scene_args(p_info)
    p_info.set_defaults(func=cmd_info)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _check_ported(args)
    path = getattr(args, "telemetry", None)
    if not path:
        return args.func(args)
    telemetry.enable()
    try:
        rc = args.func(args)
        telemetry.export(path)
    finally:
        telemetry.disable()
    return rc


if __name__ == "__main__":
    sys.exit(main())
