"""Image parity of the port's renderer against its reference oracle, on a GPU.

    python -m webgl_raytracer_tpu_torch.tools.parity_rmse [--only S] [--skip S]
        [--oracle-cache DIR] [--out PATH]

Counterpart of tools/parity_rmse.py, run through the port's own Renderer,
settings split and scene loaders against its own oracle
(render/reference_oracle.py). For the non-glass material modes the
renderer and the oracle consume the same PCG stream, so after the same
number of progressive frames the two accumulations differ only by f32
arithmetic and the RMSE measures arithmetic fidelity, not Monte-Carlo
variance. Glass rows (modes 2/3) draw divergently by design and compare
converged images.

Rows: the 13 rows of PARITY_RMSE.json, with the same scenes, settings,
sizes and frames (128x128; 64 frames, 256 for glass), the nitrogen
density volume and the SES surface included.

The gate is the frozen one (docs/ARCHITECTURE.md, "Parity gate"):
stream-exact rows pass at raw RMSE <= 1e-3, or at flip-excluded RMSE <=
1e-3 with fewer than 5% of pixels flipped (a pixel whose channels differ
by more than 0.01); a row that passes only by the exclusion also needs the
device-arithmetic control: the same row rendered on the same card by
another traversal, here the port's plain PyTorch one (impl="plain"),
which must agree with the kernels' image on more than 99.5% of pixels
within 1e-6. Glass rows pass at RMSE <= 3e-3 with no exclusions.

The oracle traces on the card (its own dense all-pairs trace, bit for bit
its numpy trace; numpy alone would take hours for the whole table). Each
row records which trace served it ("cache" when --oracle-cache held the
row). Writes
PARITY_RMSE_TORCH.json at the repository root (a run filtered by
--only/--skip merges into the existing file), with the card's name and
power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROTEIN = os.path.join(REPO, "assets", "proteins", "TSTP.pdb")
ENV_FILES = {"sun": os.path.join(REPO, "assets", "env", "sunny_sky_256x128.hdr"),
             "kloof": os.path.join(REPO, "assets", "env", "kloofendal_overcast_1k.hdr")}

SIZE, FRAMES, GLASS_FRAMES = 128, 64, 256
EXACT_RMSE, GLASS_RMSE = 1e-3, 3e-3
FLIP_DIFF, FLIP_FRACTION = 0.01, 0.05
CONTROL_DIFF, CONTROL_AGREE = 1e-6, 0.995
ORACLE_CHUNK = 4096        # pixels a render_batch_oracle call


@dataclass
class Row:
    """One parity row: its scene loader (device -> LoadedScene), the
    environment ("sky", "sun", "kloof" or None), settings overrides, and
    whether a clip plane is on, the loaded density volume is marched and
    the row is a glass one."""
    name: str
    load: Callable
    env: str | None = None
    overrides: dict = field(default_factory=dict)
    clip: bool = False
    volume: bool = False
    glass: bool = False


def rows() -> list[Row]:
    from ..app.pipeline import load_molecule_scene, load_random_spheres
    from ..models import get_builtin_molecule, parse_auto_detect

    def molecule(name, **kw):
        return lambda device: load_molecule_scene(get_builtin_molecule(name),
                                                  device=device, **kw)

    def protein_cartoon(device):
        with open(PROTEIN, encoding="utf-8") as f:
            mol = parse_auto_detect(f.read(), "TSTP.pdb")
        return load_molecule_scene(mol, display_style="cartoon", device=device)

    metal = dict(material_mode="metallic")
    lit = dict(material_mode="metallic", env_intensity=0.4)
    return [
        Row("caffeine-metallic", molecule("caffeine"),
            overrides=dict(material_mode="metallic", metallic=0.85, roughness=0.35)),
        Row("caffeine-matte", molecule("caffeine"), overrides=dict(material_mode="matte")),
        Row("caffeine-sky-env", molecule("caffeine"), env="sky", overrides=lit),
        Row("caffeine-hdr-sun", molecule("caffeine"), env="sun", overrides=lit),
        Row("caffeine-hdr-1k", molecule("caffeine"), env="kloof", overrides=lit),
        Row("caffeine-dof", molecule("caffeine"),
            overrides=dict(material_mode="metallic", dof_enabled=True, dof_aperture=0.05)),
        Row("caffeine-clip", molecule("caffeine"), overrides=metal, clip=True),
        Row("caffeine-volume", molecule("caffeine", volume_enabled=True),
            overrides=dict(material_mode="metallic", volume_enabled=True,
                           volume_density=1.5), volume=True),
        Row("aspirin-stick", molecule("aspirin", display_style="stick"), overrides=metal),
        Row("tstp-cartoon", protein_cartoon, overrides=dict(material_mode="matte")),
        Row("spheres1000", lambda device: load_random_spheres(1000, device=device),
            overrides=metal),
        # Glass modes draw divergently between the oracle and the renderer,
        # so these compare converged images.
        Row("caffeine-ses-surface-glass",
            molecule("caffeine", show_surface=True, surface_resolution=0.5),
            overrides=dict(material_mode="surface-glass", surface_opacity=0.25,
                           surface_transmission=0.5), glass=True),
        Row("glucose-translucent", molecule("glucose"),
            overrides=dict(material_mode="translucent-plastic", surface_opacity=0.3),
            glass=True),
    ]


def load_env(kind, device):
    """The row's environment as EnvBuffers on `device` (None: none)."""
    from ..env import EnvironmentController

    if kind is None:
        return None
    envc = EnvironmentController(device=device)
    if kind == "sky":
        return envc.load_analytic_sky(width=128, height=64)
    return envc.load_hdr_file(ENV_FILES[kind])


def make_renderer(row: Row, scene, env, size, device, impl=None, volume=None):
    from ..render import Renderer

    r = Renderer(scene, width=size, height=size, env=env, volume=volume, device=device,
                 impl=impl)
    r.settings.tone_map = "linear"
    for k, v in row.overrides.items():
        setattr(r.settings, k, v)
    if row.clip:
        r.settings.clip_enabled = True
        r.settings.clip_distance = 0.15 * r.scene_scale
    return r


def render_port(r, frames) -> np.ndarray:
    """Render `frames` progressive frames with `r`; its accumulation, [N,3]
    in ray order."""
    r.settings.max_frames = frames          # render_frames stops at max_frames
    r.render_frames(frames)
    if r.frame_index != frames:
        raise RuntimeError(f"rendered {r.frame_index} frames, not {frames}")
    return r._accum.cpu().numpy()


def render_oracle(r, frames, trace_device=None, cache=None) -> np.ndarray:
    """The oracle's accumulation of `frames` frames on the Renderer's
    scene, environment, volume, pixels, flags and uniforms, [N,3] in ray order;
    read from or written to the file `cache` when given."""
    from ..render.reference_oracle import render_batch_oracle

    if cache and os.path.isfile(cache):
        return np.load(cache)["acc"]
    flags, u, px, py = r.frame_inputs()
    px, py = px.cpu().numpy(), py.cpu().numpy()
    acc = None
    for f in range(frames):
        co = np.concatenate([
            render_batch_oracle(r.scene, r.env, flags, u, px[i:i + ORACLE_CHUNK],
                                py[i:i + ORACLE_CHUNK], f, trace_device, vol=r.volume)
            for i in range(0, px.shape[0], ORACLE_CHUNK)])
        acc = co if f == 0 else (acc * np.float32(f) + co) / np.float32(f + 1)
    if cache:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez_compressed(cache, acc=acc)
    return acc


def judge(acc_dev: np.ndarray, acc_ora: np.ndarray, glass: bool) -> dict:
    """The gate's numbers for one row. "pass" is final except for a
    stream-exact row that passes only by the exclusion ("needs_control")."""
    diff = acc_dev - acc_ora
    rmse = float(np.sqrt(np.mean(diff ** 2)))
    flip = np.abs(diff).max(axis=-1) > FLIP_DIFF
    flip_fraction = float(flip.mean())
    keep = ~flip
    robust = float(np.sqrt(np.mean(diff[keep] ** 2))) if keep.any() else rmse
    out = {"rmse": rmse, "rmse_excl_decision_flips": robust,
           "decision_flip_fraction": flip_fraction,
           "max_abs_diff": float(np.abs(diff).max()), "stream_exact": not glass}
    if glass:
        out.update(threshold=GLASS_RMSE, needs_control=False, **{"pass": rmse <= GLASS_RMSE})
    else:
        raw = rmse <= EXACT_RMSE
        excl = robust <= EXACT_RMSE and flip_fraction < FLIP_FRACTION
        out.update(threshold=EXACT_RMSE, needs_control=not raw and robust <= EXACT_RMSE,
                   **{"pass": raw or excl})
    return out


def control(acc_dev: np.ndarray, acc_alt: np.ndarray, acc_ora: np.ndarray) -> dict:
    """The device-arithmetic control's line: the plain traversal's image
    against the kernels' and against the oracle."""
    alt = np.abs(acc_dev - acc_alt).max(axis=-1)
    return {"alternative_formulation": "plain PyTorch traversal (impl='plain'), same card",
            "pixel_agreement_at_1e-6": float((alt <= CONTROL_DIFF).mean()),
            "max_abs_formulation_diff": float(alt.max()),
            "alt_rmse_vs_oracle": float(np.sqrt(np.mean((acc_alt - acc_ora) ** 2)))}


def run_row(row: Row, size: int, frames: int, device, trace_device=None,
            cache_dir=None) -> dict:
    """Render one row on `device` and through the oracle (trace_device: a
    CUDA device for the card trace, None for numpy) and judge it under the
    gate, the control included where the gate asks for it."""
    t0 = time.perf_counter()
    loaded = row.load(device)
    env = load_env(row.env, device)
    volume = loaded.volume.to_device_buffers(device) if row.volume else None

    r = make_renderer(row, loaded.scene, env, size, device, volume=volume)
    acc_dev = render_port(r, frames)
    t1 = time.perf_counter()
    cache = (os.path.join(cache_dir, f"{row.name}_{size}x{size}_f{frames}.npz")
             if cache_dir else None)
    cached = bool(cache and os.path.isfile(cache))
    acc_ora = render_oracle(r, frames, trace_device, cache)
    t2 = time.perf_counter()
    out = {"scene": row.name, "material_mode": r.frame_inputs()[0].material_mode,
           "resolution": f"{size}x{size}", "frames": frames,
           **judge(acc_dev, acc_ora, row.glass)}
    if out.pop("needs_control"):
        alt = make_renderer(row, loaded.scene, env, size, device, impl="plain",
                            volume=volume)
        ctl = control(acc_dev, render_port(alt, frames), acc_ora)
        out["device_arithmetic_control"] = ctl
        out["pass"] = (out["rmse_excl_decision_flips"] <= EXACT_RMSE
                       and ctl["pixel_agreement_at_1e-6"] > CONTROL_AGREE)
    out["pass"] = bool(out["pass"])
    out["oracle_trace"] = ("cache" if cached else
                           "numpy" if trace_device is None else "card")
    out["seconds"] = round(time.perf_counter() - t0, 1)
    out["seconds_port"] = round(t1 - t0, 1)
    out["seconds_oracle"] = round(t2 - t1, 1)
    return out


def main(argv=None) -> int:
    from ..device import card_line, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", help="rows whose name contains this substring")
    ap.add_argument("--skip", help="drop rows whose name contains this substring")
    ap.add_argument("--oracle-cache", default=None,
                    help="directory of oracle accumulations keyed by (row, size, "
                         "frames); read when present, written when absent")
    ap.add_argument("--out", default=os.path.join(REPO, "PARITY_RMSE_TORCH.json"))
    args = ap.parse_args(argv)

    device = resolve_device(None)          # the card; raises without one
    card = card_line(device)
    if card is None:
        raise RuntimeError("nvidia-smi gave no name and power limit for the card")
    print(card, flush=True)
    table = rows()
    if args.only:
        table = [r for r in table if args.only in r.name]
    if args.skip:
        table = [r for r in table if args.skip not in r.name]
    if not table:
        raise SystemExit("--only/--skip left no row to measure")

    results = []
    for row in table:
        res = run_row(row, SIZE, GLASS_FRAMES if row.glass else FRAMES, device,
                      device, args.oracle_cache)
        results.append(res)
        print(json.dumps(res), flush=True)

    filtered = bool(args.only or args.skip)
    merged = list(results)
    if filtered and os.path.exists(args.out):
        with open(args.out, encoding="utf-8") as f:
            prior = json.load(f)
        fresh = {r["scene"] for r in results}
        merged = [r for r in prior["results"] if r["scene"] not in fresh] + results
    out = {
        "criterion": "RMSE <= 1e-3 vs the reference-faithful oracle; rows that exceed "
                     "it raw pass only via the device-arithmetic control defined in "
                     "docs/ARCHITECTURE.md §'Parity gate' (the port's control: its "
                     "plain PyTorch traversal on the same card); glass rows RMSE <= "
                     "3e-3 converged, no exclusions",
        "oracle": "webgl_raytracer_tpu_torch/render/reference_oracle.py — NumPy "
                  "transliteration of the reference viewer's webgl.js transport; "
                  "oracle_trace says whether a row's traces ran in numpy or on the card",
        "renderer": "webgl_raytracer_tpu_torch Renderer, CUDA kernels",
        "device": card,
        "filter": {"only": args.only, "skip": args.skip,
                   "merged_into_existing": filtered and len(merged) > len(results)},
        "all_pass": all(r["pass"] for r in merged),
        "results": merged,
    }
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps({"wrote": args.out, "all_pass": out["all_pass"],
                      "rows": len(merged)}), flush=True)
    return 0 if out["all_pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
