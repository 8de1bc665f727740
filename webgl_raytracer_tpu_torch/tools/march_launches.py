"""How many launches does the volume march take as PyTorch tensor code?

    python -m webgl_raytracer_tpu_torch.tools.march_launches [--device cpu]

Renders frame 0 of the parity tool's caffeine-volume row (128x128,
metallic, volume density 1.5, 256 march steps, 4 bounces) and records the
batches the frame marches. Then, under torch.profiler, it replays those
marches through the plain version (ops/volume.march_plain) and, on the
card, through the kernel (csrc/volume_march.cu, its operand staging
included), and profiles the whole frame with the plain march. On the card
it counts CUDA kernel launches; on the CPU (--device cpu) it counts the
aten operations that call no other operation, each of which would be a
launch on the card. Prints one JSON line, with the card's name and power
limit where there is one.
"""

from __future__ import annotations

import argparse
import json

import torch


def _count(prof, device) -> int:
    events = prof.events()
    if device.type == "cuda":
        return sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    return sum(1 for e in events if e.name.startswith("aten::") and not any(
        c.name.startswith("aten::") for c in e.cpu_children))


def _profiled(fn, device) -> int:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    return _count(prof, device)


def measure(device) -> dict:
    from ..device import card_line
    from ..render import integrator as I
    from ..render.integrator import render_batch
    from . import parity_rmse as P

    row = next(r for r in P.rows() if r.name == "caffeine-volume")
    loaded = row.load(device)
    vol = loaded.volume.to_device_buffers(device)
    r = P.make_renderer(row, loaded.scene, None, P.SIZE, device, volume=vol)
    flags, u, px, py = r.frame_inputs()

    calls = []
    real = I.march_volume

    def spy(*args, impl=None):
        calls.append(args)
        return real(*args, impl=impl)

    I.march_volume = spy
    try:
        render_batch(r.scene, flags, u, px, py, 0, vol=vol, impl="plain")
    finally:
        I.march_volume = real

    def marches(impl):
        def run():
            for args in calls:
                real(*args, impl=impl)
        return run

    out = {"scene": "parity row caffeine-volume, frame 0",
           "size": f"{P.SIZE}x{P.SIZE}", "device": str(device),
           "counted": "CUDA kernel launches" if device.type == "cuda"
           else "leaf aten operations",
           "march_calls": len(calls), "max_steps": flags.volume_max_steps,
           "bounces": flags.max_bounces,
           "plain_march": _profiled(marches("plain"), device),
           "frame_with_plain_march": _profiled(
               lambda: render_batch(r.scene, flags, u, px, py, 0, vol=vol, impl="plain"),
               device)}
    out["plain_march_per_call"] = out["plain_march"] / max(1, len(calls))
    out["plain_march_per_step"] = out["plain_march_per_call"] / max(1, flags.volume_max_steps)
    if device.type == "cuda":
        out["kernel_march"] = _profiled(marches(None), device)
        out["card"] = card_line(device)
    return out


def main(argv=None) -> int:
    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    print(json.dumps(measure(resolve_device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
