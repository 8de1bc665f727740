"""Speed-of-light probe: how fast does the card run the trace sweep's
operation mix?

    python -m webgl_raytracer_tpu_torch.tools.sweep_sol [ITERS]

Counterpart of tools/vpu_sol.py. The kernel (csrc/sweep_sol.cu) runs
`iters` sphere-test sweeps over a [1024, 128] block, each sweep the ~24
arithmetic, compare and select operations of the traces' sphere test
(one sqrt included) per element, keeping a running minimum, in f32 and in
bf16. A thread holds its column's centres in registers and two rows,
sharing the column's work of a sweep between them, and four threads split
those elements' sweeps; a miss keeps the f32 sqrt off its slow path; bf16
runs packed, two columns a thread in __nv_bfloat162 operations. The tool
prints, for each type, the milliseconds of one launch (CUDA events, best
of REPS after a warm launch), nanoseconds per sweep and the effective
rate, 24 x 1024 x 128 operations per sweep, beside the card's name and
power limit. ITERS defaults to 32768.

sweep_sol is the kernel's wrapper, sweep_plain its plain PyTorch version
(the same loop as tensor operations, rounding each operation in the
compute type); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import card_line
from ..ops import vec3 as V
from ..ops.kernels import launches  # noqa: F401 (the count launch() keeps)

B, C = 1024, 128
OPS_PER_ELEMENT = 24       # per sweep; sqrt counted as one operation
DEFAULT_ITERS = 32768
REPS = 5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def probe_inputs(device, seed: int = 0):
    """(a f32[1024,16], s f32[24,128]) drawn as tools/vpu_sol.py draws them."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.normal(size=(B, 16)).astype(np.float32), device=device)
    s = torch.as_tensor(rng.normal(size=(24, C)).astype(np.float32), device=device)
    return a, s


def sweep_plain(a, s, iters: int, dtype=torch.float32):
    """The sweeps as tensor operations in `dtype`: f32[rows], each row's
    minimum hit t over its columns and the sweeps (1e20 where none)."""
    cols = [a[:, i:i + 1].to(dtype) for i in range(7)]
    dx, dy, dz, ox, oy, oz, tmin = cols
    sc = s.to(dtype)
    bt = torch.full((a.shape[0], s.shape[1]), 1e20, dtype=dtype, device=a.device)
    milli = torch.tensor(1e-3, dtype=dtype, device=a.device)
    kfs = torch.arange(iters, dtype=torch.float32, device=a.device).to(dtype) * milli
    zero = torch.zeros((), dtype=dtype, device=a.device)
    minus_one = torch.full((), -1.0, dtype=dtype, device=a.device)
    for k in range(iters):
        kf = kfs[k]
        r = 3 * (k % 8)
        cx = sc[r:r + 1] + kf
        cy = sc[r + 1:r + 2] + kf
        cz = sc[r + 2:r + 3] + kf
        sx = ox - cx
        sy = oy - cy
        sz = oz - cz
        b = sx * dx + sy * dy + sz * dz
        cterm = sx * sx + sy * sy + sz * sz - cx * cx
        disc = b * b - cterm
        sq = V.sqrt(disc)
        t0 = -b - sq
        ts = torch.where(t0 > tmin, t0, -b + sq)
        ts = torch.where(ts > tmin, ts, minus_one)
        upd = (ts > zero) & (ts < bt)
        bt = torch.where(upd, ts, bt)
    return bt.min(dim=1).values.to(torch.float32)


def sweep_sol(a, s, iters: int, dtype=torch.float32, impl=None):
    """The probe: f32[rows] as sweep_plain computes it. A CUDA tensor
    launches csrc/sweep_sol.cu (impl="plain" forces the plain version);
    a CPU tensor takes the plain version."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', not {impl!r}")
    if dtype not in DTYPES.values():
        raise ValueError(f"the probe runs in float32 or bfloat16, not {dtype}")
    if impl == "plain" or a.device.type == "cpu":
        return sweep_plain(a, s, iters, dtype)
    from ..ops.kernels import check_operand, launch

    if a.shape[1] != 16 or tuple(s.shape) != (24, C):
        raise ValueError(f"the probe takes a [rows,16] and s [24,{C}], not "
                         f"{tuple(a.shape)} and {tuple(s.shape)}")
    for x in (a, s):
        check_operand(x, torch.float32, a.device)
    out = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    err = launch("wrt_sweep_sol", a.device, a.data_ptr(), s.data_ptr(), a.shape[0], iters,
                 int(dtype == torch.bfloat16), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"sweep_sol failed: CUDA error {err}")
    return out


def probe_ops(iters: int, rows: int = B) -> float:
    """Operations the probe counts for one launch."""
    return float(OPS_PER_ELEMENT) * rows * C * iters


def run(iters: int, dtype, device=None, reps: int = REPS):
    """Time one launch of the kernel at `iters` sweeps on the card (CUDA
    events, best of `reps` after a warm launch). Returns (the timing
    record, the last launch's f32[rows] output)."""
    device = torch.device(device or "cuda")
    if device.type != "cuda":
        raise RuntimeError("the probe measures the card: it needs a CUDA device")
    a, s = probe_inputs(device)
    sweep_sol(a, s, iters, dtype)
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sweep_sol(a, s, iters, dtype)
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end))
    per_sweep_ns = best * 1e6 / iters
    return {"dtype": str(dtype).replace("torch.", ""), "iters": iters, "ms": best,
            "ns_per_sweep": per_sweep_ns,
            "tops_effective": probe_ops(1) / (per_sweep_ns * 1e-9) / 1e12}, out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if argv else DEFAULT_ITERS
    if not torch.cuda.is_available():
        raise SystemExit("sweep_sol measures the card: no CUDA device is available")
    card = card_line()
    print(card, flush=True)
    results = {name: run(iters, dt)[0] for name, dt in DTYPES.items()}
    for r in results.values():
        print(json.dumps(dict(r, card=card)), flush=True)
    print(json.dumps({"bf16_speedup_over_f32":
                      results["float32"]["ms"] / results["bfloat16"]["ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
