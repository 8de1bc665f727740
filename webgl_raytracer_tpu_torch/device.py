"""Where the port's tensors live: the card unless the caller says "cpu"."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or cuda:0 when it is None. Raises when None is given and
    no GPU is present: the port never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "port on the CPU")
    return torch.device("cuda", 0)


def card_line(device=None) -> str | None:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them ("NVIDIA H100 80GB HBM3,
    700.00 W"), for `device` (None: cuda:0). None for a CPU device or
    where nvidia-smi cannot be read."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type != "cuda":
        return None
    try:
        smi = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    return lines[0] if lines else None
