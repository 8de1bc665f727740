"""Where the port's tensors live: the card unless the caller says "cpu"."""

from __future__ import annotations

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
