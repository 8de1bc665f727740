"""Live-ray movement for the binned transport (render/integrator.py).

Counterpart of webgl_raytracer_tpu/render/compact.py. After the primary
trace only the hit fraction of a frame's rays (about 5% at 1000 spheres,
8% at 10k) does further work; the binned transport packs those lanes
live-first into a capped buffer, re-packs the buffer by a coherence key
after each bounce, and expands the radiance back to pixel order at the
end. These are the moves it uses:

  compact_cap       the buffer size, n/div rounded as the JAX package rounds
                    it, so the same frames overflow it and fall back;
  live_first_index  live lanes ascending, then the others (stable argsort);
  pack_rows / gather_rows
                    per-lane columns as one [n,16] f32 row matrix (integer
                    columns bit-cast), moved by one row gather;
  bin_key           direction octant x origin Morton cell (the JAX
                    package's default key, oct_cell, on its 8^3 grid);
  expand_cols       compact order -> pixel order, zeros on dead lanes.

The TPU's windowed one-hot matrix expand is a workaround for its slow
per-lane scatter; here expand_cols is one index move with the same output.
"""

from __future__ import annotations

import torch

CHUNK = 65536        # the JAX package's scan chunk: it rounds the cap
CELLS_LOG2 = 3       # bin_key's grid: 2^3 cells per axis
# A key above every key bin_key gives (octant 7, cell 511): dead lanes
# sort after every live one.
DEAD_KEY = 8 << (3 * CELLS_LOG2)


def compact_cap(n: int, div: int = 8) -> int:
    """The buffer size: n/div rounded up to a multiple of 1024, then to a
    whole number of chunks (the JAX package's compact_cap)."""
    raw = max(1024, -(-(n // div) // 1024) * 1024)
    chunk = min(CHUNK, raw)
    return -(-raw // chunk) * chunk


def live_first_index(live: torch.Tensor, cap: int) -> torch.Tensor:
    """[cap] int64 lane ids: the live lanes in ascending order, then the
    other lanes in ascending order (padding: valid lane ids)."""
    return torch.argsort((~live).to(torch.uint8), stable=True)[:cap]


def _as_f32_bits(c: torch.Tensor) -> torch.Tensor:
    if c.dtype == torch.float32:
        return c
    if c.dtype == torch.int64:    # PCG states: uint32 values in int64
        c = c.to(torch.int32)
    return c.view(torch.float32)


def pack_rows(cols) -> torch.Tensor:
    """Up to 16 [n] columns (f32, or int32 / int64-held uint32 bit-cast to
    f32) -> one [n,16] f32 row matrix, zero-padded."""
    if len(cols) > 16:
        raise ValueError(f"pack_rows takes at most 16 columns, not {len(cols)}")
    f32 = [_as_f32_bits(c) for c in cols]
    f32 += [torch.zeros_like(f32[0])] * (16 - len(f32))
    return torch.stack(f32, dim=1)


def int_col(rows: torch.Tensor, j: int) -> torch.Tensor:
    """Column j of a packed row matrix, read back as the int32 it holds."""
    return rows[:, j].contiguous().view(torch.int32)


def seed_col(rows: torch.Tensor, j: int) -> torch.Tensor:
    """Column j read back as a PCG state (int64 holding a uint32)."""
    return int_col(rows, j).to(torch.int64) & 0xFFFFFFFF


def gather_rows(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[len(idx),16] <- packed[idx]: the bounce-0 pack (idx from
    live_first_index) and the re-packs (any permutation); the JAX
    package's gather_rows and gather_rows_perm."""
    return packed[idx]


def _morton3(cx, cy, cz, bits: int):
    """Interleave the `bits` low bits of three int grids into a Morton
    code, x highest within each bit triple."""
    code = torch.zeros_like(cx)
    for b in range(bits):
        code = (code
                | (((cx >> b) & 1) << (3 * b + 2))
                | (((cy >> b) & 1) << (3 * b + 1))
                | (((cz >> b) & 1) << (3 * b)))
    return code


def bin_key(o3, d3, lo, inv_extent):
    """int32 coherence key of each ray: its direction octant, then its
    origin's Morton-ordered cell on a 2^CELLS_LOG2 grid per axis over the
    scene box (lo, 1/extent). Below DEAD_KEY."""
    g = 1 << CELLS_LOG2

    def cell(a):
        return torch.clamp(((o3[a] - lo[a]) * inv_extent[a] * g).to(torch.int32), 0, g - 1)

    code = _morton3(cell(0), cell(1), cell(2), CELLS_LOG2)
    octant = ((d3[0] < 0.0).to(torch.int32) * 4
              + (d3[1] < 0.0).to(torch.int32) * 2
              + (d3[2] < 0.0).to(torch.int32))
    return octant * (g * g * g) + code


def expand_cols(cols, live: torch.Tensor):
    """1..4 [cap] columns in compact (live-first, order-preserving) order
    -> [n] columns in lane order: the k-th live lane reads compact row k,
    dead lanes read 0. Live lanes past the cap (a frame that overflowed
    the buffer, whose result is discarded) read the last row, so that no
    read leaves the buffer."""
    last = cols[0].shape[0] - 1
    pos = torch.clamp(torch.cumsum(live.to(torch.int64), 0) - 1, 0, last)
    return tuple(torch.where(live, c[pos], 0.0) for c in cols)
