"""The port's live-ray moves (webgl_raytracer_tpu_torch.render.compact)
against the JAX package's render/compact.py on the same seeded numpy
inputs. Every move is integer or bit-exact data movement, so each must
match exactly (f32 columns as bit patterns)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgl_raytracer_tpu.render import compact as JC
from webgl_raytracer_tpu_torch.render import compact as PC

N = 4096


def _live(seed, frac):
    return np.random.default_rng(seed).random(N) < frac


@pytest.mark.parametrize("n,div", [(4096, 12), (4096, 8), (1920 * 1080, 12),
                                   (1920 * 1080, 4096), (256 * 256, 2), (640 * 480, 16)])
def test_compact_cap_matches_jax(n, div):
    assert PC.compact_cap(n, div) == JC.compact_cap(n, div)[0]


@pytest.mark.parametrize("frac", [0.0, 0.11, 0.5, 1.0])
def test_live_first_index_matches_jax(frac):
    live = _live(1, frac)
    cap = PC.compact_cap(N, 8) if frac < 0.2 else N
    want = np.asarray(JC.live_first_index(jnp.asarray(live), cap))
    got = PC.live_first_index(torch.as_tensor(live), cap).numpy()
    assert np.array_equal(got, want)


def test_pack_and_gather_rows_match_jax():
    rng = np.random.default_rng(2)
    f = [rng.normal(size=N).astype(np.float32) for _ in range(7)]
    slot = rng.integers(-1, 1 << 20, N).astype(np.int32)
    seed = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    jpacked = JC.pack_rows([jnp.asarray(seed)] + [jnp.asarray(x) for x in f]
                           + [jnp.asarray(slot)])
    ppacked = PC.pack_rows([torch.as_tensor(seed.astype(np.int64))]
                           + [torch.as_tensor(x) for x in f] + [torch.as_tensor(slot)])
    assert np.array_equal(np.asarray(jpacked).view(np.uint32),
                          ppacked.numpy().view(np.uint32))
    live = _live(3, 0.2)
    cap = PC.compact_cap(N, 4)
    idx = np.array(JC.live_first_index(jnp.asarray(live), cap))
    jrows = np.asarray(JC.gather_rows(jpacked, jnp.asarray(idx)))
    prows = PC.gather_rows(ppacked, torch.as_tensor(idx).long())
    assert np.array_equal(jrows.view(np.uint32), prows.numpy().view(np.uint32))
    assert np.array_equal(PC.seed_col(prows, 0).numpy(), seed[idx].astype(np.int64))
    assert np.array_equal(PC.int_col(prows, 8).numpy(), slot[idx])
    perm = rng.permutation(N)
    jperm = np.asarray(JC.gather_rows_perm(jpacked, jnp.asarray(perm)))
    pperm = PC.gather_rows(ppacked, torch.as_tensor(perm))
    assert np.array_equal(jperm.view(np.uint32), pperm.numpy().view(np.uint32))


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = (rng.random((3, N)) * 12 - 4).astype(np.float32)
    d = rng.normal(size=(3, N)).astype(np.float32)
    return o, d


# Scene boxes (lo, extent): one holding every origin, one holding part of
# them (the cells clamp at the grid's faces), one flat box.
BOXES = {"holds": ([-4.5, -4.0, -4.2], [17.0, 16.5, 16.8]),
         "part": ([-3.0, -2.5, -3.5], [10.0, 9.0, 11.0]),
         "flat": ([-4.0, 0.0, -4.0], [12.0, 1e-6, 12.0])}


def _bin_keys(o, d, lo, extent):
    lo = np.array(lo, np.float32)
    inv = (1.0 / np.array(extent, np.float64)).astype(np.float32)
    want = np.asarray(JC.bin_key(tuple(jnp.asarray(c) for c in o),
                                 tuple(jnp.asarray(c) for c in d),
                                 jnp.asarray(lo), jnp.asarray(inv), PC.CELLS_LOG2,
                                 "oct_cell"))
    got = PC.bin_key(tuple(torch.as_tensor(c) for c in o),
                     tuple(torch.as_tensor(c) for c in d),
                     torch.as_tensor(lo), torch.as_tensor(inv))
    return got, want


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("seed", [4, 9, 14])
def test_bin_key_matches_jax(seed, box):
    """The port's key is the JAX package's default (oct_cell, 3 bits)."""
    o, d = _rays(seed)
    got, want = _bin_keys(o, d, *BOXES[box])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got.max()) < PC.DEAD_KEY


def test_morton3_matches_jax():
    rng = np.random.default_rng(5)
    c = [rng.integers(0, 16, N).astype(np.int32) for _ in range(3)]
    want = np.asarray(JC._morton3(*(jnp.asarray(x) for x in c), 4))
    assert np.array_equal(PC._morton3(*(torch.as_tensor(x) for x in c), 4).numpy(), want)


def test_bin_key_grid_limits():
    """Origins in every cell with directions in every octant reach every
    key 0..DEAD_KEY-1: the dead-lane key sorts right after the largest."""
    g = 1 << PC.CELLS_LOG2
    cells = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"), 0).reshape(3, -1)
    o = np.repeat((cells + 0.5).astype(np.float32), 8, axis=1)
    signs = np.array([[(k >> s) & 1 for k in range(8)] for s in (2, 1, 0)])
    d = np.tile(np.where(signs == 1, -1.0, 1.0).astype(np.float32), g ** 3)
    got, want = _bin_keys(o, d, [0.0, 0.0, 0.0], [float(g)] * 3)
    assert np.array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(PC.DEAD_KEY))


@pytest.mark.parametrize("ncols", [1, 3, 4])
@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_expand_cols_matches_jax(ncols, frac):
    live = _live(7, frac)
    cap = PC.compact_cap(N, 2)
    rng = np.random.default_rng(8)
    cols = [rng.normal(size=cap).astype(np.float32) for _ in range(ncols)]
    with jax.disable_jit():
        want = JC.expand_cols(tuple(jnp.asarray(c) for c in cols), jnp.asarray(live))
    got = PC.expand_cols(tuple(torch.as_tensor(c) for c in cols), torch.as_tensor(live))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).view(np.uint32), g.numpy().view(np.uint32))
