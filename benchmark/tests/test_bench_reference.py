"""The plain reference against the program's CPU twin, and the reference's
own parts: the sphere kind's reference scene and its grid against testing
every sphere, the sky tables."""

import math
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cells as CELLS
from benchmark.harness import main as MAIN
from benchmark.reference import grid as G
from benchmark.reference import sky as S

SPEC = CELLS.load_spec()


@pytest.mark.parametrize("name", ["spheres1000.ambient", "spheres1000.sky"])
def test_reference_matches_the_programs_cpu_twin(name):
    """A 64x64 view of the 1000 spheres, 2 frames: the whole run on the
    CPU, the check against the reference included."""
    cell = CELLS.load_cell(name, SPEC)
    MAIN.set_program_env(cell)
    result = MAIN.run_cell(cell, SPEC, 2**31 + 11, 1e9, False, "cpu", time.perf_counter(),
                           size=(64, 64), max_frames=2)
    assert result["window"]["frames_in_last_view"] == 2
    assert result["window"]["check_frames"] == 2
    assert result["check"]["rel_rmse"]["value"] < 1e-4
    assert result["correct"] is True


def test_grid_finds_what_testing_every_sphere_finds():
    cfg = CELLS.load_json(CELLS.BENCH_DIR / "configs" / "spheres1000.json")
    kind = CELLS.load_kind(cfg["generator"])
    geo = kind.generate(cfg, 3)
    scene = kind.reference_scene(geo, cfg, None, "cpu", torch.float32)
    grid = scene.grid
    rng = np.random.default_rng(0)
    n = 2000
    pick = rng.integers(0, 1000, n)
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    origin = geo["centers"][pick] + normal * (geo["radii"][pick, None] + 1e-3)
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    direction = np.where((direction * normal).sum(1, keepdims=True) < 0, -direction, direction)
    o = tuple(torch.tensor(origin[:, i], dtype=torch.float32) for i in range(3))
    d = tuple(torch.tensor(direction[:, i], dtype=torch.float32) for i in range(3))
    tmin = torch.full((n,), 1e-3)
    idx = scene.closest(o, d, tmin)
    _, want = grid.brute_closest(o, d, tmin)
    assert (idx >= 0).sum() > n // 10
    assert torch.equal(idx, want)
    assert torch.equal(grid.closest(o, d, tmin)[1], want)
    hit = grid.any_hit(o, d, tmin, tmin, torch.full((n,), G.BIG))
    assert torch.equal(hit, want >= 0)


def test_sky_tables_and_sampling_agree():
    cfg = CELLS.load_json(CELLS.BENCH_DIR / "traffic" / "sky.json")["sky"]
    sky = dict(cfg, width=64, height=32)
    env = S.Env(S.sky_image(sky, "cpu"))
    assert env.marginal[-1] == 1.0 and bool((env.marginal[1:] >= env.marginal[:-1]).all())
    assert bool((env.cond[:, -1] == 1.0).all())
    gen = torch.Generator().manual_seed(0)
    r1, r2 = torch.rand(4000, generator=gen), torch.rand(4000, generator=gen)
    d, pdf = S.sample_direction(env, r1, r2)
    norm = torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-5)
    assert bool((pdf > 0).all())
    # Integrated over the sphere, the pdf is 1 (uniform directions).
    u = torch.rand(20000, generator=gen) * 2 - 1
    phi = torch.rand(20000, generator=gen) * 2 * math.pi
    s = torch.sqrt(1 - u * u)
    mean = float(S.pdf(env, (s * torch.cos(phi), u, s * torch.sin(phi))).mean())
    assert abs(mean * 4 * math.pi - 1.0) < 0.05
