"""The sphere kind through the scene-kind interface gives what the
sphere-only harness gave, bit for bit: for spheres1000 (sky and ambient)
and spheres150k (ambient) at 64x36, one seed, the first three views of the
orbit, the scene's bounds, the check's chosen pixels and primary hit share
(256 of 4096 candidates) and the reference's means and noise after 1 and
2 frames. pinned_spheres.json holds those values as the sphere-only
harness computed them, the arrays as SHA-256 of their bytes."""

import hashlib
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import cells as CELLS
from benchmark.harness import check as CHECK
from benchmark.harness import main as MAIN
from benchmark.harness import traffic as TRAFFIC

PINNED = CELLS.load_json(Path(__file__).with_name("pinned_spheres.json"))
SPEC = CELLS.load_spec()


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED["cells"]))
def test_sphere_kind_gives_the_pinned_values(name):
    want = PINNED["cells"][name]
    seed, w, h = PINNED["seed"], PINNED["width"], PINNED["height"]
    cell = CELLS.load_cell(name, SPEC)
    cfg = cell.config
    geo = cell.kind.generate(cfg, seed)
    lo, hi = cell.kind.bounds(geo)
    assert lo.dtype == hi.dtype == np.float32
    assert [lo.tolist(), hi.tolist()] == want["bounds"]
    orbit = TRAFFIC.views(cell.traffic, float(cfg["fov"]), lo, hi, seed)
    views = [next(orbit) for _ in range(3)]
    for got, pinned in zip(views, want["views"]):
        assert np.asarray(got["target"], np.float64).tolist() == pinned["target"]
        assert np.asarray(got["rotation"], np.float64).tolist() == pinned["rotation"]
        assert float(got["distance"]) == pinned["distance"]
        assert float(got["fov"]) == pinned["fov"]
    ref = MAIN.reference_scene(cell, geo, "cpu")
    assert [ref.lo.tolist(), ref.hi.tolist()] == want["bounds"]
    rows, cols, share = CHECK.choose_pixels(ref, MAIN._view(cell, ref, views[0], w, h), w, h,
                                            seed, PINNED["pixels"], PINNED["candidates"])
    assert np.asarray(rows, np.int64).tolist() == want["rows"]
    assert np.asarray(cols, np.int64).tolist() == want["cols"]
    assert share == want["hit_share"]
    means = MAIN.reference_means(cell, ref, views[0], w, h, rows, cols, [1, 2])
    for k, e in zip((1, 2), means):
        pinned = want["means"][str(k)]
        assert float(e.mean.astype(np.float64).sum()) == pinned["mean_sum"], k
        assert float(e.noise.astype(np.float64).sum()) == pinned["noise_sum"], k
        assert _digest(e.mean.astype(np.float32)) == pinned["mean_sha256"], k
        assert _digest(e.noise.astype(np.float64)) == pinned["noise_sha256"], k
