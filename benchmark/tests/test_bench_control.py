"""The control, the kind's reference scene computed in bfloat16 put in the
program's place, is not correct by any cell's limits: each cell at 64x64 on
the CPU, after 1 and 3 frames."""

import pytest
import torch

from benchmark.harness import cells as CELLS
from benchmark.harness import check as CHECK
from benchmark.harness import main as MAIN
from benchmark.harness import traffic as TRAFFIC

SPEC = CELLS.load_spec()


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_the_check(name):
    cell = CELLS.load_cell(name, SPEC)
    cfg, seed, size = cell.config, 2**31 + 3, 64
    geo = cell.kind.generate(cfg, seed)
    lo, hi = cell.kind.bounds(geo)
    view = next(TRAFFIC.views(cell.traffic, cfg["fov"], lo, hi, seed))
    ref = MAIN.reference_scene(cell, geo, "cpu")
    low = MAIN.reference_scene(cell, geo, "cpu", torch.bfloat16)
    rows, cols = MAIN.sample_pixels(cell, ref, view, size, size, seed)
    expected = MAIN.reference_means(cell, ref, view, size, size, rows, cols, [1, 3])
    lowered = MAIN.reference_means(cell, low, view, size, size, rows, cols, [1, 3])
    for want, got in zip(expected, lowered):
        numbers = CHECK.compare(got.mean, want)
        assert not CHECK.verdict(numbers, cell.limits), numbers
