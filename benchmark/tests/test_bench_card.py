"""Each cell's run on the card, with a short window: it ends with the
check's numbers within the cell's limits. Needs a CUDA device and nvcc;
on the card: python -m pytest benchmark/tests -m cuda."""

import time

import pytest
import torch

from benchmark.harness import cells as CELLS
from benchmark.harness import main as MAIN

SPEC = CELLS.load_spec()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_on_the_card_is_correct(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = CELLS.load_cell(name, SPEC)
    for key, value in cell.program_env.items():
        monkeypatch.setenv(key, value)
    result = MAIN.run_cell(cell, SPEC, 2**31 + 9, 2.0, False, "cuda", time.perf_counter())
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert result["correct"] is True, result["check"]
