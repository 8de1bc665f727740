"""A run drives the program with its timed path broken underneath, and the
check must say `correct` is false; the same run unbroken says true. On the
CPU at a small size, past the look for a chip (run_cell, not main).

Faults planted in the program's frame loop (render/frame.py):
  unchanged     a frame returns the accumulator as it was: after the first
                frame of a view the running mean is never updated
  half_batch    half of the batch left out: only the first half of the
                rays' running mean is updated, the image is the rest's
  altered       every frame's answer altered where it is produced: the
                red channel of the frame's colour 5% high
The exchange between chips is not a fault these cells can have: every cell
runs on one chip.
"""

import time

import pytest

import webgl_raytracer_tpu_torch.render.frame as FRAME
from benchmark.harness import cells as CELLS
from benchmark.harness import main as MAIN

SPEC = CELLS.load_spec()
# The 150k scenes' frames take seconds on the CPU, so they run smaller.
SIZES = {"spheres1000": (64, 64), "spheres150k": (16, 16)}
# Frames a run renders: enough, where the accumulator is left unchanged,
# that the image at its first frame lies well outside the reference's
# noise (about sqrt(frames) standard errors).
FRAMES = {"unchanged": 40}


def _unchanged(monkeypatch):
    real = FRAME.running_mean

    def stuck(accum, color, frame_index):
        if int(frame_index) == 0:
            real(accum, color, frame_index)
    monkeypatch.setattr(FRAME, "running_mean", stuck)


def _half_batch(monkeypatch):
    real = FRAME.running_mean

    def half(accum, color, frame_index):
        n = accum.shape[0] // 2
        real(accum[:n], color[:n], frame_index)
    monkeypatch.setattr(FRAME, "running_mean", half)


def _altered(monkeypatch):
    real = FRAME.render_batch_flagged

    def wrong(*args, **kwargs):
        color, rays, overflow = real(*args, **kwargs)
        color = color.clone()
        color[:, 0] *= 1.05
        return color, rays, overflow
    monkeypatch.setattr(FRAME, "render_batch_flagged", wrong)


FAULTS = {"none": None, "unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_a_broken_frame_is_not_correct(name, fault, monkeypatch):
    cell = CELLS.load_cell(name, SPEC)
    for key, value in cell.program_env.items():
        monkeypatch.setenv(key, value)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    frames = FRAMES.get(fault, 3)
    result = MAIN.run_cell(cell, SPEC, 2**31 + 5, 1e9, False, "cpu", time.perf_counter(),
                           size=SIZES[cell.config["name"]], max_frames=frames)
    assert result["window"]["frames_in_last_view"] == frames
    assert result["window"]["check_frames"] == frames
    assert result["correct"] is (fault == "none"), result["check"]
