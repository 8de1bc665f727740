"""A cell, a configuration, a traffic mix, a scene kind and a per-layer
metric are found by name from files alone; a scene kind added as files
alone is built by set_up, hands its volume to the Renderer and is checked
through its own reference scene; the repository's own BENCHMARK.json names
files that exist."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cells as CELLS
from benchmark.harness import main as MAIN

KIND_FUNCTIONS = ("generate", "program_scene", "bounds", "reference_scene")

# A toy scene kind: the TSTP cartoon (no SES) with its nitrogen density
# volume, built through the program's molecule loader; its reference scene
# answers every query with a constant and logs each call.
TOY_KIND = '''
import numpy as np
import torch

CALLS = []
VOLUMES = []


def generate(config, seed):
    CALLS.append("generate")
    from webgl_raytracer_tpu_torch.models import parse_auto_detect
    with open(config["pdb"], encoding="utf-8") as f:
        return parse_auto_detect(f.read(), "TSTP.pdb")


def program_scene(geo, config, device):
    CALLS.append("program_scene")
    from webgl_raytracer_tpu_torch.app.pipeline import load_molecule_scene
    loaded = load_molecule_scene(geo, display_style="cartoon", volume_enabled=True,
                                 volume_options={"spacing": 1.0}, device=device)
    VOLUMES.append(loaded.volume.to_device_buffers(device))
    return loaded.scene, VOLUMES[-1]


def bounds(geo):
    CALLS.append("bounds")
    p = np.asarray(geo.positions, np.float32)
    return p.min(axis=0) - 2.0, p.max(axis=0) + 2.0


class Reference:
    def __init__(self, lo, hi, device, dtype):
        self.lo, self.hi, self.device, self.dtype = lo, hi, device, dtype

    def closest(self, o, d, tmin):
        CALLS.append("closest")
        return (d[2] > 0).long() - 1

    def trace_frames(self, settings, view, width, height, px, py, frames):
        CALLS.append("trace_frames")
        return torch.full((px.shape[0], 3), 0.5, dtype=self.dtype, device=self.device)

    def accumulate(self, colors):
        CALLS.append("accumulate")
        return colors.mean(dim=0)


def reference_scene(geo, config, sky, device, dtype):
    CALLS.append(("reference_scene", sky, device, dtype))
    return Reference(*bounds(geo), device, dtype)
'''


def _write(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(data if isinstance(data, str) else json.dumps(data))


@pytest.fixture
def toy(tmp_path):
    spec = {"workloads": [{"name": "toy.mix", "config": "toy", "traffic": "mix", "chips": 1,
                           "why": "a toy"}],
            "end_to_end": [{"name": "frame_ms", "unit": "ms"}],
            "per_layer": [{"name": "toy_metric", "unit": "x"}]}
    _write(tmp_path / "BENCHMARK.json", spec)
    bench = tmp_path / "benchmark"
    _write(bench / "workloads" / "toy.mix.json",
           {"config": "toy", "traffic": "mix", "chips": 1,
            "program_env": {"KNOB": 3}, "limits": {"rel_rmse": 0.5}})
    _write(bench / "configs" / "toy.json", {"generator": "toygen", "spheres": 7})
    _write(bench / "traffic" / "mix.json", {"frames_per_view": 4})
    _write(bench / "metrics" / "toy_metric.py", "def read(ctx):\n    return ctx * 2\n")
    _write(bench / "generators" / "toygen.py",
           "def generate(config, seed):\n    return config['spheres'] + seed\n")
    return tmp_path, bench


@pytest.fixture
def toy_molecule(tmp_path):
    """The toy kind's cell at 32x16 on the CPU, from files alone."""
    spec = {"workloads": [{"name": "toymol.mix", "config": "toymol", "traffic": "mix",
                           "chips": 1, "why": "a toy kind with a volume"}],
            "end_to_end": [{"name": "frame_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
            "per_layer": []}
    bench = tmp_path / "benchmark"
    settings = dict(CELLS.load_json(CELLS.BENCH_DIR / "configs" / "spheres1000.json")["settings"],
                    volume_enabled=True)
    _write(bench / "workloads" / "toymol.mix.json",
           {"config": "toymol", "traffic": "mix", "chips": 1, "limits": {"px_off_pct": 100.0}})
    _write(bench / "configs" / "toymol.json",
           {"generator": "toymol", "pdb": str(CELLS.ROOT / "assets" / "proteins" / "TSTP.pdb"),
            "width": 32, "height": 16, "fov": 1.0471975511965976, "settings": settings})
    _write(bench / "traffic" / "mix.json",
           {"frames_per_view": 2, "views_per_round": 4, "pole_limit_y": 0.995,
            "profile_frames": 1, "check_pixels": 16, "check_candidates": 64, "sky": None})
    _write(bench / "generators" / "toymol.py", TOY_KIND)
    return spec, CELLS.load_cell("toymol.mix", spec, bench)


def test_files_added_alone_are_found(toy):
    root, bench = toy
    spec = CELLS.load_spec(root)
    cell = CELLS.load_cell("toy.mix", spec, bench)
    assert cell.config["spheres"] == 7
    assert cell.traffic["frames_per_view"] == 4
    assert cell.program_env == {"KNOB": "3"}
    assert cell.limits == {"rel_rmse": 0.5}
    assert CELLS.load_reader(spec["per_layer"][0]["name"], bench)(21) == 42
    assert cell.kind.generate(cell.config, 5) == 12
    assert CELLS.load_kind("toygen", bench).generate(cell.config, 5) == 12


def test_set_up_builds_a_kind_added_as_files_with_its_volume(toy_molecule):
    _, cell = toy_molecule
    prog = MAIN.set_up(cell, 2**31 + 17, "cpu")
    assert cell.kind.CALLS == ["generate", "program_scene", "bounds"]
    assert prog.renderer.volume is cell.kind.VOLUMES[0]
    assert prog.renderer.settings.volume_enabled is True
    assert (prog.renderer.width, prog.renderer.height) == (32, 16)
    assert prog.renderer.stats["captures"] == 0          # the CPU renders its frames eagerly
    assert prog.renderer.render_frame()
    image = prog.renderer.accumulated().copy()
    assert image.shape == (16, 32, 3) and float(image.max()) > 0.0
    prog.renderer.settings.volume_enabled = False       # the frame marches the volume
    prog.renderer.reset_accumulation()
    assert prog.renderer.render_frame()
    assert not np.array_equal(prog.renderer.accumulated(), image)


def test_the_check_reaches_the_kinds_reference_scene(toy_molecule):
    spec, cell = toy_molecule
    result = MAIN.run_cell(cell, spec, 2**31 + 19, 1e9, False, "cpu", time.perf_counter(),
                           max_frames=2)
    calls = cell.kind.CALLS
    assert calls[:3] == ["generate", "program_scene", "bounds"]
    assert ("reference_scene", None, "cpu", torch.float32) in calls
    for name in ("closest", "trace_frames", "accumulate"):
        assert name in calls, name
    assert result["window"]["check_frames"] == 2
    assert set(result["check"]) == {"err_over_noise", "mean_bias_pct", "rel_rmse", "px_off_pct"}
    assert result["check"]["px_off_pct"]["limit"] == 100.0
    assert result["correct"] is True
    assert set(result["metrics"]) == {"frame_ms", "setup_s"}


def test_cell_file_must_agree_with_benchmark_json(toy):
    root, bench = toy
    spec = CELLS.load_spec(root)
    spec["workloads"][0]["traffic"] = "other"
    with pytest.raises(ValueError):
        CELLS.load_cell("toy.mix", spec, bench)
    with pytest.raises(KeyError):
        CELLS.load_cell("missing", spec, bench)


def test_repository_benchmark_names_existing_files():
    spec = CELLS.load_spec()
    for w in spec["workloads"]:
        cell = CELLS.load_cell(w["name"], spec)
        assert set(cell.limits) <= {"err_over_noise", "mean_bias_pct", "rel_rmse", "px_off_pct"}
        assert all(isinstance(v, (int, float)) for v in cell.limits.values()), w["name"]
        for fn in KIND_FUNCTIONS:
            assert callable(getattr(cell.kind, fn)), (cell.config["generator"], fn)
        assert cell.traffic["frames_per_view"] <= cell.config["settings"]["max_frames"]
    for m in spec["per_layer"]:
        assert callable(CELLS.load_reader(m["name"]))
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names
    for c in spec["configs"]:
        assert (CELLS.ROOT / c["file"]).is_file()
