"""A cell, a configuration, a traffic mix, a generator and a per-layer
metric are found by name from files alone; the repository's own
BENCHMARK.json names files that exist."""

import json

import pytest

from benchmark.harness import cells as CELLS


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


def test_files_added_alone_are_found(toy):
    root, bench = toy
    spec = CELLS.load_spec(root)
    cell = CELLS.load_cell("toy.mix", spec, bench)
    assert cell.config["spheres"] == 7
    assert cell.traffic["frames_per_view"] == 4
    assert cell.program_env == {"KNOB": "3"}
    assert cell.limits == {"rel_rmse": 0.5}
    assert CELLS.load_reader(spec["per_layer"][0]["name"], bench)(21) == 42
    assert CELLS.load_generator("toygen", bench)(cell.config, 5) == 12


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
        CELLS.load_generator(cell.config["generator"])
        assert cell.traffic["frames_per_view"] <= cell.config["settings"]["max_frames"]
    for m in spec["per_layer"]:
        assert callable(CELLS.load_reader(m["name"]))
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names
    for c in spec["configs"]:
        assert (CELLS.ROOT / c["file"]).is_file()
