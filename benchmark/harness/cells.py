"""Where the benchmark finds its pieces, by the names in BENCHMARK.json.

  cell            benchmark/workloads/<cell>.json: its configuration and
                  traffic (as BENCHMARK.json names them), chips, the
                  program's environment knobs and the limits of its check
  configuration   benchmark/configs/<config>.json: the scene's sizes, its
                  settings and the name of its generator,
                  benchmark/generators/<generator>.py, the module that
                  defines the scene kind (generate, program_scene, bounds,
                  reference_scene: benchmark/README.md)
  traffic         benchmark/traffic/<traffic>.json: the parameters that the
                  one traffic generator (harness/traffic.py) reads
  metric          benchmark/metrics/<metric>.py: a reader, read(ctx) ->
                  number or None

So a later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    program_env: dict
    limits: dict
    kind: object            # the configuration's generator module


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, spec: dict, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of BENCHMARK.json with its files; raises KeyError
    for a name BENCHMARK.json lacks and ValueError where the cell's file
    disagrees with BENCHMARK.json."""
    entry = {w["name"]: w for w in spec["workloads"]}[name]
    data = load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if data[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key}={data[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = load_json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                program_env={k: str(v) for k, v in data.get("program_env", {}).items()},
                limits=dict(data["limits"]), kind=load_kind(config["generator"], bench_dir))


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """read(ctx) of benchmark/metrics/<metric>.py."""
    return _load_module(bench_dir / "metrics" / f"{metric}.py",
                        f"benchmark_metric_{metric}").read


def load_kind(name: str, bench_dir: Path = BENCH_DIR):
    """The scene kind benchmark/generators/<name>.py: a module with
    generate, program_scene, bounds and reference_scene."""
    return _load_module(bench_dir / "generators" / f"{name}.py",
                        f"benchmark_generator_{name}")
