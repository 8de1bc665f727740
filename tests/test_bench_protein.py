"""The benchmark's molecule scene kind (benchmark/generators/protein.py)
and its plain reference (benchmark/reference/molecule.py, prims.py,
transport.py), on the CPU.

- The generator is deterministic by seed and draws the configuration's
  composition: chains, residues, heavy atoms by element, four HEM groups
  with their Fe; bond inference over its atoms finds exactly its covalent
  bonds (no unbonded pair inside the cutoff), and atoms more than three
  bonds apart keep the 2.6 A floor. The structure has the entry's size:
  its least box within 10% of the entry's extent (64 x 55 x 50 A), and
  inside it about 18 A^3 a heavy atom, a folded protein's packing.
- On a small structure of the same generator (one chain of 21 residues,
  one HEM) the reference's bonds are the port's (its parse's CONECT set
  and its inference), and the reference's SES is the port's compute_ses
  (on the configuration's 0.5 A grid; and on a 1.4 A grid over six
  residues, a surface of one component).
- The kind runs through set_up and the check at 64x36 for a few frames,
  over six residues and a HEM, and reads correct; a program whose glass is made opaque, or refracts
  without its tint, reads correct false.
"""

import json
import time
from collections import Counter

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from benchmark.harness import cells as CELLS
from benchmark.harness import check as CHECK
from benchmark.harness import main as MAIN
from benchmark.reference import molecule as MOL
from webgl_raytracer_tpu_torch.models import infer_bonds, parse_auto_detect
from webgl_raytracer_tpu_torch.models.elements import element_radii_array
from webgl_raytracer_tpu_torch.models.surface import compute_ses

SPEC = CELLS.load_spec()
CELL = CELLS.load_cell("protein4hhb.sky", SPEC)
KIND = CELL.kind
SEED = 2**31 + 4099
# One chain of 21 residues, every type once (two alanines), with one HEM,
# and three bounces.
SMALL = dict(CELL.config, chains=[["A", "small"]], helix_length=10,
             settings=dict(CELL.config["settings"], max_bounces=3),
             compositions={"small": {"ALA": 2, "ARG": 1, "ASN": 1, "ASP": 1, "CYS": 1,
                                     "GLN": 1, "GLU": 1, "GLY": 1, "HIS": 1, "ILE": 1,
                                     "LEU": 1, "LYS": 1, "MET": 1, "PHE": 1, "PRO": 1,
                                     "SER": 1, "THR": 1, "TRP": 1, "TYR": 1, "VAL": 1}})
# Six residues and a HEM, its SES on a 1.0 A grid (K = 19 clusters): the
# kind's CPU frames at 64x36 take about a second each.
TINY = dict(SMALL, helix_length=6, surface_resolution=1.0,
            compositions={"small": {"ALA": 1, "GLY": 1, "LYS": 1, "PHE": 1, "SER": 1,
                                    "TRP": 1}})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per test worker, as in tests/test_torch_render.py;
    the previous value comes back after this module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _expected_elements(config):
    """Heavy atoms by element of the configuration's composition: each
    residue's backbone, CB and side chain, an OXT a chain, 43 a HEM."""
    counts = Counter()
    for _, kind in config["chains"]:
        for res, k in config["compositions"][kind].items():
            names, elems, _, _ = KIND._side_distances(res)
            counts.update({"N": k, "C": (2 if res == "GLY" else 3) * k, "O": k})
            for e in elems:
                counts[e] += k
        counts["O"] += 1
        if config["hem"]:
            counts.update(Counter(KIND.hem_template()[1]))
    return counts


@pytest.fixture(scope="module")
def full():
    return KIND.generate(CELL.config, SEED)


@pytest.fixture(scope="module")
def small():
    return KIND.generate(SMALL, SEED)


def test_generator_is_deterministic_and_draws_the_composition(full, small):
    # The seed draws the same structure again, and another seed another
    # (on the small structure: the whole takes seconds a draw).
    again = KIND.generate(SMALL, SEED)
    assert again["pdb"] == small["pdb"]
    assert np.array_equal(again["positions"], small["positions"])
    other = KIND.generate(SMALL, SEED + 1)
    assert not np.array_equal(other["positions"], small["positions"])
    chains = Counter(full["chains"])
    assert chains == {"A": 141, "B": 146, "C": 141, "D": 146}
    for chain, kind in CELL.config["chains"]:
        res = Counter(r for c, r in zip(full["chains"], full["res_names"]) if c == chain)
        assert res == CELL.config["compositions"][kind], chain
    assert Counter(full["elements"]) == _expected_elements(CELL.config)
    assert len(full["elements"]) == 4556 and int(full["is_het"].sum()) == 4 * 43
    mol = parse_auto_detect(full["pdb"], "protein.pdb")
    assert mol.elements == full["elements"]
    assert np.array_equal(mol.positions, full["positions"])
    fe = [i for i, e in enumerate(mol.elements) if e == "Fe"]
    assert len(fe) == 4 and all(mol.is_het[i] and mol.res_names[i] == "HEM" for i in fe)
    # Each Fe bonds its four pyrrole nitrogens at 2.0 A.
    for i in fe:
        partners = [int(b) for a, b in full["conect"] if a == i] + \
                   [int(a) for a, b in full["conect"] if b == i]
        assert sorted(full["elements"][j] for j in partners) == ["N"] * 4
        d = np.linalg.norm(full["positions"][partners] - full["positions"][i], axis=1)
        assert np.allclose(d, 2.0, atol=2e-3)


def test_inference_finds_exactly_the_covalent_bonds_and_the_floor_holds(full):
    pos, elements = full["positions"], full["elements"]
    bonds = {tuple(b) for b in full["bonds"].tolist()}
    assert {tuple(b) for b in infer_bonds(pos, elements).tolist()} == bonds
    # Bond counts up to 3 by breadth-first search over the covalent bonds.
    n = len(elements)
    adj = [[] for _ in range(n)]
    for a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)
    near = [set() for _ in range(n)]
    for s in range(n):
        frontier, seen = {s}, {s}
        for _ in range(3):
            frontier = {b for a in frontier for b in adj[a]} - seen
            seen |= frontier
        near[s] = seen
    cell = np.floor(pos / 2.6).astype(np.int64)
    keys = {}
    for i, k in enumerate(map(tuple, cell)):
        keys.setdefault(k, []).append(i)
    close = 0
    for i in range(n):
        k = cell[i]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in keys.get((k[0] + dx, k[1] + dy, k[2] + dz), ()):
                        if j > i and j not in near[i]:
                            close += np.linalg.norm(pos[i] - pos[j]) < 2.6
    assert close == 0


def _least_box(pos, turns=2000):
    """Sorted sides of the least-volume box about the atoms, over the
    principal axes and `turns` seeded turns."""
    q = np.random.default_rng(0).normal(size=(turns, 4))
    rotations = [KIND._quat_matrix(v) for v in q]
    rotations.append(np.linalg.svd(pos - pos.mean(axis=0), full_matrices=False)[2])
    along = np.einsum("nij,mj->nmi", np.array(rotations), pos - pos.mean(axis=0))
    sides = along.max(axis=1) - along.min(axis=1)
    return np.sort(sides[np.argmin(sides.prod(axis=1))])


def test_structure_has_the_entrys_size(full):
    """The atoms' least box within 10% of the entry's extent on each side;
    and the volume a heavy atom takes inside the protein (a sphere of 8 A
    over the heavy atoms it holds, at the 90th percentile of the atoms'
    spheres: the buried ones) within 15% of 18 A^3, a folded protein's
    (mass times partial specific volume over the heavy atoms). The
    structure before the packing was fitted read about 88 A a side and
    28 A^3."""
    pos = full["positions"].astype(np.float64)
    entry = np.sort(np.asarray(CELL.config["extent"], np.float64))
    box = _least_box(pos)
    assert np.all(np.abs(box / entry - 1.0) <= 0.10), box
    held = np.array([len(n) for n in cKDTree(pos).query_ball_point(pos, 8.0)])
    per_atom = 4.0 / 3.0 * np.pi * 8.0 ** 3 / np.quantile(held, 0.9)
    assert abs(per_atom / 18.0 - 1.0) <= 0.15, per_atom


def test_reference_bonds_are_the_ports(small):
    mol = parse_auto_detect(small["pdb"], "small.pdb")
    pos, elements = small["positions"], small["elements"]
    assert np.array_equal(MOL.infer_bonds(pos, elements), infer_bonds(pos, elements))
    assert np.array_equal(MOL.molecule_bonds(pos, elements, small["conect"]),
                          np.unique(np.sort(mol.bonds, axis=1), axis=0))
    assert np.array_equal(MOL.molecule_bonds(pos, elements, np.zeros((0, 2))),
                          infer_bonds(pos, elements))


@pytest.mark.parametrize("structure,res", [("small", 0.5), ("tiny", 1.4)])
def test_reference_ses_is_the_ports(small, structure, res):
    """On the configuration's 0.5 A grid; and on a 1.4 A grid over six
    residues, where the surface is one connected component and the island
    filter keeps it whole."""
    geo = small if structure == "small" else KIND.generate(TINY, SEED)
    std = ~geo["is_het"]
    pos = geo["positions"][std]
    elements = [e for e, s in zip(geo["elements"], std) if s]
    radii = element_radii_array(elements)
    v, _, idx = compute_ses(pos, radii, probe_radius=1.4, resolution=res)
    rv, _, ridx = MOL.ses(pos.astype(np.float64), radii.astype(np.float64), 1.4, res, "cpu")
    assert idx.shape[0] > 0
    # A grid point whose field rounds across 0 on one side can flip one
    # cell's marching-cubes case: the counts and vertices agree up to such
    # cells.
    assert abs(ridx.shape[0] - idx.shape[0]) <= 0.005 * idx.shape[0]
    for a, b in ((v, rv), (rv, v)):
        d, _ = cKDTree(b).query(a)
        assert np.mean(d < 1e-3) >= 0.995


def _tiny_cell():
    return CELLS.Cell(name="protein4hhb.sky", chips=1, config=TINY, traffic=CELL.traffic,
                      program_env=CELL.program_env, limits=CELL.limits, kind=KIND)


# Faults planted in the program: its settings after the configuration's.
# The view is the orbit's first turned on the protein (the HEM lies beside
# it) at a quarter of the fitted distance, so that its glass fills the
# 64x36 frame: from the fitted distance about 3% of the pixels hit the
# scene, and refraction without its tint moved their mean by 0.01-0.06%
# from 1.0 to 0.4 of that distance (the atoms inside the glass are in its
# shadow), under the cell's bias limit; 4.7% here.
FAULTS = {"none": {}, "opaque glass": {"surface_opacity": 1.0},
          "untinted glass": {"surface_transmission": 0.0}}
FRAMES = 2


def test_the_kind_is_checked_and_faults_are_not_correct(monkeypatch):
    """set_up, then each variant's frames of a close view through
    Renderer.render_frame(), each held by the check against the
    reference's means of the same frames."""
    cell = _tiny_cell()
    for key, value in cell.program_env.items():
        monkeypatch.setenv(key, value)
    prog = MAIN.set_up(cell, SEED, "cpu", size=(64, 36))
    r = prog.renderer
    protein = prog.geo["positions"][~prog.geo["is_het"]].mean(axis=0)
    view = dict(prog.first, target=protein, distance=0.25 * prog.first["distance"])
    ref = MAIN.reference_scene(cell, prog.geo, "cpu")
    rows, cols = MAIN.sample_pixels(cell, ref, view, 64, 36, SEED)
    expected = MAIN.reference_means(cell, ref, view, 64, 36, rows, cols, [FRAMES])[0]
    verdicts = {}
    for name, fault in FAULTS.items():
        MAIN._apply_settings(r.settings, cell.config["settings"])
        for k, v in fault.items():
            setattr(r.settings, k, v)
        MAIN._set_view(r, view)
        for _ in range(FRAMES):
            assert r.render_frame()
        numbers = CHECK.compare(r.accumulated()[rows, cols], expected)
        verdicts[name] = (CHECK.verdict(numbers, cell.limits), numbers)
    for name, (ok, numbers) in verdicts.items():
        assert ok is (name == "none"), (name, numbers)


def test_configuration_file_is_the_benchmarks():
    entry = {c["name"]: c for c in SPEC["configs"]}["protein4hhb"]
    data = json.loads((CELLS.ROOT / entry["file"]).read_text())
    assert data["generator"] == "protein" and entry["reduced"] == []
    assert (data["width"], data["height"], data["precision"]) == (1920, 1080, "float32")
    assert data["settings"]["material_mode"] == "surface-glass"
