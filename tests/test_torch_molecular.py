"""The port's molecule parsing against the JAX package's, exactly.

PDB parsing, bond inference, the HETATM split and format detection are host
numpy in both packages; on the same text they must give the same arrays,
lists and secondary-structure ranges (np.array_equal, NaN occupancies
equal).
"""

import dataclasses
import os

import numpy as np
import pytest

from webgl_raytracer_tpu.models import elements as JE
from webgl_raytracer_tpu.models import molecular as JM
from webgl_raytracer_tpu_torch.models import elements as PE
from webgl_raytracer_tpu_torch.models import molecular as PM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PDB = os.path.join(REPO, "assets", "proteins", "TSTP.pdb")
SOURCES = ["TSTP.pdb"] + [f"{name}.sdf" for name in PM.BUILTIN_MOLECULE_NAMES]


def _text(source):
    if source.endswith(".pdb"):
        with open(PDB, encoding="utf-8") as f:
            return f.read()
    return (PM.MOLECULE_DIR / source).read_text(encoding="utf-8")


def _assert_same_mol(p, j):
    """Every field of two MolData equal (arrays by value and dtype)."""
    assert [f.name for f in dataclasses.fields(p)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        a, b = getattr(p, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f.name
        elif f.name in ("helices", "sheets"):
            assert [dataclasses.astuple(x) for x in a] == [dataclasses.astuple(x) for x in b]
        else:
            assert a == b, f.name


def test_element_tables_match():
    assert PE.ELEMENT_COLORS == JE.ELEMENT_COLORS
    assert PE.ELEMENT_RADII == JE.ELEMENT_RADII
    assert PE.COVALENT_RADII == JE.COVALENT_RADII
    assert (PE.DEFAULT_COLOR, PE.DEFAULT_RADIUS, PE.DEFAULT_COVALENT_RADIUS) == \
        (JE.DEFAULT_COLOR, JE.DEFAULT_RADIUS, JE.DEFAULT_COVALENT_RADIUS)
    names = sorted(JE.ELEMENT_RADII) + ["Xx", "Se"]
    assert np.array_equal(PE.covalent_radii_array(names), JE.covalent_radii_array(names))


@pytest.mark.parametrize("source", SOURCES)
def test_parse_auto_detect_matches_jax(source):
    text = _text(source)
    p, j = PM.parse_auto_detect(text, source), JM.parse_auto_detect(text, source)
    _assert_same_mol(p, j)
    assert p.num_atoms > 0


def test_tstp_parse_has_the_pdb_fields():
    mol = PM.parse_pdb(_text("TSTP.pdb"))
    assert mol.num_atoms == 437 and int(mol.is_het.sum()) == 10
    assert mol.helices and mol.sheets
    assert set(mol.chain_ids) and mol.res_seq_valid.all()


def test_infer_bonds_matches_jax():
    """Without CONECT records the PDB parser infers bonds; also on the SDF
    molecules' positions, and on one atom and none."""
    text = "\n".join(ln for ln in _text("TSTP.pdb").split("\n")
                     if not ln.startswith("CONECT"))
    p, j = PM.parse_pdb(text), JM.parse_pdb(text)
    _assert_same_mol(p, j)
    assert p.num_bonds > p.num_atoms // 2
    for name in PM.BUILTIN_MOLECULE_NAMES:
        mol = PM.get_builtin_molecule(name)
        assert np.array_equal(PM.infer_bonds(mol.positions, mol.elements),
                              JM.infer_bonds(mol.positions, mol.elements))
    for n in (0, 1):
        pos = np.zeros((n, 3), np.float32)
        assert np.array_equal(PM.infer_bonds(pos, ["C"] * n), JM.infer_bonds(pos, ["C"] * n))


@pytest.mark.parametrize("source", ["TSTP.pdb", "caffeine.sdf"])
def test_split_by_hetatm_matches_jax(source):
    text = _text(source)
    p_std, p_het = PM.split_by_hetatm(PM.parse_auto_detect(text, source))
    j_std, j_het = JM.split_by_hetatm(JM.parse_auto_detect(text, source))
    _assert_same_mol(p_std, j_std)
    _assert_same_mol(p_het, j_het)


@pytest.mark.parametrize("raw,name", [
    ("", " CA "), ("", "FE  "), ("", "CA  "), ("", "1HB "), ("CL", " CL "), ("FE", "FE  "),
    ("ZN", "ZN  "), ("XX", " XX "), (" C", " C1 "), ("", "HD21")])
def test_normalize_element_matches_jax(raw, name):
    assert PM._normalize_element(raw, name) == JM._normalize_element(raw, name)


def test_molecule_to_geometry_matches_jax():
    mol = PM.parse_auto_detect(_text("TSTP.pdb"), "TSTP.pdb")
    jmol = JM.parse_auto_detect(_text("TSTP.pdb"), "TSTP.pdb")
    for kw in ({}, {"radius_scale": 1.0, "show_bonds": False}, {"bond_radius": 0.12}):
        p, j = PM.molecule_to_geometry(mol, **kw), JM.molecule_to_geometry(jmol, **kw)
        for f in dataclasses.fields(j):
            assert np.array_equal(getattr(p, f.name), getattr(j, f.name)), f.name


def test_malformed_pdb_coordinates_raise():
    line = "ATOM      1  N   MET A   1      xx.xxx  10.000  10.000  1.00 10.00           N"
    with pytest.raises(ValueError):
        PM.parse_pdb(line)
