"""Scene sources (host numpy): molecule parsing (SDF, PDB), bond inference,
ball-and-stick geometry, triangle meshes and the protein cartoon."""

from .elements import covalent_radius, element_color, element_radius
from .molecular import (BUILTIN_MOLECULE_NAMES, Geometry, MolData,
                        SecondaryRange, get_builtin_molecule, infer_bonds,
                        molecule_to_geometry, parse_auto_detect, parse_pdb,
                        parse_sdf, split_by_hetatm)

__all__ = ["BUILTIN_MOLECULE_NAMES", "Geometry", "MolData", "SecondaryRange",
           "covalent_radius", "element_color", "element_radius", "get_builtin_molecule",
           "infer_bonds", "molecule_to_geometry", "parse_auto_detect", "parse_pdb",
           "parse_sdf", "split_by_hetatm"]
