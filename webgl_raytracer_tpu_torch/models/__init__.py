"""Scene sources: the bundled molecules and ball-and-stick geometry."""

from .molecular import (BUILTIN_MOLECULE_NAMES, Geometry, MolData,
                        get_builtin_molecule, molecule_to_geometry, parse_sdf)

__all__ = ["BUILTIN_MOLECULE_NAMES", "Geometry", "MolData",
           "get_builtin_molecule", "molecule_to_geometry", "parse_sdf"]
