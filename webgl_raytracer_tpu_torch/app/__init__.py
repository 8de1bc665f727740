"""Application layer: scene-loading pipelines (molecule styles, the protein
cartoon, the debug and random-sphere scenes)."""
