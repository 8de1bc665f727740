"""Application layer: scene-loading pipelines (molecule styles, the protein
cartoon, the debug and random-sphere scenes), the CLI (app/cli.py) and the
interactive HTTP viewer (app/server.py)."""
