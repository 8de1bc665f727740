"""Measurement tools of the port, each runnable with `python -m`."""
