"""Environment selection and caching.

Counterpart of webgl_raytracer_tpu/env/controller.py: a cache keyed by
HDR path or analytic-sky settings, producing EnvBuffers (image and CDFs,
built on the controller's device) for the Renderer, with a manifest of
the HDR assets in `asset_dir` and the JAX package's log lines.
"""

from __future__ import annotations

import json
import os

from ..device import resolve_device
from ..ops.envmap import EnvBuffers
from .cdf import make_env_buffers
from .hdr import load_hdr
from .sky import ANALYTIC_SKY_ID, analytic_sky_cache_key, generate_analytic_sky


class EnvironmentController:
    def __init__(self, asset_dir: str | None = None, logger=None, device=None):
        """device None means cuda:0 (raises without a GPU)."""
        self.asset_dir = asset_dir
        self.logger = logger
        self.device = resolve_device(device)
        self._cache: dict[str, EnvBuffers] = {}
        self.current: EnvBuffers | None = None
        self.current_key: str | None = None

    def _select(self, key: str, build) -> EnvBuffers:
        if key not in self._cache:
            self._cache[key] = build()
        self.current = self._cache[key]
        self.current_key = key
        return self.current

    def load_hdr_file(self, path: str) -> EnvBuffers:
        """Decode a Radiance .hdr on the host; image and CDFs on the device."""
        def build():
            hdr = load_hdr(path, self.logger)
            env = make_env_buffers(hdr["data"], self.device)
            if self.logger:
                self.logger.info(
                    f"Environment loaded: {path} ({hdr['width']}x{hdr['height']})")
            return env

        return self._select(os.path.abspath(path), build)

    def load_analytic_sky(self, settings=None, **kw) -> EnvBuffers:
        """Bake the Preetham sky and its CDFs on the device."""
        def build():
            sky = generate_analytic_sky(settings, device=self.device, **kw)
            env = make_env_buffers(sky["data"], self.device)
            if self.logger:
                s = sky["settings"]
                self.logger.info(f"Analytic sky generated ({s.width}x{s.height}, "
                                 f"turbidity {s.turbidity:.2f})")
            return env

        return self._select(ANALYTIC_SKY_ID + ":" + analytic_sky_cache_key(settings, **kw),
                            build)

    def clear(self) -> None:
        """Back to 'no environment'."""
        self.current = None
        self.current_key = None

    def manifest(self) -> list[dict]:
        """The HDR assets of asset_dir: its manifest.json if present, else
        a scan for .hdr files."""
        if not self.asset_dir or not os.path.isdir(self.asset_dir):
            return []
        manifest_path = os.path.join(self.asset_dir, "manifest.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                data = json.load(f)
            return data if isinstance(data, list) else data.get("environments", [])
        return [{"name": os.path.splitext(f)[0], "file": f}
                for f in sorted(os.listdir(self.asset_dir))
                if f.lower().endswith(".hdr")]
