"""Environment lighting: HDR decode, analytic sky, CDF build and the
environment controller."""

from .cdf import build_env_sampling, constant_env, env_from_numpy, make_env_buffers
from .controller import EnvironmentController
from .hdr import decode_hdr, encode_hdr, load_hdr
from .sky import (ANALYTIC_SKY_ID, AnalyticSkySettings, analytic_sky_cache_key,
                  compute_sun_direction, generate_analytic_sky,
                  normalize_analytic_sky_settings, sky_image)

__all__ = ["ANALYTIC_SKY_ID", "AnalyticSkySettings", "EnvironmentController",
           "analytic_sky_cache_key", "build_env_sampling", "compute_sun_direction",
           "constant_env", "decode_hdr", "encode_hdr", "env_from_numpy",
           "generate_analytic_sky", "load_hdr", "make_env_buffers",
           "normalize_analytic_sky_settings", "sky_image"]
