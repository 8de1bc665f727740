"""Host helpers of the app layer: the ring logger, display formatting,
the standard-library PNG codec and the recorder of spans and counters
(telemetry). The JAX package's enable_compilation_cache
(XLA's program cache) has no counterpart: the port's built kernels are
cached in webgl_raytracer_tpu_torch/_build/ (ops/kernels.py)."""

from .format import format_poly_count
from .logging import RingLogger, create_logger
from .png import decode_png, encode_png, upsample_nearest
from . import telemetry

__all__ = ["RingLogger", "create_logger", "decode_png", "encode_png",
           "format_poly_count", "telemetry", "upsample_nearest"]
