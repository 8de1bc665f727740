"""The native (C++) host builders, loaded through ctypes: the SAH BVH
builder (csrc/bvh_builder.cpp) and the SES distance-field splats
(csrc/distance_field.cpp).

Each is built with g++ at first use into webgl_raytracer_tpu_torch/_build/
(git-ignored), named by a hash of its source and the flags; the flags are
the JAX package's, so both packages' builders produce identical results
on one machine. Without a compiler a loader returns None and its caller
uses its numpy version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "bvh_builder.cpp"
DF_SOURCE = PACKAGE_DIR / "csrc" / "distance_field.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def library_path(source: Path = SOURCE, stem: str = "libwrt_bvh") -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _load(source: Path, stem: str):
    """The ctypes library built from `source`, or None without g++."""
    out = library_path(source, stem)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(source)],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


@functools.cache
def load_bvh_builder():
    """The ctypes library with wrt_build_bvh, or None when it cannot be
    built (no g++)."""
    lib = _load(SOURCE, "libwrt_bvh")
    if lib is None:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.wrt_build_bvh.restype = ctypes.c_int
    lib.wrt_build_bvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        f32p, f32p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong)]
    return lib


@functools.cache
def load_distance_field():
    """The ctypes library with wrt_probe_field and wrt_sphere_field (the
    SES distance-field splats), or None when it cannot be built."""
    lib = _load(DF_SOURCE, "libwrt_distance_field")
    if lib is None:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_longlong
    f32 = ctypes.c_float
    lib.wrt_probe_field.restype = None
    lib.wrt_probe_field.argtypes = [
        f32p, i64, f32, f32, f32, f32, f32, f32, i64, i64, i64, f32p]
    lib.wrt_sphere_field.restype = None
    lib.wrt_sphere_field.argtypes = [
        f32p, f32p, i64, f32, f32, f32, f32, f32, i64, i64, i64, f32p]
    return lib
