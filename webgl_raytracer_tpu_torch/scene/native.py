"""The native (C++) SAH BVH builder, csrc/bvh_builder.cpp, loaded through
ctypes.

Built with g++ at first use into webgl_raytracer_tpu_torch/_build/
(git-ignored), named by a hash of the source and flags; the flags are the
JAX package's, so both packages' builders produce identical trees. Without
a compiler the loader returns None and scene/bvh.py uses its numpy builder.
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
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwrt_bvh_{h.hexdigest()[:16]}.so"


@functools.cache
def load_bvh_builder():
    """The ctypes library with wrt_build_bvh, or None when it cannot be
    built (no g++)."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.wrt_build_bvh.restype = ctypes.c_int
    lib.wrt_build_bvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        f32p, f32p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong)]
    return lib
