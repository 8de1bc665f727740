"""Build and load the hand-written CUDA kernels (csrc/) for Hopper.

Each source compiles with its own nvcc process, all started together,
and one more nvcc links the objects into a shared library with a plain C
interface, loaded through ctypes. The build runs at first use, keyed by a
hash of the sources and flags, into webgl_raytracer_tpu_torch/_build/
(git-ignored), so a fresh checkout builds everything on its first trace.
Nothing here runs at import time; without nvcc the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..utils import telemetry

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("trace_closest.cu", "trace_any3.cu", "trace_any.cu",
           "trace_closest_perray.cu", "trace_any_perray.cu",
           "trace_closest_attrs.cu", "sweep_sol.cu", "volume_march.cu", "trace_stack.cu",
           "telemetry.cu", "shade.cu")
HEADERS = ("intersect.cuh", "shade.cuh")

# The trace kernels that have a cost form: the same source compiled with
# its counter (ops/trace.py, "Counts"), launched as "<name>_cost".
COST_FORMS = ("trace_closest", "trace_any3", "trace_any", "trace_closest_perray",
              "trace_any_perray")

# Kernel launches by kernel name (the entry point's name without "wrt_"),
# counted by launch(), the one call path of the wrappers' launch sites
# (ops/trace.py, ops/volume.py, ops/traversal.py, ops/shade.py,
# tools/sweep_sol.py).
launches = dict.fromkeys(("trace_closest", "trace_any3", "trace_any",
                          "trace_closest_perray", "trace_any_perray",
                          "trace_closest_attrs", "sweep_sol", "volume_march",
                          "trace_stack_closest", "trace_stack_any", "shade_surface",
                          "shade_scatter")
                         + tuple(f"{name}_cost" for name in COST_FORMS), 0)

# -fmad=false keeps every a*b+c rounded twice, as the plain PyTorch
# versions round it, so the kernels' outputs match them bit for bit. No
# --use_fast_math: padding primitives rely on NaN compares, and the maths
# needs IEEE sqrtf and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")


def compile_flags() -> tuple[str, ...]:
    """NVCC_FLAGS and the constants the sources take from Python: the stack
    tracer's stack size (csrc/trace_stack.cu WRT_STACK_DEPTH), the plain
    walk's ops/traversal.STACK_DEPTH, so that both apply one overflow
    guard."""
    from .traversal import STACK_DEPTH

    return NVCC_FLAGS + (f"-DWRT_STACK_DEPTH={STACK_DEPTH}",)


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(compile_flags()).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libwrt_trace_{_source_hash()}.so"


def build(ptxas_verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels unless this source hash is already built: one
    nvcc per source in parallel, then one link. Returns (library path,
    build seconds (0 when cached), compiler messages). Raises on a failed
    build."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.tmp{os.getpid()}"
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD_DIR / f"{tag}.{Path(src).stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *compile_flags(), *extra, "-c", "-o", str(obj), str(CSRC_DIR / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    messages, failed = [], []
    for src, proc in zip(SOURCES, procs):
        text = proc.communicate()[0]
        messages.append(text)
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{text}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, "".join(messages)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; telemetry span
    kernels.library: the sources' hash, the build or the load)."""
    with telemetry.host_span("kernels.library"):
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.wrt_trace_closest.restype = i32
    lib.wrt_trace_closest.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                      ptr, ptr, ptr]
    lib.wrt_trace_any3.restype = i32
    lib.wrt_trace_any3.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                   ptr, ptr]
    lib.wrt_trace_any.restype = i32
    lib.wrt_trace_any.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                  ptr, ptr]
    lib.wrt_trace_any_schedule.restype = i32
    lib.wrt_trace_any_schedule.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                           ptr, i32, ptr]
    lib.wrt_trace_closest_perray.restype = i32
    lib.wrt_trace_closest_perray.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr,
                                             i32, ptr, i32, ptr, ptr, ptr]
    lib.wrt_trace_any_perray.restype = i32
    lib.wrt_trace_any_perray.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                         ptr, i32, ptr, ptr]
    # The cost forms: the default form's arguments with cost i32[n] after
    # the outputs.
    lib.wrt_trace_closest_cost.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                           ptr, ptr, ptr, ptr]
    lib.wrt_trace_any3_cost.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                        ptr, ptr, ptr]
    lib.wrt_trace_any_cost.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                       ptr, ptr, ptr]
    lib.wrt_trace_any_cost_schedule.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                                ptr, ptr, i32, ptr]
    lib.wrt_trace_closest_perray_cost.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr,
                                                  i32, ptr, i32, ptr, ptr, ptr, ptr]
    lib.wrt_trace_any_perray_cost.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                              ptr, i32, ptr, ptr, ptr]
    for name in COST_FORMS:
        getattr(lib, f"wrt_{name}_cost").restype = i32
    lib.wrt_trace_any_cost_schedule.restype = i32
    lib.wrt_trace_closest_attrs.restype = i32
    lib.wrt_trace_closest_attrs.argtypes = [ptr, i64, ptr, ptr, ptr, i32, ptr, i32,
                                            ptr, ptr, ptr, ptr]
    lib.wrt_sweep_sol.restype = i32
    lib.wrt_sweep_sol.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr]
    f32 = ctypes.c_float
    # The march: the ten ray operands each as (pointer, step), active, n,
    # params, grid, nx, ny, nz, max_steps, out and the stream.
    lib.wrt_volume_march.restype = i32
    lib.wrt_volume_march.argtypes = [ptr, i32] * 10 + [ptr, i64, ptr, ptr, i32, i32, i32,
                                                       i32, ptr, ptr]
    # The stack walk: origin and direction each as (pointer, step), t_min,
    # t_max and accept_min each as (pointer, step, value), active, n,
    # nodes, the four primitive tables, the type bits, cp, clip_on,
    # max_steps, max_leaf, the live list and its count, then the outputs
    # and the stream.
    walk = ([ptr, i32] * 6 + [ptr, i32, f32] * 3 + [ptr, i64] + [ptr] * 5
            + [i32, ptr, i32, i32, i32, ptr, ptr])
    lib.wrt_trace_stack_closest.restype = i32
    lib.wrt_trace_stack_closest.argtypes = walk + [ptr, ptr, ptr, ptr, ptr]
    lib.wrt_trace_stack_any.restype = i32
    lib.wrt_trace_stack_any.argtypes = walk + [ptr, ptr, ptr]
    # The bounce step's shading (ops/shade.py surface_args, scatter_args):
    # counts and configuration, the state (rows as (pointer, step)), the
    # hit record, the rows, the environment, params, the outputs, the
    # stream.
    lib.wrt_shade_surface.restype = i32
    lib.wrt_shade_surface.argtypes = ([i64, i32, i32, i32, ptr] + [ptr, i32] * 10
                                      + [ptr] * 9 + [ptr, ptr, ptr, i32] + [ptr, i32] * 3
                                      + [i32] + [ptr] * 3 + [i32] * 4 + [ptr] * 7)
    lib.wrt_shade_scatter.restype = i32
    lib.wrt_shade_scatter.argtypes = ([i64, i32, i32, i32] + [ptr] * 9 + [ptr] * 3
                                      + [i32] * 4 + [ptr] * 5)
    # The recorder's device clock (utils/telemetry.py): out, the stream.
    lib.wrt_clock_mark.restype = i32
    lib.wrt_clock_mark.argtypes = [ptr, ptr]
    return lib


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(entry: str, device, *args) -> int:
    """Call the library's entry point `entry` with args and the current
    stream of `device`, with `device` the current device: the library's
    own CUDA runtime launches on the calling thread's current device,
    whatever device the stream belongs to. A tensor among args stands for
    its data pointer, None for a null pointer. A launch counts in
    `launches` and, with the recorder on, is a device span, both under
    the entry's name without "wrt_". Returns the entry's CUDA error code
    (0: launched)."""
    name = entry.removeprefix("wrt_")
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rec = telemetry.recorder
    if rec is not None:
        rec.push(name)
    with torch.cuda.device(device):
        err = getattr(library(), entry)(*args, stream_handle(device))
    if rec is not None:
        rec.pop()
    if err == 0:
        launches[name] += 1
    return err


def check_operand(x: torch.Tensor, dtype, device) -> None:
    """Raise unless x is a contiguous `dtype` tensor on `device`."""
    if x.dtype != dtype or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"kernel operand must be contiguous {dtype} on {device}; got "
            f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")


# The stack walk's live list (csrc/trace_stack.cu) and the march's grid
# (csrc/volume_march.cu) are indexed with 32-bit ints.
MAX_RAYS = (1 << 31) - 1


def ray_operand(x, n: int, device, name: str) -> tuple:
    """x, a ray operand of n rays, as a kernel takes it: (tensor, step).
    An f32 tensor on `device` of one value (0-d, one element, or expanded
    with every stride 0) is (x, 0); a contiguous f32 [n] row is (x, 1).
    Raises on anything else (another type, device or shape, a row with
    other strides)."""
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, not {type(x).__name__}")
    if x.dtype != torch.float32 or x.device != device:
        raise ValueError(f"{name} must be f32 on {device}, not {x.dtype} on {x.device}")
    if (x.numel() == 1 and x.dim() <= 1) or (tuple(x.shape) == (n,) and x.stride(0) == 0):
        return x, 0
    if tuple(x.shape) != (n,):
        raise ValueError(f"{name} must have shape ({n},) or hold one value, not "
                         f"{tuple(x.shape)}")
    check_operand(x, torch.float32, device)
    return x, 1


def value_operand(x, n: int, device, name: str) -> tuple:
    """x, a number or a ray operand (ray_operand), as a kernel takes it:
    (tensor or None, step, value); a number is (None, 0, x)."""
    if isinstance(x, torch.Tensor):
        return (*ray_operand(x, n, device, name), 0.0)
    return None, 0, float(x)


def mask_operand(active, n: int, device):
    """The activity mask as a kernel takes it: None (every ray live) or a
    contiguous bool [n] tensor on `device`; raises on anything else."""
    if active is None:
        return None
    if not isinstance(active, torch.Tensor) or tuple(active.shape) != (n,):
        raise ValueError(f"active must be None or a tensor of shape ({n},)")
    check_operand(active, torch.bool, device)
    return active


def ray_count(n: int) -> int:
    """n, raising beyond MAX_RAYS."""
    if n > MAX_RAYS:
        raise ValueError(f"{n} rays: the kernel takes at most {MAX_RAYS}")
    return n


def live_list(n: int, device) -> tuple:
    """(list i32[n], count i32[1] zero): the scratch of the stack walk's
    live-ray compaction (csrc/trace_stack.cu), allocated and zeroed on the
    stream, so that a captured graph replays the zeroing."""
    return (torch.empty(n, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))
