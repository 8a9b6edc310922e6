"""Build the CUDA kernels of ``csrc/`` once and bind them with ctypes.

The sources are compiled with ``nvcc`` for ``sm_90a`` (Hopper) into one
shared library with a plain C interface: each ``.cu`` file to an object
file, all ``nvcc`` processes started together, then one link. The library
lands in ``kernels/build/`` (listed in ``.gitignore``) under a name keyed
by a hash of the sources and flags, so an edit rebuilds and an unchanged
tree reuses the library. A file lock serialises concurrent builders.

Nothing here runs at import: the first CUDA call of a kernel wrapper calls
:func:`load`. There is no fallback: a missing ``nvcc`` or a failed build
raises.

The wrappers count their launches in :data:`LAUNCHES` (one per call that
launched the kernel on the card), so a run can show which kernels the main
path went through. Each wrapper is decorated with :func:`counted`, which
lets an op counter (``repro_torch.utils.opcount``) charge its calls by the
kernel's own formula.
"""
from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

__all__ = [
    "CSRC",
    "BUILD_DIR",
    "LAUNCHES",
    "load",
    "build",
    "build_log",
    "partial_blocks",
    "scratch",
    "check_status",
    "stream_handle",
    "kernel_fn",
    "check_vectors",
    "check_slot",
    "check_indices",
    "check_keep",
    "counted",
    "dtype_rate",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# Launch geometry of axpy_reduce's two-launch reduction, as
# csrc/common.cuh uses it: 256 threads a block and at most one partial per
# resident block (132 SMs x 8); the step direction's grid is two such waves
# (csrc/gather.cuh). The one-launch reductions size their grids themselves.
THREADS = 256
MAX_PARTIALS = 132 * 8

#: launches on the card per kernel name, counted by the wrappers
LAUNCHES: collections.Counter = collections.Counter()

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F64 = ctypes.c_double

# C signature of each entry point, and the dtypes it is built for (one
# symbol each: name + _f32 / _f64 / _bf16)
_FLOAT = (torch.float32, torch.float64)
_SEARCH_ARGS = [_PTR, _PTR, _PTR, _I64, _PTR, _PTR, _PTR, _I64, _F64, _F64, _F64, _INT, _F64] + [_PTR] * 5
_ENTRY_POINTS = {
    # u, v, w, mask, weights, g, E, stream
    "rt_incidence_gather": ([_PTR] * 6 + [_I64, _PTR], _FLOAT),
    # v, keep, se, n, part, stats, w, stream
    "rt_softmax_weights": ([_PTR, _PTR, _F64, _I64, _PTR, _PTR, _PTR, _PTR], _FLOAT),
    # y, dy, ky, ny, se_y, z, dz, kz, nz, se_z, alpha, part, out, stream
    "rt_linesearch_probe2": ([_PTR, _PTR, _PTR, _I64, _F64, _PTR, _PTR, _PTR, _I64, _F64, _F64, _PTR, _PTR, _PTR],
                             _FLOAT),
    # y, dy, ky, ny, z, dz, kz, nz, eta, ls_eps, alpha0, has_alpha0, tiny, part, out, dmax, alpha_prev, stream
    "rt_newton_search": (_SEARCH_ARGS, _FLOAT),
    "rt_binary_search": (_SEARCH_ARGS, _FLOAT),
    # y, dy, keep, alpha, alpha_dev, n, nb, out, part, red, stream
    "rt_axpy_reduce": ([_PTR, _PTR, _PTR, _F64, _PTR, _I64, _INT, _PTR, _PTR, _PTR, _PTR], _FLOAT),
    # x, base, out, n; (offsets, splits, src, wt, nnz, lo, span, slabs) of side A, then of side B; order,
    # scratch, stream
    "rt_incidence_scatter": ([_PTR, _PTR, _PTR, _I64] + ([_PTR] * 4 + [_I64] * 4) * 2 + [_PTR] * 3, _FLOAT),
    # u, v, w, mask, weights, g, h, x, scale, tiny, E, nb, d, part, ticket, dmax, stream
    "rt_step_direction": ([_PTR] * 8 + [_F64, _F64, _I64, _INT] + [_PTR] * 5, _FLOAT),
    # q, k, v, o; B, S, Hq, Hkv, D; (batch, seq, head) strides of q, k, v, o; causal, window; stream
    "rt_flash_attention": ([_PTR] * 4 + [_INT] * 5 + [_I64] * 12 + [_INT, _INT, _PTR], (torch.bfloat16, torch.float32)),
}
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64", torch.bfloat16: "_bf16"}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (nvcc on PATH or /usr/local/cuda)")
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet; returns (path, seconds).

    The seconds are those of this call: 0.0-ish when the library exists.
    The compiler's output (``-Xptxas -v``: registers, spills) is kept
    beside the library, under the same source hash (``build_log``).
    """
    t0 = time.perf_counter()
    path = _library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            _compile(path)
    return path, time.perf_counter() - t0


def build_log() -> Path:
    """The compiler's output for the library that the current sources build."""
    return _library_path().with_suffix(".log")


def _compile(path: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        path.with_suffix(".log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / path.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, path)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and bound once per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, dtypes) in _ENTRY_POINTS.items():
        for dtype in dtypes:
            fn = getattr(lib, name + _SUFFIX[dtype])
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    lib.rt_flash_bf16_config.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.rt_flash_bf16_config.restype = ctypes.c_int
    lib.rt_max_partials.argtypes = []
    lib.rt_max_partials.restype = ctypes.c_int
    lib.rt_search_plan.argtypes = [_I64, _I64, _INT, ctypes.POINTER(ctypes.c_int)]
    lib.rt_search_plan.restype = ctypes.c_int
    lib.rt_search_scratch_states.argtypes = []
    lib.rt_search_scratch_states.restype = ctypes.c_int
    lib.rt_incidence_scatter_scratch.argtypes = [_I64, _I64, _I64]
    lib.rt_incidence_scatter_scratch.restype = ctypes.c_int64
    lib.rt_incidence_scatter_tile.argtypes = []
    lib.rt_incidence_scatter_tile.restype = ctypes.c_int
    return lib


def kernel_fn(name: str, dtype: torch.dtype):
    """The C entry point ``name`` for ``dtype``; raises for a dtype it is not built for."""
    dtypes = _ENTRY_POINTS[name][1]
    if dtype not in dtypes:
        raise TypeError(f"{name}: no kernel for {dtype}; built for {', '.join(map(str, dtypes))}")
    return getattr(load(), name + _SUFFIX[dtype])


def check_status(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launches."""
    if rc != 0:
        msg = load().rt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} ({msg})")


def partial_blocks(n: int) -> int:
    """Blocks of a reduction sweep over n elements (= partial states)."""
    return max(1, min(-(-n // THREADS), MAX_PARTIALS))


def scratch(name: str, like: torch.Tensor, states: int, zeroed: bool = False) -> torch.Tensor:
    """The partials' scratch of a one-launch reduction over ``like``: room for
    ``states`` values of like's dtype per partial, as many partials as a grid
    may have (the kernels size their grids themselves), zeroed when it is
    made if ``zeroed``. Kept for the life of the process, one per (name,
    device, current stream, dtype, size), so that two launches share one
    only in stream order."""
    return _scratch(name, like.device, stream_handle(like), like.dtype, states * load().rt_max_partials(), zeroed)


@functools.lru_cache(maxsize=None)
def _scratch(name: str, device: torch.device, stream: int, dtype: torch.dtype, numel: int,
             zeroed: bool) -> torch.Tensor:
    return (torch.zeros if zeroed else torch.empty)(numel, dtype=dtype, device=device)


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_vectors(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """Check that ``tensors`` are 1-D, contiguous, on one CUDA device and of
    one dtype, float32 or float64; return that dtype."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {t0.device}")
    if t0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype must be float32 or float64, got {t0.dtype}")
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t.device} and {t0.device}")
        if t.dtype != t0.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {t0.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous 1-D tensors, got shape {tuple(t.shape)}")
    return t0.dtype


def check_slot(name: str, like: torch.Tensor, t: torch.Tensor, size: int, what: str) -> None:
    """Check that ``t`` is a contiguous float64 tensor of ``size`` values on
    ``like``'s device: a value a kernel reads or writes in device memory."""
    if t.dtype != torch.float64 or t.device != like.device or t.numel() != size or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be {size} contiguous float64 value(s) on {like.device}, got "
                         f"{t.dtype} of shape {tuple(t.shape)} on {t.device}")


def check_indices(name: str, like: torch.Tensor, *indices: torch.Tensor) -> int:
    """Check that ``indices`` are contiguous 1-D int32 tensors of one length
    on ``like``'s device; return that length."""
    n = indices[0].shape[0] if indices[0].dim() == 1 else -1
    for t in indices:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: indices must be int32, got {t.dtype}")
        if t.device != like.device:
            raise ValueError(f"{name}: indices on {t.device}, values on {like.device}")
        if t.dim() != 1 or not t.is_contiguous() or t.shape[0] != n:
            raise ValueError(f"{name}: indices must be contiguous 1-D tensors of one length")
    return n


def check_keep(name: str, like: torch.Tensor, keep: torch.Tensor | None) -> int | None:
    """Check that a row mask is a contiguous 1-D bool or uint8 tensor of
    ``like``'s length on its device (one byte a row, nonzero: kept); return
    its address for a kernel, None for no mask."""
    if keep is None:
        return None
    if keep.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name}: a row mask must be bool or uint8, got {keep.dtype}")
    if keep.device != like.device:
        raise ValueError(f"{name}: row mask on {keep.device}, values on {like.device}")
    if keep.dim() != 1 or not keep.is_contiguous() or keep.shape[0] != like.shape[0]:
        raise ValueError(f"{name}: a row mask must be a contiguous 1-D tensor of {like.shape[0]} values, got shape "
                         f"{tuple(keep.shape)}")
    return keep.data_ptr()


def dtype_rate(dtype: torch.dtype) -> str:
    """The rate (``utils.roofline``) of a kernel's arithmetic outside the tensor cores."""
    return "f64" if dtype == torch.float64 else "f32"


def counted(name: str, flops):
    """Decorator of kernel ``name``'s wrapper: where an op counter
    (``repro_torch.utils.opcount.OpCounter``) is the active dispatch mode, a
    call is charged to it as one op, ``flops(result, *args, **kwargs)``
    (FLOPs by rate) and its tensors' bytes, whichever version runs; else
    the wrapper runs untouched."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            mode = _get_current_dispatch_mode()
            if mode is None or not hasattr(mode, "kernel_call"):
                return fn(*args, **kwargs)
            return mode.kernel_call(name, flops, fn, args, kwargs)
        return call

    return wrap
