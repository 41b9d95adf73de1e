"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` export a plain C interface (device pointers,
sizes and a stream in; the launch's ``cudaGetLastError()`` out) and are
bound with ``ctypes``: no source includes PyTorch's headers, so a build
takes seconds instead of the minutes a PyTorch-header translation unit
costs.  :func:`library` builds them once per process, at first use, for
``sm_90a`` (Hopper) into ``sntc_tpu_torch/_build/``:

* with ``ninja`` present, through ``torch.utils.cpp_extension.load``
  (all sources in one call; ninja compiles them in parallel and skips an
  up-to-date build);
* without it, one ``nvcc -c`` per source, all started together, then
  one link.

A build writes a stamp beside the library (:data:`STAMP`: the hash of
the sources, the flags and the torch and CUDA versions, and the
library's path).  A later process whose sources hash to the same stamp
loads that library directly, without ``cpp_extension`` or ``nvcc``; a
missing or stale stamp builds again.

A build failure raises :class:`KernelBuildError` and a launch failure
:class:`KernelLaunchError` (both ``RuntimeError`` subclasses; the launch
error carries the ``cudaError`` code, which the device fault domain
classifies by); nothing falls back to a plain version.  Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its kernel, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("forest_traversal.cu", "pad_rows.cu", "tree_hist.cu", "error.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
LIB_NAME = "sntc_tpu_torch_kernels"
STAMP = os.path.join(BUILD_DIR, LIB_NAME + ".stamp.json")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
CUDA_FLAGS = ["-O3", "-lineinfo"] + ARCH_FLAGS

#: kernel launches since the last :func:`reset_launches`, by kernel name
LAUNCHES: Dict[str, int] = {
    "forest_traversal": 0, "pad_assemble": 0, "tree_hist": 0,
}
#: ``pad_assemble``'s launches since the last :func:`reset_launches`, by
#: block and target (``"[N, C] f32 -> T"``): one run pads blocks of
#: several shapes, and each is timed on its own
PAD_LAUNCH_SHAPES: Dict[str, int] = {}
#: how the kernels were built in this process: route, seconds, path
BUILD_INFO: Dict[str, object] = {}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "sntc_forest_leaf_stats_f32": [_P] * 5 + [_I64] * 5 + [ctypes.c_int, _P],
    "sntc_forest_leaf_stats_f64": [_P] * 5 + [_I64] * 5 + [ctypes.c_int, _P],
    "sntc_pad_rows_f32": [_P, _P, _I64, _I64, _I64, ctypes.c_int, _P],
    "sntc_pad_rows_f64": [_P, _P, _I64, _I64, _I64, ctypes.c_int, _P],
    "sntc_tree_hist_f32": [_P] * 5 + [_I64] * 7 + [_P],
    "sntc_tree_hist_plan": [_I64] * 6 + [_P],
}


class KernelBuildError(RuntimeError):
    """The kernel library did not build or load."""


class KernelLaunchError(RuntimeError):
    """A launch entry point reported a CUDA error: ``cuda_error`` is the
    ``cudaError_t`` code, ``kernel`` the kernel's name."""

    def __init__(self, kernel: str, cuda_error: int, message: str):
        super().__init__(
            f"{kernel} launch failed: CUDA error {cuda_error}: {message}"
        )
        self.kernel = kernel
        self.cuda_error = int(cuda_error)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PAD_LAUNCH_SHAPES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found: cannot build the CUDA kernels"
        )
    return found


def _build_with_load(sources, verbose: bool) -> str:
    from torch.utils.cpp_extension import load

    flags = CUDA_FLAGS + (["-Xptxas=-v"] if verbose else [])
    return load(
        name=LIB_NAME,
        sources=sources,
        build_directory=BUILD_DIR,
        extra_cuda_cflags=flags,
        is_python_module=False,
        verbose=verbose,
    )


def _build_with_nvcc(sources, verbose: bool) -> str:
    nvcc = _nvcc()
    flags = ["-std=c++17", "-Xcompiler", "-fPIC"] + CUDA_FLAGS
    if verbose:
        flags.append("-Xptxas=-v")
    objects, procs = [], []
    for src in sources:
        obj = os.path.join(
            BUILD_DIR, os.path.splitext(os.path.basename(src))[0] + ".o"
        )
        objects.append(obj)
        procs.append(
            (src, subprocess.Popen(
                [nvcc, *flags, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        )
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(out)
        if p.returncode != 0:
            failed.append(f"{src}:\n{out}")
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    lib = os.path.join(BUILD_DIR, f"lib{LIB_NAME}.so")
    subprocess.run(
        [nvcc, "-shared", *ARCH_FLAGS, "-o", lib, *objects], check=True
    )
    return lib


def source_stamp(sources) -> str:
    """The hash a built library is stamped with: every source's name
    and bytes, the flags, and the torch and CUDA versions."""
    h = hashlib.sha256()
    for src in sources:
        h.update(os.path.basename(src).encode() + b"\0")
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(json.dumps([CUDA_FLAGS, torch.__version__,
                         torch.version.cuda]).encode())
    return h.hexdigest()


def _stamped(stamp: str) -> Optional[str]:
    """The library a build stamped with ``stamp``, if it is there."""
    try:
        with open(STAMP) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    path = rec.get("path") if isinstance(rec, dict) else None
    if rec.get("stamp") != stamp or not path or not os.path.exists(path):
        return None
    return path


def _write_stamp(stamp: str, path: str) -> None:
    tmp = f"{STAMP}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"stamp": stamp, "path": path}, f)
    os.replace(tmp, STAMP)  # storage: unbounded(kernel build stamp)


def library(verbose: bool = False) -> ctypes.CDLL:
    """The bound kernel library, built at first use in this process
    (after that, returned without taking the lock)."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        os.makedirs(BUILD_DIR, exist_ok=True)
        sources = [os.path.join(CSRC, s) for s in SOURCES]
        t0 = time.perf_counter()
        try:
            stamp = source_stamp(sources)
            # a verbose build asks for the compiler's output: build
            path = None if verbose else _stamped(stamp)
            if path is not None:
                route = "stamped"
            else:
                from torch.utils.cpp_extension import is_ninja_available

                if is_ninja_available():
                    route = "cpp_extension.load"
                    path = _build_with_load(sources, verbose)
                else:
                    route, path = "nvcc", _build_with_nvcc(sources, verbose)
                _write_stamp(stamp, path)
            lib = ctypes.CDLL(path)
        except KernelBuildError:
            raise
        except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
            raise KernelBuildError(
                f"building the CUDA kernels failed: {e}"
            ) from e
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.sntc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sntc_cuda_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(
            route=route, seconds=time.perf_counter() - t0, path=path
        )
        _LIB = lib
        return lib


def check_launch(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise :class:`KernelLaunchError` when a launch entry point
    reported a CUDA error."""
    if err != 0:
        msg = lib.sntc_cuda_error_string(err).decode()
        raise KernelLaunchError(kernel, err, msg)


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream
