"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, in ``build/dmt_torch_kernels/``
at the checkout root, and loaded with ``ctypes``: :func:`library` builds
the one it is asked for, :func:`build_all` every source at once, one
``nvcc`` process each, started together.  A library newer than its source
is reused.  Pointers and the CUDA stream are passed as
``c_void_p``; each entry point returns the ``cudaError_t`` of its launch.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict

from ..utils.build import build_dir

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "library", "error_string",
           "build_log", "kernel_attributes", "record_kernel_analysis"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")

#: kernel library name → source file under csrc/
SOURCES = {"fused_decode": "fused_decode.cu", "ell_apply": "ell_apply.cu"}

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
              "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int

# C signatures of the entry points, per library
_SIGNATURES = {
    "fused_decode": {
        "dmt_fused_decode_gather_scatter": (
            _int, [_vp, _i64, _i64, _vp, _int, _vp, _i64, _vp, _vp, _vp,
                   _i64, _int, _int, _i64, _vp]),
        # the earlier one-thread-per-entry design, timed beside it by
        # chip_smoke.py; the main path never calls it
        "dmt_fused_decode_per_entry": (
            _int, [_vp, _i64, _vp, _int, _vp, _vp, _vp, _i64, _int, _int,
                   _i64, _vp]),
        "dmt_fused_decode_attributes": (_int, [_int, _int, _vp]),
        "dmt_cuda_error_string": (ctypes.c_char_p, [_int]),
    },
    "ell_apply": {
        "dmt_ell_apply": (
            _int, [_int, _i64, _int, _int, _vp, _i64, _vp, _i64, _vp, _vp,
                   _vp, _vp]),
        "dmt_ell_tail": (
            _int, [_int, _i64, _int, _int, _vp, _vp, _i64, _vp, _i64, _vp,
                   _vp, _vp]),
        "dmt_cuda_error_string": (ctypes.c_char_p, [_int]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _paths(name: str):
    out = build_dir("dmt_torch_kernels")
    return (os.path.join(_CSRC, SOURCES[name]),
            os.path.join(out, f"lib{name}.so"),
            os.path.join(out, f"{name}.log"))


def build_all(names=None) -> Dict[str, str]:
    """Compile every stale kernel library (of ``names``; all by default),
    one ``nvcc`` per source, all in parallel.  Returns ``{name: library
    path}``; raises with the compiler's output if any build fails.
    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is
    kept in ``<name>.log`` beside the library."""
    names = list(SOURCES if names is None else names)
    procs = {}
    for name in names:
        src, so, log = _paths(name)
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(
                src):
            continue
        tmp = f"{so}.build{os.getpid()}"
        with open(log, "w") as fh:
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=fh, stderr=subprocess.STDOUT), tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        if proc.wait() != 0:
            failed.append(f"{name}:\n{build_log(name)}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return {name: _paths(name)[1] for name in names}


def build_log(name: str) -> str:
    """The compiler output of the last build of library ``name``."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return ""
    with open(log) as fh:
        return fh.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    """``cudaGetErrorString`` of a launch's return code, through the
    library that launched (each carries the entry point)."""
    msg = lib.dmt_cuda_error_string(int(code))
    return f"{msg.decode() if msg else 'unknown error'} ({code})"


#: ``cudaFuncGetAttributes`` fields, in the order the entry point writes
ATTRIBUTE_FIELDS = ("num_regs", "shared_size_bytes", "local_size_bytes",
                    "const_size_bytes", "max_threads_per_block")

_recorded = False


def kernel_attributes(code_bits: int = 16, buckets: bool = False
                      ) -> Dict[str, int]:
    """The decode kernel's compiled resource figures for one instance
    (``code_bits`` 8 or 16; ``buckets`` for D > 1), by
    ``cudaFuncGetAttributes``."""
    import numpy as np

    out = np.zeros(len(ATTRIBUTE_FIELDS), dtype=np.int64)
    lib = library("fused_decode")
    code = lib.dmt_fused_decode_attributes(int(code_bits),
                                           int(bool(buckets)),
                                           out.ctypes.data)
    if code != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: "
                           f"{error_string(lib, code)}")
    return dict(zip(ATTRIBUTE_FIELDS, map(int, out)))


def record_kernel_analysis() -> None:
    """Record every decode-kernel instance's attributes in the memory
    layer (``memory_analysis`` events and sidecars), once per process;
    called at the first launch."""
    global _recorded
    if _recorded:
        return
    _recorded = True
    from ..obs import memory as obs_memory

    for bits in (8, 16):
        for buckets in (False, True):
            obs_memory.record_executable_analysis(
                f"fused_decode/u{bits}/{'buckets' if buckets else 'd1'}",
                kernel_attributes(bits, buckets),
                program="fused_decode_kernel")
