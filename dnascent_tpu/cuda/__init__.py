"""CUDA kernels called through JAX's foreign function interface.

The sources in this directory are compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``libdnascent_cuda.so`` beside them the first time a kernel
is needed, and rebuilt when a source is newer than the library (the same
self-building pattern as :mod:`dnascent_tpu.native`).  To build ahead of a
run::

    python -c "from dnascent_tpu import cuda; cuda.build()"

``nvcc`` is looked up on ``PATH`` and then under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``).  Nothing here is imported on the CPU path.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, n) for n in ("banded_fill.cu",
                                          "banded_fill_kernel.h")]
_LIB = os.path.join(_HERE, "libdnascent_cuda.so")
BANDED_FILL_TARGET = "dnascent_banded_fill"

_lock = threading.Lock()
_lib = None       # the loaded library, kept while its targets are registered


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build() -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path.  The library is written to a temporary name and renamed, so a
    concurrent reader never loads a half-written file."""
    if (os.path.exists(_LIB)
            and all(os.path.getmtime(_LIB) >= os.path.getmtime(s)
                    for s in _SRCS)):
        return _LIB
    import jax.ffi
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-I", _HERE,
           "-o", tmp, _SRCS[0]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + proc.stderr[-4000:])
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIB


def ensure_registered() -> None:
    """Build (if needed), load, and register the FFI targets for CUDA."""
    global _lib
    with _lock:
        if _lib is not None:
            return
        import jax.ffi
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            BANDED_FILL_TARGET, jax.ffi.pycapsule(lib.DnascentBandedFill),
            platform="CUDA")
        _lib = lib
