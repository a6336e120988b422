"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources under ``csrc/`` export a plain C interface (pointers, ints and a
stream; each function returns ``cudaGetLastError()`` after its launches), so
they compile in seconds without PyTorch's headers. The shared library goes to
``onepose_plus_plus_tpu_torch/_build/`` (ignored by git), keyed by a hash of
the sources and flags, and is built at first use: nothing here runs when the
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C functions: name -> argument types (all return int)
_SIGNATURES = {
    "opp_encoder_layer_f32": [_P] * 17 + [_I] * 5 + [_P],
    "opp_encoder_layer_bf16": [_P] * 17 + [_I] * 5 + [_P],
    "opp_encoder_source_tiles": [_I],
    "opp_rowcol_stats_f32": [_P] * 12 + [_I] * 4 + [_F, _P],
    "opp_rowcol_stats_bf16": [_P] * 12 + [_I] * 4 + [_F, _P],
    "opp_rowcol_row_tiles": [_I],
    "opp_window_gather_f32": [_P] * 3 + [_I] * 9 + [_P],
    "opp_window_gather_bf16": [_P] * 3 + [_I] * 9 + [_P],
}


class KernelLibrary:
    """The loaded kernel library and how it was built."""

    def __init__(self, path: Path, build_seconds: float, compiler_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.compiler_log = compiler_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Call an exported launcher; raise if CUDA reported an error."""
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed with cudaError {rc}")


_loaded: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    """Hash of every source and header and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, headers = _sources()
    for path in cus + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> KernelLibrary:
    """Compile (unless this source hash is already built) and load the library.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills per
    kernel) and forces a rebuild so its report lands in ``compiler_log``.
    """
    global _loaded
    if _loaded is not None and not verbose:
        return _loaded
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libopp_kernels_{source_digest()}.so"
    t0 = time.perf_counter()
    log = ""
    if verbose or not lib_path.exists():
        cus, _ = _sources()
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), *map(str, cus)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    _loaded = KernelLibrary(lib_path, time.perf_counter() - t0, log)
    return _loaded
