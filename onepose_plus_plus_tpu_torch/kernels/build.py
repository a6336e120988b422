"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources under ``csrc/`` export a plain C interface (pointers, ints and a
stream; each function returns ``cudaGetLastError()`` after its launches), so
they compile in seconds without PyTorch's headers. Each source compiles in its
own ``nvcc`` process, all started together, and one more links them. The
shared library goes to
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
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# exported C functions: name -> argument types (all return int but those in _RESTYPES)
_SIGNATURES = {
    "opp_encoder_layer_tc": [_P] * 13 + [_I] * 3 + [_P],
    "opp_encoder_tc_source_tiles": [_I],
    "opp_encoder_layer_tcw": [_P] * 12 + [_I] * 5 + [_P],
    "opp_encoder_tcw_scratch_bytes": [_I] * 6,
    "opp_encoder_layer_tcw_tf32": [_P] * 12 + [_I] * 5 + [_P],
    "opp_encoder_tcw_tf32_scratch_bytes": [_I] * 6,
    "opp_rowcol_stats_bf16": [_P] * 12 + [_I] * 4 + [_F, _P],
    "opp_rowcol_stats_tf32x3": [_P] * 12 + [_I] * 4 + [_F, _P],
    "opp_rowcol_stats_wide_bf16": [_P] * 12 + [_I] * 4 + [_F, _P],
    "opp_rowcol_stats_wide_tf32x3": [_P] * 12 + [_I] * 4 + [_F, _P],
    "opp_rowcol_row_tiles": [_I],
    "opp_pack_operand_f32": [_P] * 2 + [_I] * 3 + [_F, _P],
    "opp_pack_operand_bf16": [_P] * 2 + [_I] * 3 + [_F, _P],
    "opp_pack_tf32_operand_f32": [_P] * 2 + [_I] * 4 + [_F, _P],
    "opp_pack_wide_f32": [_P] * 2 + [_I] * 4 + [_F, _P],
    "opp_pack_wide_bf16": [_P] * 2 + [_I] * 4 + [_F, _P],
    "opp_pack_wide_tf32_hilo_f32": [_P] * 2 + [_I] * 3 + [_F, _P],
    "opp_window_gather": [_P] * 3 + [_I] * 9 + [_P],
    "opp_window_span": [_P] * 3 + [_I] * 9 + [_P],
    "opp_dual_lse_bf16": [_P] * 7 + [_I] * 4 + [_F, _P],
    "opp_dual_lse_wide_bf16": [_P] * 7 + [_I] * 4 + [_F, _P],
    "opp_window_scatter_index": [_P] * 3 + [_I] * 3 + [_P],
    "opp_window_scatter_f32": [_P] * 5 + [_I] * 9 + [_P],
    "opp_window_scatter_bf16": [_P] * 5 + [_I] * 9 + [_P],
    "opp_coarse_loss_fwd": [_P] * 8 + [_I] * 4 + [_F] * 3 + [_P],
    "opp_coarse_loss_bwd": [_P] * 11 + [_I] * 4 + [_F] * 4 + [_P],
    "opp_coarse_loss_fwd_wide": [_P] * 8 + [_I] * 4 + [_F] * 3 + [_P],
    "opp_coarse_loss_bwd_wide": [_P] * 11 + [_I] * 4 + [_F] * 4 + [_P],
    "opp_coarse_loss_cluster_size": [_I],
    "opp_coarse_loss_row_tiles": [_I],
    "opp_patch_gather_i32": [_P] * 4 + [_L] * 4 + [_I] * 7 + [_P],
    "opp_patch_gather_i64": [_P] * 4 + [_L] * 4 + [_I] * 7 + [_P],
    "opp_short_encoder_f32": [_P] * 13 + [_I] * 5 + [_P],
    "opp_short_encoder_bf16": [_P] * 13 + [_I] * 5 + [_P],
    "opp_short_encoder_smem_bytes": [_I] * 4,
    "opp_short_encoder_tc": [_P] * 8 + [_I] * 5 + [_P],
}

_RESTYPES = {"opp_encoder_tcw_scratch_bytes": ctypes.c_longlong,
             "opp_encoder_tcw_tf32_scratch_bytes": ctypes.c_longlong}


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
            fn.restype = _RESTYPES.get(name, ctypes.c_int)

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


def _compile(lib_path: Path, verbose: bool) -> str:
    """One nvcc per source, all started together, then one link; returns the log."""
    cus, _ = _sources()
    nvcc = _nvcc()
    tmp_dir = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.objs")
    tmp_dir.mkdir(exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for cu in cus:
        obj = tmp_dir / f"{cu.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(cu)]
        procs.append((cu, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for cu, _, proc in procs:
        out, _ = proc.communicate()
        log += f"--- {cu.name}\n{out}"
        if proc.returncode != 0:
            failed.append(cu.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in procs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return log


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
        log = _compile(lib_path, verbose)
    _loaded = KernelLibrary(lib_path, time.perf_counter() - t0, log)
    return _loaded
