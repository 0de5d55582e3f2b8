"""Wrappers of the hand-written CUDA kernels in ``csrc/smallchol.cu``.

``spd_inverse`` and ``spd_trace_product`` take CPU tensors to their plain
PyTorch versions (ops/smallchol.py) and CUDA tensors to the kernels, with
no fallback: a CUDA tensor the kernel cannot take raises.  Each wrapper
carries a plain integer ``launches`` that it increments where it launches
its kernel and nowhere else, so a run can show that its path went through
the kernels.

The library is built at first use from the repository's source with
``nvcc`` into ``_build/`` beside the package (a content-addressed file
name, so an edited source is rebuilt), and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from ipp_rl_tpu_torch.ops import smallchol

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "smallchol.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no multiply-add contraction: the kernels round like the plain versions
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when a built library was reused)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> pathlib.Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsmallchol-{digest[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernel library unless this source's build exists.
    The compiler's report (registers, spills) lands next to it as ``.log``."""
    global build_seconds
    path = library_path()
    if path.exists():
        build_seconds = 0.0
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, path)  # atomic: a concurrent builder sees a whole file
    return path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            major, minor = torch.cuda.get_device_capability()
            if (major, minor) != (9, 0):
                raise RuntimeError(
                    f"the kernels are built for sm_90a (Hopper); this card is sm_{major}{minor}"
                )
            lib = ctypes.CDLL(str(build()))
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.smallchol_spd_inverse.argtypes = [vp, vp, ll, i, i, vp]
            lib.smallchol_spd_inverse.restype = i
            lib.smallchol_spd_trace_product.argtypes = [vp, vp, vp, ll, i, i, vp]
            lib.smallchol_spd_trace_product.restype = i
            lib.smallchol_max_m.argtypes = []
            lib.smallchol_max_m.restype = i
            lib.smallchol_error_string.argtypes = [i]
            lib.smallchol_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_blocks(name: str, *tensors: torch.Tensor) -> tuple:
    """Validate (..., M, M) CUDA inputs; return (n blocks, M, dtype code)."""
    first = tensors[0]
    if first.ndim < 2 or first.shape[-1] != first.shape[-2]:
        raise ValueError(f"{name}: expected (..., M, M), got {tuple(first.shape)}")
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be CUDA tensors")
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name}: inputs differ in shape, dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: float32 or float64 only, got {first.dtype}")
    M = first.shape[-1]
    lib = _library()
    if not 1 <= M <= lib.smallchol_max_m():
        raise ValueError(f"{name}: M = {M} is outside 1..{lib.smallchol_max_m()}")
    return first.numel() // (M * M), M, _DTYPE_CODES[first.dtype]


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        msg = _library().smallchol_error_string(err).decode() if err > 0 else "unsupported"
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def spd_inverse(S: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., M, M) SPD matrices (pivots clamped at 1e-30)."""
    if S.device.type == "cpu":
        return smallchol.spd_inverse(S)
    n, M, code = _check_blocks("spd_inverse", S)
    out = torch.empty_like(S)
    if n:
        err = _library().smallchol_spd_inverse(
            S.data_ptr(), out.data_ptr(), n, M, code, _stream()
        )
        _raise_on("spd_inverse", err)
        spd_inverse.launches += 1
    return out


spd_inverse.launches = 0


def spd_trace_product(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """tr(S⁻¹G) for SPD S and symmetric G, (..., M, M) → (...); only the
    lower triangles are read."""
    if S.device.type == "cpu" and G.device.type == "cpu":
        return smallchol.spd_trace_product(S, G)
    n, M, code = _check_blocks("spd_trace_product", S, G)
    out = torch.empty(S.shape[:-2], dtype=S.dtype, device=S.device)
    if n:
        err = _library().smallchol_spd_trace_product(
            S.data_ptr(), G.data_ptr(), out.data_ptr(), n, M, code, _stream()
        )
        _raise_on("spd_trace_product", err)
        spd_trace_product.launches += 1
    return out


spd_trace_product.launches = 0


def reset_launch_counts() -> None:
    spd_inverse.launches = 0
    spd_trace_product.launches = 0
