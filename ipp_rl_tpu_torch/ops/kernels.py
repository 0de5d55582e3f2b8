"""Wrappers of the hand-written CUDA kernels in ``csrc/smallchol.cu`` and
``csrc/sweep_taps.cu``.

``spd_inverse``, ``spd_inverse_factor``, ``spd_trace_product_packed``,
``edge_factor_gain`` and ``sweep_tap_blocks`` take CPU tensors to their
plain PyTorch versions (ops/smallchol.py) and
CUDA tensors to the kernels at any M >= 1,
with no fallback: a CUDA tensor the kernel cannot take raises.  Each
launch runs under its inputs' device, on that device's current stream.
Where the kernels' route for M >= 33 needs global memory (a workspace past
a CTA's shared memory, and ``edge_factor_gain``'s factor and squares
between its three device kernels, and its factor between its two at M =
13..32), the wrapper allocates it with
``torch.empty`` on the inputs' device (the caching allocator's, on that
stream).  Each
counts its launches on the tracer's counter ``kernel.<name>``
(utils/tracing.py), where it launches its kernel and nowhere else, so a run
can show that its path went through the kernels (``launch_counts``).

The library is built at first use from the repository's sources with
``nvcc`` into ``_build/`` beside the package (a content-addressed file
name, so an edited source is rebuilt): ``smallchol.cu`` in PARTS parts and
``sweep_taps.cu`` whole, compiled at once and linked, and loaded with
``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

import torch

from ipp_rl_tpu_torch.ops import smallchol
from ipp_rl_tpu_torch.utils import tracing

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "smallchol.cu"
#: the sweep's dense group from H's taps, compiled beside SOURCE's parts
TAPS_SOURCE = PACKAGE_DIR / "csrc" / "sweep_taps.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no multiply-add contraction: the kernels round like the plain versions
    "-fmad=false",
    "-Xptxas", "-v",
    # optimise each part's kernels in parallel, on every core
    "--split-compile=0",
    "-Xcompiler", "-fPIC",
)
#: the source is compiled as this many parts at once (-DSMALLCHOL_PART=0 ..
#: PARTS - 1: part 0 every kernel not unrolled for each M and the C
#: interface, parts 1-6 K1's and K2's unrolled kernels for their ranges of
#: M = 13..32, parts 7-12 K3's and the edge update's, parts 13-14 the
#: register route's for M = 1..12), then linked: the compiler works through
#: one part's kernels one after another
PARTS = 15
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
#: ``sweep_tap_blocks`` stages one mission's (N, N) block in a CTA's shared
#: memory: an H100 CTA takes at most this many bytes of it
TAPS_SHARED_BYTES = 227 * 1024
#: and sums at most TAPS_MAX² terms an entry (a row's nonzeros, padded)
TAPS_MAX = 8

_lib: Optional[ctypes.CDLL] = None
#: the library's kernel kinds, for ``smallchol_workspace_bytes``
_INVERSE, _INVERSE_FACTOR, _TRACE, _EDGE = range(4)
#: seconds the last build took (0.0 when a built library was reused), and
#: when each part's compile ended, from the build's start
build_seconds = 0.0
part_seconds: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> pathlib.Path:
    flags = " ".join(NVCC_FLAGS) + f" parts={PARTS}"
    digest = hashlib.sha1(SOURCE.read_bytes() + TAPS_SOURCE.read_bytes()
                          + flags.encode()).hexdigest()
    return BUILD_DIR / f"libsmallchol-{digest[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernel library unless this source's build exists: the
    PARTS parts and TAPS_SOURCE at once, then one link.  The compiler's
    report (registers, spills) lands next to it as ``.log``."""
    global build_seconds, part_seconds
    path = library_path()
    if path.exists():
        build_seconds, part_seconds = 0.0, []
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = path.with_name(f"{path.stem}.{os.getpid()}")
    jobs = [(f"-DSMALLCHOL_PART={p}", SOURCE) for p in range(PARTS)] + [(None, TAPS_SOURCE)]
    objs = [stem.with_name(f"{stem.name}.part{p}.o") for p in range(len(jobs))]
    logs = [o.with_suffix(".txt") for o in objs]
    tmp = stem.with_name(f"{stem.name}.tmp.so")
    t0 = time.perf_counter()
    procs = []
    for (define, source), obj, log in zip(jobs, objs, logs):
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", *([define] if define else []), "-o", str(obj),
               str(source)]
        with open(log, "w") as out:  # a file, not a pipe: no part waits on a reader
            procs.append((cmd, subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)))
    ended = {}
    while len(ended) < len(procs):
        for part, (_, proc) in enumerate(procs):
            if part not in ended and proc.poll() is not None:
                ended[part] = time.perf_counter() - t0
        time.sleep(0.05)
    part_seconds = [ended[part] for part in range(len(procs))]
    codes = [(cmd, proc.returncode) for cmd, proc in procs]
    failed = [(cmd, rc) for cmd, rc in codes if rc != 0]
    report = "".join(log.read_text() for log in logs)
    if not failed:
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        report += link.stdout + link.stderr
        if link.returncode != 0:
            failed = [(cmd, link.returncode)]
    build_seconds = time.perf_counter() - t0
    path.with_suffix(".log").write_text(report)
    for f in objs + logs:
        f.unlink(missing_ok=True)
    if failed:
        cmd, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{report[-4000:]}")
    os.replace(tmp, path)  # atomic: a concurrent builder sees a whole file
    return path


def _load() -> ctypes.CDLL:
    """Build if needed, load and bind the library; the handle is kept, so
    the wrappers' hot path is one global read."""
    global _lib
    major, minor = torch.cuda.get_device_capability()
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); this card is sm_{major}{minor}"
        )
    lib = ctypes.CDLL(str(build()))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.smallchol_spd_inverse.argtypes = [vp, vp, ll, i, i, vp, vp]
    lib.smallchol_spd_inverse.restype = i
    lib.smallchol_spd_inverse_factor.argtypes = [vp, vp, vp, ll, i, i, vp, vp]
    lib.smallchol_spd_inverse_factor.restype = i
    lib.smallchol_spd_trace_product.argtypes = [vp, vp, vp, ll, ll, i, i, vp, vp]
    lib.smallchol_spd_trace_product.restype = i
    lib.smallchol_edge_factor_gain.argtypes = [
        vp, vp, vp, vp, vp, ll, vp, vp, ll, i, i, i, i, vp, vp]
    lib.smallchol_edge_factor_gain.restype = i
    lib.smallchol_workspace_bytes.argtypes = [i, i, i, ll, i]
    lib.smallchol_workspace_bytes.restype = ll
    lib.smallchol_set_cta_shared_limit.argtypes = [i]
    lib.smallchol_set_cta_shared_limit.restype = i
    lib.smallchol_set_warp_route.argtypes = [i]
    lib.smallchol_set_warp_route.restype = i
    lib.smallchol_error_string.argtypes = [i]
    lib.smallchol_error_string.restype = ctypes.c_char_p
    lib.sweep_taps_blocks.argtypes = [
        vp, vp, i, i, vp, vp, vp, ctypes.c_double, vp, vp, ll, i, i, i, i, i, vp]
    lib.sweep_taps_blocks.restype = i
    _lib = lib  # last: a concurrent first call at worst loads the file twice
    return lib


def _check(name: str, S: torch.Tensor, G: Optional[torch.Tensor] = None) -> int:
    """Validate CUDA inputs; return the dtype code."""
    for t in (S,) if G is None else (S, G):
        if not t.is_cuda:
            raise ValueError(f"{name}: all inputs must be CUDA tensors")
        if t.shape != S.shape or t.dtype != S.dtype or t.device != S.device:
            raise ValueError(f"{name}: inputs differ in shape, dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    code = _DTYPE_CODES.get(S.dtype)
    if code is None:
        raise TypeError(f"{name}: float32 or float64 only, got {S.dtype}")
    return code


def _check_m(name: str, M: int) -> None:
    if M < 1:
        raise ValueError(f"{name}: M = {M}, expected M >= 1")


def _workspace(lib, kind: int, M: int, n_cells: int, count: int, code: int,
               device: torch.device) -> Optional[torch.Tensor]:
    """The global-memory workspace the library asks for this launch (the
    M >= 33 route's past a CTA's shared memory, ``edge_factor_gain``'s
    factor between its device kernels, and on the M >= 33 route its
    squares), else None."""
    nbytes = lib.smallchol_workspace_bytes(kind, M, n_cells, count, code)
    return torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes > 0 else None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


_LIBRARY_CODES = {-1: "unsupported M, dtype or size", -2: "workspace missing"}


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        msg = _lib.smallchol_error_string(err).decode() if err > 0 else _LIBRARY_CODES[err]
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


@contextlib.contextmanager
def cta_workspace_in_global_memory():
    """Within the block, the M >= 33 route keeps every workspace in global
    memory, as it does where a CTA's shared memory cannot hold it: the card
    tests drive that path with M's whose workspace would fit."""
    lib = _lib or _load()
    previous = lib.smallchol_set_cta_shared_limit(0)
    try:
        yield
    finally:
        lib.smallchol_set_cta_shared_limit(previous)


#: the kinds of kernel that ``warp_route`` can force at M = 13..32
WARP_ROUTES = {"runtime_m": 1, "unrolled": 2}


@contextlib.contextmanager
def warp_route(kind: str):
    """Within the block, ``spd_inverse`` and ``spd_trace_product`` take one
    kind of kernel at every M = 13..32: "runtime_m" (one warp per matrix or
    block, M an argument, the factors in shared memory) or "unrolled" (M a
    template parameter: a warp per matrix with its factors' rows in
    registers for ``spd_inverse``, a lane per block for the trace product).
    By default each M and dtype takes the kind that ran faster there on
    the H100 (scripts/time_torch_warp_route.py); the card tests hold both
    kinds against the plain versions, and chip_smoke.py times one against
    the other.  ``spd_inverse_factor`` and ``edge_factor_gain`` have the
    unrolled kind only, whatever is forced."""
    lib = _lib or _load()
    previous = lib.smallchol_set_warp_route(WARP_ROUTES[kind])
    try:
        yield
    finally:
        lib.smallchol_set_warp_route(previous)


def spd_inverse(S: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., M, M) SPD matrices (pivots clamped at 1e-30)."""
    if S.device.type == "cpu":
        return smallchol.spd_inverse(S)
    if S.ndim < 2 or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"spd_inverse: expected (..., M, M), got {tuple(S.shape)}")
    code = _check("spd_inverse", S)
    M = S.shape[-1]
    _check_m("spd_inverse", M)
    out = torch.empty_like(S)
    n = S.numel() // (M * M)
    if n:
        with torch.cuda.device(S.device):
            lib = _lib or _load()
            ws = _workspace(lib, _INVERSE, M, 0, n, code, S.device)
            err = lib.smallchol_spd_inverse(
                S.data_ptr(), out.data_ptr(), n, M, code, _ptr(ws),
                torch.cuda.current_stream(S.device).cuda_stream,
            )
        _raise_on("spd_inverse", err)
        tracing.count("kernel.spd_inverse")
    return out


def spd_inverse_factor(S: torch.Tensor) -> tuple:
    """(S⁻¹, U) for (..., M, M) SPD matrices, U the lower Cholesky factor
    of S⁻¹ (ops/smallchol.spd_inverse_factor): one launch for both."""
    if S.device.type == "cpu":
        return smallchol.spd_inverse_factor(S)
    if S.ndim < 2 or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"spd_inverse_factor: expected (..., M, M), got {tuple(S.shape)}")
    code = _check("spd_inverse_factor", S)
    M = S.shape[-1]
    _check_m("spd_inverse_factor", M)
    inv, chol = torch.empty_like(S), torch.empty_like(S)
    n = S.numel() // (M * M)
    if n:
        with torch.cuda.device(S.device):
            lib = _lib or _load()
            ws = _workspace(lib, _INVERSE_FACTOR, M, 0, n, code, S.device)
            err = lib.smallchol_spd_inverse_factor(
                S.data_ptr(), inv.data_ptr(), chol.data_ptr(), n, M, code, _ptr(ws),
                torch.cuda.current_stream(S.device).cuda_stream,
            )
        _raise_on("spd_inverse_factor", err)
        tracing.count("kernel.spd_inverse_factor")
    return inv, chol


def spd_trace_product_packed(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """tr(S⁻¹G) for SPD S and symmetric G given as packed lower triangles,
    entries-major: (outer, T, inner) → (outer, inner), T = M(M+1)/2
    (ops/smallchol.spd_trace_product_packed)."""
    if S.device.type == "cpu" and G.device.type == "cpu":
        return smallchol.spd_trace_product_packed(S, G)
    if S.ndim != 3:
        raise ValueError(f"spd_trace_product: expected (outer, T, inner), got {tuple(S.shape)}")
    code = _check("spd_trace_product", S, G)
    outer, T, inner = S.shape
    M = smallchol.packed_m(T)
    _check_m("spd_trace_product", M)
    out = torch.empty((outer, inner), dtype=S.dtype, device=S.device)
    if out.numel():
        with torch.cuda.device(S.device):
            lib = _lib or _load()
            ws = _workspace(lib, _TRACE, M, 0, outer * inner, code, S.device)
            err = lib.smallchol_spd_trace_product(
                S.data_ptr(), G.data_ptr(), out.data_ptr(), outer, inner, M, code, _ptr(ws),
                torch.cuda.current_stream(S.device).cuda_stream,
            )
        _raise_on("spd_trace_product", err)
        tracing.count("kernel.spd_trace_product")
    return out


def edge_factor_gain(
    S_raw: torch.Tensor,
    A: torch.Tensor,
    R_table: torch.Tensor,
    a: torch.Tensor,
    diag_mask: Optional[torch.Tensor] = None,
    round_bf16: bool = False,
) -> tuple:
    """(Wcᵀ (B, M, N), gain (B,)) of the search's edge update from S_raw
    (B, M, M), A (B, M, N), the R table (num_actions, M), the actions a
    (B,) int64 and a mask (N,) or (B, N) or None
    (ops/smallchol.edge_factor_gain): one launch (at M >= 33 three device
    kernels on one stream: factor, Uᵀ·A, gain; at M = 13..32 two: factor,
    Uᵀ·A and the gain)."""
    inputs = [S_raw, A, R_table, a] + ([] if diag_mask is None else [diag_mask])
    if all(t.device.type == "cpu" for t in inputs):
        return smallchol.edge_factor_gain(S_raw, A, R_table, a, diag_mask, round_bf16)
    name = "edge_factor_gain"
    if A.ndim != 3:
        raise ValueError(f"{name}: expected A (B, M, N), got {tuple(A.shape)}")
    B, M, N = A.shape
    shapes_ok = (
        S_raw.shape == (B, M, M) and R_table.ndim == 2 and R_table.shape[1] == M
        and a.shape == (B,)
        and (diag_mask is None or diag_mask.shape in ((N,), (B, N)))
    )
    if not shapes_ok:
        raise ValueError(f"{name}: shapes do not fit A {tuple(A.shape)}")
    for t in inputs:
        if not t.is_cuda or t.device != A.device:
            raise ValueError(f"{name}: all inputs must be CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if a.dtype != torch.int64:
        raise TypeError(f"{name}: the actions must be int64, got {a.dtype}")
    if any(t.dtype != A.dtype for t in inputs if t is not a):
        raise TypeError(f"{name}: S_raw, A, R_table and the mask differ in dtype")
    code = _DTYPE_CODES.get(A.dtype)
    if code is None:
        raise TypeError(f"{name}: float32 or float64 only, got {A.dtype}")
    _check_m(name, M)
    WcT = torch.empty_like(A)
    gain = torch.empty((B,), dtype=A.dtype, device=A.device)
    if B:
        mask_stride = 0 if diag_mask is None or diag_mask.ndim == 1 else N
        with torch.cuda.device(A.device):
            lib = _lib or _load()
            ws = _workspace(lib, _EDGE, M, N, B, code, A.device)
            err = lib.smallchol_edge_factor_gain(
                S_raw.data_ptr(), A.data_ptr(), R_table.data_ptr(), a.data_ptr(),
                _ptr(diag_mask), mask_stride,
                WcT.data_ptr(), gain.data_ptr(), B, M, N, int(round_bf16), code, _ptr(ws),
                torch.cuda.current_stream(A.device).cuda_stream,
            )
        _raise_on(name, err)
        tracing.count("kernel.edge_factor_gain")
    return WcT, gain


def sweep_taps_fit(N: int, dtype: torch.dtype, taps: int) -> bool:
    """Whether ``sweep_tap_blocks`` takes a plan of N cells whose rows have
    at most ``taps`` nonzeros, in the accumulation dtype: one mission's
    (N, N) block fits a CTA's shared memory and an entry sums few terms."""
    return N * N * torch.finfo(dtype).bits // 8 <= TAPS_SHARED_BYTES and 1 <= taps <= TAPS_MAX


def sweep_tap_blocks(
    P: torch.Tensor,
    Q: torch.Tensor,
    cells: torch.Tensor,
    weights: torch.Tensor,
    R: torch.Tensor,
    jitter: float = 0.0,
    round_p: bool = False,
) -> tuple:
    """The sweep's dense group, (S, G) packed blocks (B, T, Ag), from P
    (B, N, N), Q (B, N, N) in P's dtype or bfloat16, the rows' taps
    ``cells`` (Mg, KT, Ag) int32 and ``weights`` (Mg, KT, Ag), and the
    packed diagonals R (T, Ag) (ops/smallchol.sweep_tap_blocks): one
    launch for both."""
    inputs = (P, Q, cells, weights, R)
    if all(t.device.type == "cpu" for t in inputs):
        return smallchol.sweep_tap_blocks(P, Q, cells, weights, R, jitter, round_p)
    name = "sweep_tap_blocks"
    if P.ndim != 3 or P.shape[1] != P.shape[2]:
        raise ValueError(f"{name}: expected P (B, N, N), got {tuple(P.shape)}")
    B, N, _ = P.shape
    if cells.ndim != 3:
        raise ValueError(f"{name}: expected cells (Mg, KT, Ag), got {tuple(cells.shape)}")
    Mg, KT, Ag = cells.shape
    T = smallchol.packed_size(Mg)
    shapes_ok = Q.shape == P.shape and weights.shape == cells.shape and R.shape == (T, Ag)
    if not shapes_ok:
        raise ValueError(f"{name}: shapes do not fit P {tuple(P.shape)}, cells "
                         f"{tuple(cells.shape)}")
    for t in inputs:
        if not t.is_cuda or t.device != P.device:
            raise ValueError(f"{name}: all inputs must be CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    code = _DTYPE_CODES.get(P.dtype)
    if code is None:
        raise TypeError(f"{name}: float32 or float64 only, got {P.dtype}")
    if Q.dtype not in (P.dtype, torch.bfloat16):
        raise TypeError(f"{name}: Q must be in P's dtype or bfloat16, got {Q.dtype}")
    if weights.dtype != P.dtype or R.dtype != P.dtype:
        raise TypeError(f"{name}: the weights and R must be in P's dtype")
    if cells.dtype != torch.int32:
        raise TypeError(f"{name}: the cells must be int32")
    S = torch.empty((B, T, Ag), dtype=P.dtype, device=P.device)
    G = torch.empty_like(S)
    if S.numel():
        with torch.cuda.device(P.device):
            lib = _lib or _load()
            err = lib.sweep_taps_blocks(
                P.data_ptr(), Q.data_ptr(), int(Q.dtype == torch.bfloat16), int(round_p),
                cells.data_ptr(), weights.data_ptr(), R.data_ptr(),
                float(jitter), S.data_ptr(), G.data_ptr(), B, N, Ag, Mg, KT, code,
                torch.cuda.current_stream(P.device).cuda_stream,
            )
        _raise_on(name, err)
        tracing.count("kernel.sweep_tap_blocks")
    return S, G


#: the wrappers by the names ``launch_counts`` gives them
KERNELS = ("spd_inverse", "spd_inverse_factor", "spd_trace_product", "edge_factor_gain",
           "sweep_tap_blocks")


def reset_launch_counts() -> None:
    tracing.reset(counters="kernel.")


def launch_counts() -> dict:
    """Each kernel's launches since the last reset, by kernel name."""
    launched = tracing.counts("kernel.")
    return {name: launched.get(f"kernel.{name}", 0) for name in KERNELS}
