"""ctypes binding for the native min-snap trajectory generator.

Port of the JAX package's ``trajgen/planner.py``, with the same API (reference
planning/trajectory_generation/mav_trajectory_generation.pyx:5-42):

    gen = MavTrajectoryGenerator(max_v, max_a)
    samples = gen.plan_uav_trajectory(waypoints, sampling_time)  # (K, 3)

The port keeps its own copy of ``min_snap.cpp`` (framework-free C++ with
a C ABI).  It is built at first use with g++ and the JAX package's flags
into the port's build directory (``_build/`` beside the package, under a
name that hashes the source and the flags, so an edited source is
rebuilt), never next to the source.  Without g++ the build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = pathlib.Path(__file__).resolve().with_name("min_snap.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_BUILD_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> pathlib.Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libminsnap-{digest[:16]}.so"


def build_library(force: bool = False) -> str:
    """Compile min_snap.cpp into the build directory unless this source's
    build exists (or ``force``); returns the library's path."""
    with _BUILD_LOCK:
        path = library_path()
        if path.exists() and not force:
            return str(path)
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: it is needed to build the trajectory generator")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        logger.info("building trajgen: %s", " ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, path)  # atomic: a concurrent builder sees a whole file
        return str(path)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    dp = ctypes.POINTER(ctypes.c_double)
    lib.trajgen_create.restype = ctypes.c_void_p
    lib.trajgen_create.argtypes = [ctypes.c_double, ctypes.c_double]
    lib.trajgen_destroy.restype = None
    lib.trajgen_destroy.argtypes = [ctypes.c_void_p]
    lib.trajgen_plan.restype = ctypes.c_int
    lib.trajgen_plan.argtypes = [ctypes.c_void_p, dp, ctypes.c_int, ctypes.c_double, dp,
                                 ctypes.c_int]
    lib.trajgen_total_time.restype = ctypes.c_double
    lib.trajgen_total_time.argtypes = [ctypes.c_void_p, dp, ctypes.c_int]
    _lib = lib
    return lib


def _waypoints(waypoints: np.ndarray) -> np.ndarray:
    wps = np.ascontiguousarray(waypoints, dtype=np.float64)
    if wps.ndim != 2 or wps.shape[1] != 3:
        raise ValueError(f"waypoints must be (N, 3), got {wps.shape}")
    return wps


class MavTrajectoryGenerator:
    """Min-snap polynomial trajectory through waypoints with velocity /
    acceleration limits, sampled at ``sampling_time`` intervals."""

    def __init__(self, max_v: float, max_a: float):
        self._lib = _load()
        self._planner = self._lib.trajgen_create(float(max_v), float(max_a))
        self.max_v = max_v
        self.max_a = max_a

    def __del__(self):
        planner = getattr(self, "_planner", None)
        if planner:
            self._lib.trajgen_destroy(planner)
            self._planner = None

    def total_flight_time(self, waypoints: np.ndarray) -> float:
        wps = _waypoints(waypoints)
        ptr = wps.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        return float(self._lib.trajgen_total_time(self._planner, ptr, len(wps)))

    def plan_uav_trajectory(self, waypoints: np.ndarray, sampling_time: float = 1.0) -> np.ndarray:
        """Returns the sampled (K, 3) xyz trajectory (reference
        mav_trajectory_generation.pyx:14-42); fewer than two waypoints are
        returned as they are."""
        wps = _waypoints(waypoints)
        if len(wps) < 2:
            return wps.copy()
        total = self.total_flight_time(wps)
        if total < 0:
            raise RuntimeError("trajectory planning failed")
        cap = (int(total / sampling_time) + 4) * 3
        out = np.zeros(cap, dtype=np.float64)
        n = self._lib.trajgen_plan(
            self._planner,
            wps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(wps),
            float(sampling_time),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap,
        )
        if n < 0:
            raise RuntimeError("trajectory planning failed")
        return out[: n * 3].reshape(n, 3)
