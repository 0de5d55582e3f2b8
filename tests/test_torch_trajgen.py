"""The port's min-snap trajectory generator against the JAX package's: the
same C++ source built with the same g++ flags gives bitwise-equal samples
and total times (on one host); the port builds its own library into its
own build directory and never names the JAX package's."""

import pathlib

import numpy as np
import pytest

from ipp_rl_tpu.trajgen import MavTrajectoryGenerator as JaxGenerator
from ipp_rl_tpu_torch.trajgen import MavTrajectoryGenerator, build_library
from ipp_rl_tpu_torch.trajgen import planner

from test_trajgen import WAYPOINTS

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _random_lists():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(8):
        n = int(rng.integers(2, 8))
        out.append(rng.uniform([0.0, 0.0, 8.0], [40.0, 40.0, 14.0], (n, 3)))
    return out


CASES = (
    [("waypoints", WAYPOINTS, 0.5), ("waypoints_fine", WAYPOINTS, 0.02),
     ("two_waypoints", WAYPOINTS[:2], 0.5), ("single_waypoint", WAYPOINTS[:1], 0.5)]
    + [(f"random_{i}", w, 0.3) for i, w in enumerate(_random_lists())]
)


@pytest.fixture(scope="module")
def generators():
    return MavTrajectoryGenerator(2.0, 2.0), JaxGenerator(2.0, 2.0)


@pytest.mark.parametrize("name,waypoints,dt", CASES, ids=[c[0] for c in CASES])
def test_samples_bitwise_equal_to_jax(generators, name, waypoints, dt):
    port, jax_gen = generators
    got = port.plan_uav_trajectory(waypoints, sampling_time=dt)
    want = jax_gen.plan_uav_trajectory(waypoints, sampling_time=dt)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert port.total_flight_time(waypoints) == jax_gen.total_flight_time(waypoints)
    if len(waypoints) >= 2:
        np.testing.assert_allclose(got[0], waypoints[0], atol=1e-6)


def test_library_is_built_in_the_ports_build_directory():
    path = pathlib.Path(build_library())
    assert path.parent == ROOT / "ipp_rl_tpu_torch" / "_build"
    assert path.name.startswith("libminsnap-") and path.exists()
    assert planner.SOURCE == ROOT / "ipp_rl_tpu_torch" / "trajgen" / "min_snap.cpp"
    assert planner.SOURCE.read_bytes() == (ROOT / "ipp_rl_tpu" / "trajgen" / "min_snap.cpp").read_bytes()
    offenders = [str(p) for p in (ROOT / "ipp_rl_tpu_torch").rglob("*.py")
                 if "ipp_rl_tpu/trajgen" in p.read_text() or "libminsnap.so" in p.read_text()]
    assert offenders == []


def test_bad_waypoints_raise(generators):
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        generators[0].plan_uav_trajectory(np.zeros((3, 2)))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No g++, no library: the build raises, with no fallback."""
    monkeypatch.setattr(planner, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(planner.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build_library(force=True)
