"""The port's multi-device path (parallel/) on four CPU ranks over gloo,
float64 throughout, held against the JAX package's DENSE functions, as the
JAX package's own tests hold its sharded ones (tests/test_sharded.py; its
sharded functions take ~50 s per call on a 4-device CPU mesh, so tier-1
calls none of them):

  * ``sharded_kf_update`` with and without z against JAX's ``kf_update``
    on tests/test_sharded.py's problem (atol 1e-10, as there), and P'
    exactly symmetric after the all_to_all symmetrisation;
  * ``sharded_sweep_gains`` against JAX's ``kf_sweep_gains`` (rtol 1e-10);
  * ``sharded_greedy_mission`` at mp = 4 against the port's
    ``dense_greedy_mission`` and both against JAX's, on the 20×20 config
    of tests/test_sharded.py with JAX's ground truth and ``fold_in``
    noise for 4 steps: identical actions, cov and mean within atol 1e-8;
  * ``shard_batch`` / ``gather_batch`` at dp = 2: a greedy mission batch
    split over two ranks equals the unsplit run.

One spawn of four ranks serves the whole file (rendezvous through a file
store, so parallel test workers race for no port).  Each rank runs this
file as a script, which imports torch and the port only, never JAX."""

import datetime
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
STEPS = 4
SPAWN_TIMEOUT_S = 240
# tests/test_sharded.py:198-229
LARGE_GRID_RAW = {
    "environment": {"x_dim": 20, "y_dim": 20, "resolution": 4},
    "sensor": {
        "type": "rgb_camera",
        "field_of_view": {"angle_x": 60, "angle_y": 60},
        "model": {"type": "altitude_dependent", "coeff_a": 0.05, "coeff_b": 0.2},
        "simulation": {"type": "gaussian_random_field", "cluster_radius": 5},
    },
    "mapping": {"fit_gaussian_process": True, "signal_variance": 1.82, "length_scale": 3.67,
                "noise_variance": 1.42, "nu": 1.5},
    "experiment": {
        "title": "large_grid",
        "constraints": {"dist_to_boundaries": 3, "min_altitude": 8, "max_altitude": 14,
                        "altitude_spacing": 6, "budget": 60},
        "scenario": {"adaptive": True, "value_threshold": 0.4, "interval_factor": 0},
        "uav": {"max_v": 2, "max_a": 2, "sampling_time": 2},
        "missions": [{"type": "greedy"}],
        "evaluation": {"repetitions": 1, "metrics": ["uncertainty"]},
    },
}


def kalman_problem():
    """tests/test_sharded.py:28-41 and the sweep's actions of :73-80."""
    rng = np.random.default_rng(0)
    n, m = 64, 8
    A_mat = rng.normal(size=(n, n))
    P = A_mat @ A_mat.T / n + 0.5 * np.eye(n)
    H = np.zeros((m, n))
    for i in range(m):
        H[i, rng.choice(n, 4, replace=False)] = 0.25
    R = rng.uniform(0.01, 0.1, m)
    mean = rng.uniform(0, 1, n)
    z = rng.uniform(0, 1, m)
    rng = np.random.default_rng(1)
    A = 16
    H_all = np.zeros((A, m, n))
    R_all = rng.uniform(0.01, 0.2, (A, m))
    for a in range(A):
        for i in range(m):
            H_all[a, i, rng.choice(n, 3, replace=False)] = 1 / 3
    return {"P": P, "H": H, "R": R, "mean": mean, "z": z, "H_all": H_all, "R_all": R_all}


# ------------------------------------------------------------ the ranks

def _rank_main(rank: int, workdir: pathlib.Path) -> None:
    """One rank's work; rank 0 writes every result to ``results.npz``."""
    import torch.distributed as dist

    from ipp_rl_tpu_torch.config import MissionConfig, config_from_dict
    from ipp_rl_tpu_torch.env.world import IPPWorld
    from ipp_rl_tpu_torch.parallel import gather_batch, make_mesh, shard_batch
    from ipp_rl_tpu_torch.parallel.large_grid import sharded_greedy_mission
    from ipp_rl_tpu_torch.parallel.sharded_kalman import (
        all_gather_rows,
        sharded_kf_update,
        sharded_sweep_gains,
    )
    from ipp_rl_tpu_torch.planners import GreedyPlanner

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=RANKS, timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        mesh = make_mesh(mp=RANKS, device="cpu")
        assert mesh.shape == (1, RANKS) and mesh.mesh_dim_names == ("dp", "mp")
        group, r = mesh.get_group("mp"), mesh.get_local_rank("mp")
        prob = {k: torch.as_tensor(v) for k, v in kalman_problem().items()}
        n_loc = prob["P"].shape[0] // RANKS
        rows = slice(r * n_loc, (r + 1) * n_loc)
        for tag, z in (("z", prob["z"]), ("cov_only", None)):
            mean, P = sharded_kf_update(mesh, prob["P"][rows], prob["mean"][rows], prob["H"],
                                        prob["R"], z)
            out[f"kf_{tag}_P"] = all_gather_rows(P, group, RANKS).numpy()
            out[f"kf_{tag}_mean"] = all_gather_rows(mean, group, RANKS).numpy()
        out["sweep"] = sharded_sweep_gains(mesh, prob["P"], prob["H_all"], prob["R_all"]).numpy()

        inputs = np.load(workdir / "inputs.npz")
        world = IPPWorld(config_from_dict(LARGE_GRID_RAW), dtype=torch.float64, device="cpu")
        mission = sharded_greedy_mission(mesh, world, STEPS,
                                         noise=torch.as_tensor(inputs["noise"]),
                                         ground_truth=torch.as_tensor(inputs["gt"]))
        out.update({f"grid_{k}": np.asarray(v) for k, v in mission.items()})

        # dp = 2: each half of a B = 4 greedy batch on its own dp row
        dmesh = make_mesh(dp=2, mp=2, device="cpu")
        small = config_from_dict(json.loads((workdir / "small.json").read_text()))
        sworld = IPPWorld(small, dtype=torch.float64, device="cpu")
        planner = GreedyPlanner(sworld, MissionConfig(type="greedy"))
        gen = torch.Generator().manual_seed(11)
        state0 = sworld.init_state(4, gen)
        noise = torch.randn((STEPS, 4, sworld.H.shape[1]), generator=gen, dtype=torch.float64)
        whole = planner.run(4, STEPS, init_state=state0, noise=noise)
        part = planner.run(2, STEPS, init_state=shard_batch(dmesh, state0),
                           noise=shard_batch(dmesh, noise.transpose(0, 1)).transpose(0, 1))
        joined = gather_batch(dmesh, {"state": part.final_state,
                                      "waypoints": torch.as_tensor(part.waypoints)})
        out["dp_whole_waypoints"] = whole.waypoints
        out["dp_whole_cov"] = whole.final_state.cov.numpy()
        out["dp_joined_waypoints"] = joined["waypoints"].numpy()
        out["dp_joined_cov"] = joined["state"].cov.numpy()
        out["dp_joined_active"] = joined["state"].active.numpy()
        out["dp_whole_active"] = whole.final_state.active.numpy()
        out["dp_part_rows"] = np.asarray([part.waypoints.shape[0]])
        if rank == 0:
            np.savez(workdir / "results.npz", **out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the test side

@pytest.fixture(scope="module")
def runs(tmp_path_factory, small_cfg):
    """Spawn the four ranks, and meanwhile compute the JAX side and the
    port's dense large-grid mission in this process."""
    import jax
    import jax.numpy as jnp

    from ipp_rl_tpu.config.schema import config_from_dict as jax_config_from_dict
    from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
    from ipp_rl_tpu.ops.kalman import kf_sweep_gains, kf_update
    from ipp_rl_tpu.parallel.large_grid import dense_greedy_mission as jax_dense
    from ipp_rl_tpu_torch.config import config_from_dict
    from ipp_rl_tpu_torch.env.world import IPPWorld
    from ipp_rl_tpu_torch.parallel.large_grid import dense_greedy_mission

    from test_torch_world import _as_raw

    workdir = tmp_path_factory.mktemp("sharded")
    jworld = JaxWorld(jax_config_from_dict(LARGE_GRID_RAW), dtype=jnp.float64)
    key = jax.random.key(3)
    gt = np.asarray(jworld.init_state(key, 1).ground_truth[0])
    M = jworld.H.shape[1]
    noise = np.stack([  # ipp_rl_tpu/parallel/large_grid.py:97-99 and env/world.py:264
        np.asarray(jax.random.normal(jax.random.split(jax.random.fold_in(key, s), 1)[0], (M,),
                                     jnp.float64)) for s in range(STEPS)])
    np.savez(workdir / "inputs.npz", gt=gt, noise=noise)
    (workdir / "small.json").write_text(json.dumps(_as_raw(small_cfg)))

    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(workdir)], cwd=ROOT, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(RANKS)]
    try:
        prob = kalman_problem()
        j = {k: jnp.asarray(v) for k, v in prob.items()}
        want = {
            "kf_z": kf_update(j["P"], j["mean"], j["H"], j["R"], j["z"]),
            "kf_cov_only": kf_update(j["P"], j["mean"], j["H"], j["R"], z=None),
            "sweep": kf_sweep_gains(j["P"], j["H_all"], j["R_all"]),
            "jax_grid": jax_dense(jworld, key, max_steps=STEPS),
        }
        world = IPPWorld(config_from_dict(LARGE_GRID_RAW), dtype=torch.float64, device="cpu")
        want["port_grid"] = dense_greedy_mission(world, STEPS, noise=torch.tensor(noise),
                                                 ground_truth=torch.tensor(gt))
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (workdir / f"rank{r}.log").read_text()[-4000:]
    got = dict(np.load(workdir / "results.npz"))
    return prob, want, got


@pytest.mark.parametrize("tag", ["z", "cov_only"])
def test_sharded_kf_update_matches_dense(runs, tag):
    prob, want, got = runs
    mean_ref, P_ref = (np.asarray(x) for x in want[f"kf_{tag}"])
    np.testing.assert_allclose(got[f"kf_{tag}_P"], P_ref, atol=1e-10)
    if tag == "z":
        np.testing.assert_allclose(got["kf_z_mean"], mean_ref, atol=1e-10)
    else:
        np.testing.assert_array_equal(got["kf_cov_only_mean"], prob["mean"])


@pytest.mark.parametrize("tag", ["z", "cov_only"])
def test_sharded_kf_update_is_exactly_symmetric(runs, tag):
    P = runs[2][f"kf_{tag}_P"]
    assert np.array_equal(P, P.T)


def test_sharded_sweep_matches_dense(runs):
    _, want, got = runs
    assert got["sweep"].shape == (16,)
    np.testing.assert_allclose(got["sweep"], np.asarray(want["sweep"]), rtol=1e-10)


def test_large_grid_sharded_mission_matches_dense(runs):
    """mp = 4 against the port's dense oracle and JAX's (JAX chose actions
    [442, 463, 506, 569] for key 3 on this config)."""
    _, want, got = runs
    port, jax_run = want["port_grid"], want["jax_grid"]
    assert len(got["grid_actions"]) == STEPS
    np.testing.assert_array_equal(got["grid_actions"], port["actions"])
    np.testing.assert_array_equal(port["actions"], jax_run["actions"])
    np.testing.assert_array_equal(jax_run["actions"], [442, 463, 506, 569])
    for name in ("final_cov", "final_mean"):
        np.testing.assert_allclose(got[f"grid_{name}"], port[name], atol=1e-8)
        np.testing.assert_allclose(port[name], jax_run[name], atol=1e-8)
    for name in ("uncertainty", "rmse"):
        np.testing.assert_allclose(got[f"grid_{name}"], jax_run[name], rtol=1e-10)
    assert got["grid_budget_left"] == pytest.approx(jax_run["budget_left"], rel=1e-12)
    assert got["grid_uncertainty"][-1] < got["grid_uncertainty"][0]


def test_dp_sharded_greedy_batch_equals_unsplit(runs):
    got = runs[2]
    assert got["dp_part_rows"][0] == 2
    np.testing.assert_array_equal(got["dp_joined_waypoints"], got["dp_whole_waypoints"])
    np.testing.assert_array_equal(got["dp_joined_active"], got["dp_whole_active"])
    np.testing.assert_allclose(got["dp_joined_cov"], got["dp_whole_cov"], atol=1e-12)


def test_initialize_multihost_single_process():
    """World size 1 on gloo (the CPU asked for): the (1, 1) mesh, make_mesh's
    checks, and the row-sharded commit on one rank against the dense one."""
    import torch.distributed as dist

    from ipp_rl_tpu_torch.ops.kalman import kf_update
    from ipp_rl_tpu_torch.parallel import initialize_multihost, make_mesh
    from ipp_rl_tpu_torch.parallel.sharded_kalman import sharded_kf_update

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(device="cpu")
    mesh = initialize_multihost(device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("dp", "mp")
        with pytest.raises(ValueError, match="mesh 2x1"):
            make_mesh(dp=2, device="cpu")
        prob = {k: torch.as_tensor(v) for k, v in kalman_problem().items()}
        args = (prob["P"], prob["mean"], prob["H"], prob["R"], prob["z"])
        mean, P = sharded_kf_update(mesh, *args)
        mean_ref, P_ref = kf_update(*args)
        torch.testing.assert_close(P, P_ref, atol=1e-10, rtol=0)
        torch.testing.assert_close(mean, mean_ref, atol=1e-10, rtol=0)
        assert torch.equal(P, P.mT)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
