"""The quality-vs-runtime tool (ipp_rl_tpu_torch/tools/quality_vs_runtime.py)
against the JAX package's ``scripts/quality_vs_runtime.py``.

The committed worlds file (runs/quality_torch/worlds_s12345_b32.npz) must
equal the JAX package's ``IPPWorld(example.yaml, fast_sweeps=True)
.init_state(jax.random.key(12345), 32)``; on four of those worlds, in
float64 with the JAX run's measurement noise injected, the tool's greedy
row equals the JAX planner's built as the script builds it (rtol 1e-9);
the committed JAX reference (runs/quality_torch/jax_reference.json)
records the settings the card's quality phase (chip_smoke.py) holds the
port to.

Run as a script, the file writes those two files:

    python tests/test_torch_quality.py --write-reference

It runs the JAX planners (float32, the CPU) exactly as the JAX script
builds them, on the JAX script's worlds with run key 7, and records each
row's per-mission finals.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # the generator: the repository's packages from its root
    sys.path.insert(0, str(ROOT))
OUT_DIR = ROOT / "runs" / "quality_torch"
WORLDS = OUT_DIR / "worlds_s12345_b32.npz"
REFERENCE = OUT_DIR / "jax_reference.json"
FIELDS = ("mean", "cov", "pos", "budget", "ground_truth", "active", "step")


import pytest  # noqa: E402
import torch  # noqa: E402

from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config  # noqa: E402
from ipp_rl_tpu_torch.convert import noise_from_arrays  # noqa: E402
from ipp_rl_tpu_torch.env.world import IPPWorld  # noqa: E402
from ipp_rl_tpu_torch.tools import quality_vs_runtime as qvr  # noqa: E402

from test_torch_zero_search import one_thread  # noqa: F401,E402 (an autouse fixture)

CKPT = ROOT / qvr.REFERENCE_SETTINGS["ckpt"]


# ---------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def worlds():
    with np.load(WORLDS) as data:
        return {k: data[k] for k in data.files}


@contextlib.contextmanager
def jax_x32():
    """JAX in its default 32-bit mode, as the JAX script runs (the tests'
    conftest enables 64-bit types, which rounds the prior differently)."""
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def test_worlds_file_is_the_jax_scripts_worlds(worlds, canonical_cfg):
    """The committed worlds equal IPPWorld(example.yaml, fast_sweeps=True)
    .init_state(key(12345), 32) of the JAX package in 32-bit mode, bit for
    bit."""
    from ipp_rl_tpu.env.world import IPPWorld as JaxWorld

    with jax_x32():
        state = JaxWorld(canonical_cfg, fast_sweeps=True).init_state(jax.random.key(12345), 32)
        state = {f: np.asarray(getattr(state, f)) for f in FIELDS}
    assert sorted(worlds) == sorted(FIELDS)
    for f in FIELDS:
        want = state[f]
        assert worlds[f].dtype == want.dtype, f
        np.testing.assert_array_equal(worlds[f], want, err_msg=f)


def test_greedy_row_matches_the_jax_script(worlds, canonical_cfg):
    """Four of the committed worlds, float64 on both sides, the JAX run's
    measurement noise (run key 7) injected: the tool's greedy row equals
    the JAX script's greedy planner mission by mission (rtol 1e-9; the
    sweep in full precision on both sides, as bf16 streams agree only to
    their rounding)."""
    import jax.numpy as jnp

    from ipp_rl_tpu.config.schema import MissionConfig as JaxMissionConfig
    from ipp_rl_tpu.env.world import BeliefState as JaxBelief
    from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
    from ipp_rl_tpu.planners import GreedyPlanner as JaxGreedy

    from test_torch_greedy import jax_run_draws

    B, T = 4, qvr.REFERENCE_SETTINGS["max_steps"]
    jworld = JaxWorld(canonical_cfg, dtype=jnp.float64)
    jstate = JaxBelief(**{f: jnp.asarray(v[:B].astype(np.float64) if v.dtype == np.float32
                                         else v[:B]) for f, v in worlds.items()})
    key = jax.random.key(7)
    want = JaxGreedy(jworld, JaxMissionConfig(type="greedy")).run(key, B, max_steps=T,
                                                                  init_state=jstate)
    _, noise = jax_run_draws(jworld, key, B, T)

    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), dtype=torch.float64,
                     device="cpu")
    settings = qvr.Settings(max_steps=T, rows=["greedy"])
    init_state = qvr.load_worlds(str(WORLDS), world, B)
    (row,) = qvr.evaluate(world, settings, init_state,
                          noise=noise_from_arrays(noise, device="cpu", dtype=torch.float64),
                          log=None)
    assert row["planner"] == "greedy" and row["batch"] == B
    np.testing.assert_array_equal(row["result"].waypoints, np.asarray(want.waypoints))
    assert row["per_mission"]["steps"] == np.asarray(want.num_steps).tolist()
    for name in ("uncertainty", "rmse"):
        np.testing.assert_allclose(row["per_mission"][f"final_{name}"],
                                   np.asarray(want.metrics[name])[:, -1], rtol=1e-9)
    assert row["final_uncertainty"] == round(float(np.mean(want.metrics["uncertainty"][:, -1])),
                                             3)


def test_reference_holds_the_quality_phase_settings():
    """The committed JAX reference was made with the settings the card's
    quality phase runs (chip_smoke.py takes them from the tool), and holds
    each row's 32 per-mission finals."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["settings"] == qvr.REFERENCE_SETTINGS
    assert ref["made_with"]["dtype"] == "float32" and ref["made_with"]["platform"] == "cpu"
    assert [r["planner"] for r in ref["rows"]] == qvr.REFERENCE_SETTINGS["rows"]
    B = qvr.REFERENCE_SETTINGS["batch"]
    for r in ref["rows"]:
        per = r["per_mission"]
        assert len(per["final_uncertainty"]) == len(per["final_rmse"]) == len(per["steps"]) == B
        assert r["final_uncertainty"] == pytest.approx(np.mean(per["final_uncertainty"]))
        assert all(0 < u < 104.3 for u in per["final_uncertainty"])  # below the prior's
    settings = qvr.Settings.from_reference(ref["settings"], root=str(ROOT))
    assert qvr.row_names(settings) == qvr.REFERENCE_SETTINGS["rows"]
    assert settings.classic_sims == 8 and settings.seed == 7


def test_rows_follow_the_jax_script():
    assert qvr.row_names(qvr.Settings()) == [
        "zero_0sims", "zero_16sims", "zero_32sims", "zero_100sims", "zero_32sims_clean",
        "zero_100sims_clean", "greedy", "mcts_classic", "cmaes", "random"]
    with pytest.raises(ValueError):
        qvr.row_names(qvr.Settings(rows=["zero_7sims"]))


def test_worlds_from_ground_truth_alone(worlds, tmp_path):
    """A worlds file of ground truth alone gets the world's own priors."""
    path = tmp_path / "gt.npz"
    np.savez(path, ground_truth=worlds["ground_truth"][:3])
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), device="cpu")
    state = qvr.load_worlds(str(path), world, 2)
    want = world.init_state(2, ground_truth=torch.from_numpy(worlds["ground_truth"][:2]))
    for f in FIELDS:
        assert torch.equal(getattr(state, f), getattr(want, f)), f
    with pytest.raises(ValueError):
        qvr.load_worlds(str(path), world, 4)


def test_main_writes_the_curve_on_the_cpu(tmp_path):
    out = tmp_path / "curve"
    assert qvr.main(["--ckpt", str(CKPT), "--unfloored-value-head", "--batch", "2",
                     "--max-steps", "2", "--zero-sims", "0,2c",
                     "--rows", "zero_0sims,zero_2sims_clean,greedy,random",
                     "--worlds", str(WORLDS), "--device", "cpu", "--out", str(out)]) == 0
    curve = json.loads((out / "curve.json").read_text())
    assert curve["device"] == {"device": "cpu"}
    assert [r["planner"] for r in curve["rows"]] == [
        "zero_0sims", "zero_2sims_clean", "greedy", "random"]
    for r in curve["rows"]:
        assert set(qvr.JAX_ROW_KEYS) <= set(r)
        assert len(r["per_mission"]["final_uncertainty"]) == 2 and r["batch"] == 2
        assert r["mean_steps"] == 2.0
    assert "| greedy |" in (out / "curve.md").read_text()


# ---------------------------------------------------------------- generator

def _jax_planners(world, settings: dict):
    """The JAX planners of the reference's rows, built as
    scripts/quality_vs_runtime.py builds them (classic MCTS with the
    reference's simulation count)."""
    from ipp_rl_tpu.config.schema import MCTSZeroHyperParams, MissionConfig
    from ipp_rl_tpu.planners import (
        ClassicMCTSPlanner,
        CMAESPlanner,
        GreedyPlanner,
        RandomDiscretePlanner,
    )
    from ipp_rl_tpu.planners.zero.learn import load_checkpoint
    from ipp_rl_tpu.planners.zero.mission import ZeroPlanner
    from ipp_rl_tpu.planners.zero.train import init_train_state, predict_fn

    channels = settings["channels"]
    hp = MCTSZeroHyperParams(
        num_channels=channels,
        num_encoder_res_blocks=settings["blocks"],
        num_global_pooling_channels=min(32, channels // 2),
        max_valid_action_distance=11.5,
        puct_init=settings["puct_init"],
        dirichlet_alpha=settings["dirichlet_alpha"],
        unfloored_value_head=settings["unfloored_value_head"],
    )
    net, state = init_train_state(world.cfg, hp, jax.random.key(0))
    state = load_checkpoint(str(ROOT / settings["ckpt"]), state)
    pred = predict_fn(net)

    def zero(spec):
        clean = spec.endswith("c")
        sims = int(spec[:-1] if clean else spec)
        zhp = dataclasses.replace(hp, num_mcts_simulations=sims)
        mc = MissionConfig(type="mcts_zero", episode_horizon=5, hyper_params=zhp)
        return ZeroPlanner(world, mc, pred, state.variables(),
                           deploy_mode="clean" if clean else "reference")

    planners = {}
    for spec in settings["zero_sims"].split(","):
        clean = spec.endswith("c")
        name = f"zero_{int(spec[:-1] if clean else spec)}sims" + ("_clean" if clean else "")
        planners[name] = lambda spec=spec: zero(spec)
    planners["greedy"] = lambda: GreedyPlanner(world, MissionConfig(type="greedy"))
    planners["mcts_classic"] = lambda: ClassicMCTSPlanner(world, MissionConfig(
        type="mcts", num_simulations=settings["classic_sims"], episode_horizon=5,
        horizontal_spacing=14.0))
    planners["cmaes"] = lambda: CMAESPlanner(world, MissionConfig(
        type="cmaes", episode_horizon=5, cma_popsize=12, cma_maxiter=20, cma_sigma=2.0))
    planners["random"] = lambda: RandomDiscretePlanner(
        world, MissionConfig(type="random_discrete"))
    return planners


def write_reference() -> None:
    """Write the worlds file and the JAX reference for the quality phase's
    settings (the tool's ``REFERENCE_SETTINGS``)."""
    from ipp_rl_tpu import load_config
    from ipp_rl_tpu.env.world import IPPWorld as JaxWorld
    from ipp_rl_tpu_torch.tools.quality_vs_runtime import REFERENCE_SETTINGS

    jax.config.update("jax_enable_x64", False)  # the JAX script's float32
    settings = dict(REFERENCE_SETTINGS)
    cfg = load_config(str(ROOT / "ipp_rl_tpu" / "config" / "example.yaml"))
    world = JaxWorld(cfg, fast_sweeps=True)
    B = settings["batch"]
    state0 = world.init_state(jax.random.key(settings["world_seed"]), B)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(WORLDS, **{f: np.asarray(getattr(state0, f)) for f in FIELDS})
    print("wrote", WORLDS, flush=True)

    planners = _jax_planners(world, settings)
    rows = []
    for name in settings["rows"]:
        res = planners[name]().run(jax.random.key(settings["run_seed"]), B,
                                   max_steps=settings["max_steps"], init_state=state0)
        unc = np.asarray(res.metrics["uncertainty"][:, -1], dtype=np.float64)
        rmse = np.asarray(res.metrics["rmse"][:, -1], dtype=np.float64)
        steps = np.asarray(res.num_steps)
        rows.append({
            "planner": name,
            "final_uncertainty": float(unc.mean()),
            "final_rmse": float(rmse.mean()),
            "mean_steps": float(steps.mean()),
            "per_mission": {"final_uncertainty": unc.tolist(), "final_rmse": rmse.tolist(),
                            "steps": steps.astype(int).tolist()},
        })
        print(name, {k: v for k, v in rows[-1].items() if k != "per_mission"}, flush=True)

    committed = {}
    for curve in ("quality_vs_runtime_r5", "qvr_r5_bestpolicy"):
        path = ROOT / "runs" / curve / "curve.json"
        if path.exists():
            data = json.loads(path.read_text())
            committed[curve] = {
                "ckpt": data["config"]["ckpt"],
                "rows": {r["planner"]: {"final_uncertainty": r["final_uncertainty"],
                                        "final_rmse": r["final_rmse"]}
                         for r in data["rows"] if r["planner"] in settings["rows"]},
            }
    REFERENCE.write_text(json.dumps({
        "settings": settings,
        "made_with": {"jax": jax.__version__, "platform": jax.default_backend(),
                      "dtype": "float32", "generator": "python tests/test_torch_quality.py "
                                                      "--write-reference"},
        "rows": rows,
        # the JAX script's committed TPU curves, quality columns only, for
        # the rows both have (a check of this reference; classic MCTS there
        # ran 32 simulations)
        "committed_curves": committed,
    }, indent=1))
    print("wrote", REFERENCE, flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--write-reference", action="store_true")
    if not ap.parse_args().write_reference:
        sys.exit("usage: python tests/test_torch_quality.py --write-reference")
    write_reference()
