"""The snapshot-evaluation tool (ipp_rl_tpu_torch/tools/eval_snapshots.py),
the counterpart of the repository's ``scripts/eval_snapshots.py``, on the
CPU at a small size: two copies of the committed checkpoint give equal
rows, the deployed checkpoint's row equals the quality tool's row for the
same planner, worlds, step count and seed (exactly: the same draws), a
missing snapshot is skipped, and the output keeps the JAX script's file
name and keys."""

import json
import pathlib
import shutil

import pytest
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, load_config
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.tools import eval_snapshots
from ipp_rl_tpu_torch.tools import quality_vs_runtime as qvr

from test_torch_zero_search import one_thread  # noqa: F401,E402 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / qvr.REFERENCE_SETTINGS["ckpt"]
WORLDS = ROOT / "runs" / "quality_torch" / "worlds_s12345_b32.npz"
# the committed checkpoint's network, two simulations, three missions, two steps
ARGS = ["--channels", "64", "--blocks", "6", "--unfloored-value-head", "--sims", "2",
        "--batch", "3", "--eval-steps", "2", "--worlds", str(WORLDS), "--device", "cpu"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    run = tmp_path_factory.mktemp("run")
    (run / "checkpoints").mkdir()
    for name in ("shared_net.snapshot_1", "shared_net.snapshot_2",
                 "shared_net.trained_model.ckpt"):
        shutil.copy(CKPT, run / "checkpoints" / name)
    return run


@pytest.fixture(scope="module")
def evaluated(run_dir):
    assert eval_snapshots.main(["--run", str(run_dir), "--snapshots", "1,2,3,deploy"] + ARGS) == 0
    return json.loads((run_dir / "snapshot_eval_reference.json").read_text())


def test_two_copies_of_a_checkpoint_give_equal_rows(evaluated):
    assert list(evaluated) == ["snapshot_1", "snapshot_2", "snapshot_deploy", "greedy",
                               "random"]  # snapshot 3 is missing: skipped
    for row in evaluated.values():
        assert set(row) == set(eval_snapshots.ROW_KEYS)
    for key in ("final_uncertainty", "final_rmse"):
        assert evaluated["snapshot_1"][key] == evaluated["snapshot_2"][key]
        assert evaluated["snapshot_1"][key] == evaluated["snapshot_deploy"][key]


def test_deploy_row_is_the_quality_tools_row(evaluated):
    """The same planner (the checkpoint at two simulations, reference deploy
    mode), worlds, steps and seed through the quality tool's function."""
    world = IPPWorld(load_config(str(CONFIG_DIR / "example.yaml")), fast_sweeps=True,
                     device="cpu")
    settings = qvr.Settings(ckpt=str(CKPT), unfloored_value_head=True, max_steps=2,
                            zero_sims="2", rows=["zero_2sims"])
    (row,) = qvr.evaluate(world, settings, qvr.load_worlds(str(WORLDS), world, 3), log=None)
    for key in ("final_uncertainty", "final_rmse"):
        assert evaluated["snapshot_deploy"][key] == row[key]


def test_world_seed_names_the_output_and_draws_the_worlds(run_dir):
    args = eval_snapshots.parse_args(["--run", str(run_dir), "--world-seed", "54321",
                                      "--deploy-mode", "clean"])
    assert eval_snapshots.output_path(args) == str(run_dir / "snapshot_eval_clean_s54321.json")
    rows = eval_snapshots.evaluate_snapshots(eval_snapshots.parse_args(
        ["--run", str(run_dir), "--snapshots", "deploy", "--world-seed", "54321", "--channels",
         "64", "--blocks", "6", "--unfloored-value-head", "--sims", "0", "--batch", "2",
         "--eval-steps", "1", "--device", "cpu"]), log=None)
    assert list(rows) == ["snapshot_deploy", "greedy", "random"]
    assert rows["greedy"]["result"].metrics["uncertainty"].shape == (2, 2)
    assert eval_snapshots.parse_args(["--run", "x"]).device == "cuda"
    assert torch.get_default_dtype() == torch.float32
