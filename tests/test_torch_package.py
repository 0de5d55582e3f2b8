"""Boundaries of the PyTorch/CUDA port: it imports neither JAX, flax,
optax, msgpack nor the JAX package (the card's machine has none of them),
its entry points run on the card unless told otherwise (no public
function defaults its ``device`` to the CPU; ``python -m
ipp_rl_tpu_torch.main`` stops without a card), importing an entry point
runs nothing, and
``chip_smoke.py`` fails (printing no result) without a card or without the
rest of the repository."""

import importlib
import inspect
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "ipp_rl_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|chex|msgpack|ipp_rl_tpu)(\.|\s|$)", re.M
)


def _port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    return [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PACKAGE.rglob("*.py"))
    ]


def test_port_sources_import_no_jax():
    offenders = [str(p) for p in _port_sources() if FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_port_imports_with_jax_blocked():
    """Every module of the port, the checkpoint reader included, imports in
    a process where importing jax, flax, optax, msgpack or ipp_rl_tpu
    raises."""
    modules = _port_modules()
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'msgpack', 'ipp_rl_tpu'): sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "assert not any(k in ('jax', 'flax', 'optax', 'msgpack') "
        "or k.startswith(('jax.', 'flax.', 'optax.', 'msgpack.', 'ipp_rl_tpu.')) "
        "for k in sys.modules if sys.modules[k] is not None)\n"
        "from ipp_rl_tpu_torch.serialization import read_checkpoint\n"
        "tree = read_checkpoint('runs/zero_canon_r5_best/checkpoints/"
        "shared_net.trained_model.ckpt')\n"
        "assert tree['params']['encoder']['stem']['Conv_0']['kernel'].shape == (7, 7, 16, 64)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_cuda(small_cfg):
    from ipp_rl_tpu_torch import resolve_device
    from ipp_rl_tpu_torch.convert import belief_state_from_arrays
    from ipp_rl_tpu_torch.config import MCTSZeroHyperParams, MissionConfig
    from ipp_rl_tpu_torch.env.world import IPPWorld
    from ipp_rl_tpu_torch.planners.zero import ZeroPlanner
    from ipp_rl_tpu_torch.planners.zero.train import init_network, predict_fn

    from test_torch_world import port_cfg

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IPPWorld(port_cfg(small_cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        belief_state_from_arrays({})
    cfg = port_cfg(small_cfg)
    hp = MCTSZeroHyperParams(num_channels=8, num_global_pooling_channels=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_network(cfg, hp, torch.Generator())
    assert resolve_device("cpu") == torch.device("cpu")
    # the deploy planner runs on its world's device: the card unless told
    world = IPPWorld(cfg, device="cpu")
    net = init_network(cfg, hp, torch.Generator(), device="cpu")
    planner = ZeroPlanner(world, MissionConfig(type="mcts_zero", hyper_params=hp),
                          predict_fn(net), net.state_dict())
    assert planner.world.device == torch.device("cpu")


def test_no_public_device_default_is_the_cpu():
    """Every public function and method of the port that takes ``device``
    defaults it to the card ("cuda", or None for the caller's own)."""
    checked, offenders = [], []
    for name in _port_modules():
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                fns = [(attr, obj)]
            elif inspect.isclass(obj):
                fns = [(f"{attr}.{m}", f) for m, f in vars(obj).items()
                       if inspect.isfunction(f) and (not m.startswith("_") or m == "__init__")]
            else:
                continue
            for label, fn in fns:
                param = inspect.signature(fn).parameters.get("device")
                if param is None or param.default is inspect.Parameter.empty:
                    continue
                checked.append(f"{name}.{label}")
                if param.default not in ("cuda", None):
                    offenders.append(f"{name}.{label} = {param.default!r}")
    assert offenders == []
    for fn in ("planners.zero.mcts.init_tree", "ops.kalman.prepare_batched_sweep",
               "planners.zero.train.init_train_state", "env.world.IPPWorld.__init__",
               "experiments.experiment.Experiment.__init__",
               "ros.mission_node.IPPMissionNode.__init__",
               "ros.sim_robot.ClosedLoopMission.__init__", "parallel.mesh.make_mesh",
               "parallel.mesh.initialize_multihost"):
        assert f"ipp_rl_tpu_torch.{fn}" in checked


def test_entry_point_modules_run_nothing_when_imported(tmp_path):
    """Importing the entry points parses no arguments, writes no file and
    prints nothing: their work runs under the ``__main__`` check."""
    code = ("import sys; sys.argv = ['x', '--bogus']\n"
            "import ipp_rl_tpu_torch.main, ipp_rl_tpu_torch.tools.train_zero\n"
            "import ipp_rl_tpu_torch.ros.mission_node, ipp_rl_tpu_torch.ros.sim_robot\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "" and list(tmp_path.iterdir()) == []


def test_main_without_a_card_exits_nonzero(tmp_path):
    """The port's entry point runs on the card: without one it stops at
    once, unless given ``--device cpu`` (tests/test_torch_experiment.py
    runs it so)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "ipp_rl_tpu_torch.main", "--max-steps", "1",
                           "--results", str(tmp_path / "r"), "--logs", str(tmp_path / "l")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "r").exists()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and proc.stdout.strip() == ""


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
