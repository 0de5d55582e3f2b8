"""The port's classic MCTS (ipp_rl_tpu_torch/planners/mcts_classic.py)
against the benchmark's plain reference of the search
(benchmark/reference/classic.py: float64 PyTorch, one Python tree per
mission, nothing of the port), on the classic cell's configuration
(benchmark/configs/example_classic.json) cut to 8 simulations, B = 4,
the search's draws injected.

The missions start from a state after two commits (at the GP prior the
grid's mirror symmetry makes mirrored actions' rewards tie exactly), with
budgets that leave one mission less than the grid's resolution (it
searches nothing).  In float64 the root's visits, its children (actions
and visits in the order they were made, value sums to rtol 1e-10), the
action and the commit agree; in float32 against the reference fed the
same float32 state, the integers and the action agree and the values and
the commit lie within the classic cell's limits.  The search counts
S·(Hc + H) lockstep steps."""

import dataclasses
import json
import pathlib

import pytest
import torch

from benchmark import inputs
from benchmark.reference import classic as ref_classic
from benchmark.reference.world import RefWorld
from ipp_rl_tpu_torch.config import config_from_dict
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners.mcts_classic import ClassicDraws, ClassicMCTSPlanner
from ipp_rl_tpu_torch.utils import tracing

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "example_classic.classic-b1024"
B, SIMS = 4, 8
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _raw():
    with open(ROOT / "benchmark" / "configs" / "example_classic.json") as f:
        config = json.load(f)
    mission = next(m for m in config["config"]["experiment"]["missions"] if m["type"] == "mcts")
    mission["num_simulations"] = SIMS
    return config


def _limits():
    with open(ROOT / "benchmark" / "workloads" / f"{CELL}.json") as f:
        return json.load(f)["limits"]


@pytest.fixture(scope="module")
def case():
    """The float64 world, the state after two commits, the draws, the
    measurement noise, and the reference's world and knobs."""
    config = _raw()
    world = IPPWorld(config_from_dict(config["config"]), dtype=F64, device="cpu")
    g = torch.Generator().manual_seed(18)
    mean0, cov0 = inputs.prior(config, "cpu")
    gt = inputs.fields(config, B, g, "cpu").to(F64)
    state = inputs.belief_state(mean0.to(F64), cov0.to(F64),
                                inputs.start_pos(config, "cpu").to(F64), 200.0, gt)
    for _ in range(2):
        a = torch.randint(0, world.num_actions, (B,), generator=g)
        state = world.step_index(state, a, generator=g)
    state = state.replace(budget=torch.tensor([50.0, 123.5, 200.0, 3.0], dtype=F64))
    planner = ClassicMCTSPlanner(world, next(m for m in world.cfg.missions if m.type == "mcts"))
    S, H, A, K = planner.num_simulations, planner.horizon, world.num_actions, planner.max_children

    def u(*shape):
        return torch.rand(shape, generator=g, dtype=F64)

    draws = ClassicDraws(select=u(S, H + 1, B, K), expand=u(S, H + 1, B, A),
                         expand_u=u(S, H + 1, B), rollout=u(S, H, B, A), rollout_u=u(S, H, B))
    noise = torch.randn((1, B, world.H.shape[1]), generator=g, dtype=F64)
    raw = config["config"]
    return {"config": config, "state": state, "draws": draws, "noise": noise,
            "ref": RefWorld(raw), "hp": ref_classic.hyper(raw)}


def _cast(x, dtype):
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _cast(getattr(x, f.name), dtype) for f in dataclasses.fields(x)})
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_search_and_commit_match_the_reference(case, dtype):
    config = case["config"]
    world = IPPWorld(config_from_dict(config["config"]), dtype=dtype, device="cpu")
    planner = ClassicMCTSPlanner(world, next(m for m in world.cfg.missions if m.type == "mcts"))
    state, draws = _cast(case["state"], dtype), _cast(case["draws"], dtype)
    noise = case["noise"].to(dtype)
    before = tracing.counts("classic.")
    tree, stats = planner.search(state, draws=draws)
    steps = tracing.counts("classic.")["classic.lockstep_steps"] - before.get(
        "classic.lockstep_steps", 0)
    hc, h = planner.horizon + 1, planner.horizon
    assert steps == SIMS * (hc + h)
    res = planner.run(B, max_steps=1, init_state=state, noise=noise, draws=[draws])

    # the reference from the same state, in float64
    ref, hp = case["ref"], case["hp"]
    d = {f.name: getattr(draws, f.name).to(F64) for f in dataclasses.fields(draws)
         if getattr(draws, f.name) is not None}
    want = ref_classic.search(ref, hp, state.cov.to(F64), state.mean.to(F64),
                              state.pos.to(F64), state.budget.to(F64), d)
    limits = _limits()
    for b, w in enumerate(want):
        n = int(tree.num_children[b, 0])
        ids = tree.children[b, 0, :n]
        assert tree.visits[b, 0].item() == w["visits"]
        assert tree.action_in[b, ids].tolist() == w["actions"]
        assert tree.visits[b, ids].tolist() == w["child_visits"]
        got_v = tree.value_sum[b, ids].to(F64)
        want_v = torch.tensor(w["child_values"], dtype=F64)
        if dtype == F64:
            torch.testing.assert_close(got_v, want_v, rtol=1e-10, atol=1e-12)
        elif n:
            scale = max(float(want_v.abs().max()), 1e-3)
            assert float((got_v - want_v).abs().max()) / scale <= limits["tree_err"]
        assert int(stats.best_child_action[b]) == w["action"]
    # the mission whose budget is under the grid's resolution searches nothing
    assert [w["visits"] for w in want] == [SIMS, SIMS, SIMS, 0]

    # the commit at the action taken, with the run's noise
    a = torch.tensor([w["action"] for w in want])
    moved = ~torch.isnan(torch.as_tensor(res.waypoints[:, 0, 0]))
    cost = ref_classic.costs(ref, state.pos)[torch.arange(B), a]
    assert moved.tolist() == ((cost > 0) & (cost <= state.budget.to(F64))).tolist()
    z = ref.reading(state.ground_truth.to(F64), ref.Z[a], ref.noise_std[a], noise[0].to(F64))
    m1, c1 = ref.commit(state.cov.to(F64), state.mean.to(F64), ref.H[a], ref.R[a], z)
    m1 = torch.where(moved[:, None], m1, state.mean.to(F64))
    c1 = torch.where(moved[:, None, None], c1, state.cov.to(F64))
    fin = res.final_state
    if dtype == F64:
        torch.testing.assert_close(fin.cov, c1, rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(fin.mean, m1, rtol=1e-10, atol=1e-12)
    else:
        scale = state.cov.to(F64).abs().amax(dim=(-2, -1), keepdim=True)
        err = max(float(((fin.cov.to(F64) - c1).abs() / scale).max()),
                  float((fin.mean.to(F64) - m1).abs().max()))
        assert err <= limits["belief_err"]
