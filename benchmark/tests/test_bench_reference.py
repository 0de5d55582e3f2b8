"""The plain reference against the port's plain path at CPU sizes, piece
by piece, in float64."""

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark.reference import cmaes as ref_cmaes
from benchmark.reference import search as ref_search
from benchmark.reference.greedy import greedy_loop
from benchmark.reference.network import RefNet, planes
from benchmark.reference.world import RefWorld, matern_prior


def _config(name):
    return harness.data_file("configs", name)["config"]


def _port_world(raw):
    from ipp_rl_tpu_torch.config import config_from_dict
    from ipp_rl_tpu_torch.env.world import IPPWorld

    return IPPWorld(config_from_dict(raw), dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ["example", "temperature_cmaes"])
def test_tables_and_camera(name):
    raw = _config(name)
    ref, port = RefWorld(raw), _port_world(raw)
    for a, b in ((ref.xyz, port.actions_xyz), (ref.H, port.H), (ref.R, port.R_diag),
                 (ref.Z, port.Z), (ref.noise_std, port.noise_std)):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(0)
    pos = torch.rand((300, 3), generator=g, dtype=torch.float64) * torch.tensor(
        [44.0, 44.0, 8.0], dtype=torch.float64) + torch.tensor([-2.0, -2.0, 7.0], dtype=torch.float64)
    H, R, Z, _ = port.measurement_model_at(pos)
    H2, R2, Z2, _ = ref.measurement_model(pos, rows=H.shape[1])
    assert torch.equal(H, H2) and torch.equal(R, R2) and torch.equal(Z, Z2)


def test_prior():
    from ipp_rl_tpu_torch.config import config_from_dict
    from ipp_rl_tpu_torch.ops.priors import init_belief

    raw = _config("example")
    mean, cov = init_belief(config_from_dict(raw), device="cpu", dtype=torch.float64)
    m2, c2 = matern_prior(raw)
    assert torch.allclose(cov, c2, rtol=1e-13, atol=1e-13) and torch.equal(mean, m2)


def test_greedy_mission():
    """The reference planning itself in float64 flies the port's greedy
    missions (float64, plain path) and keeps the same beliefs."""
    from ipp_rl_tpu_torch.planners.greedy import GreedyPlanner

    raw = _config("example")
    port = _port_world(raw)
    planner = GreedyPlanner(port, next(m for m in port.cfg.missions if m.type == "greedy"))
    g = torch.Generator().manual_seed(3)
    B, T = 3, 12
    state = port.init_state(B, g)
    noise = torch.randn((T, B, port.H.shape[1]), generator=g, dtype=torch.float64)
    res = planner.run(B, max_steps=T, init_state=state, noise=noise)
    ref = greedy_loop(RefWorld(raw), {"mean": state.mean, "cov": state.cov, "pos": state.pos,
                                      "budget": state.budget, "gt": state.ground_truth},
                      noise.transpose(0, 1), T)
    assert torch.equal(torch.as_tensor(res.waypoints).isnan(), ref["waypoints"].isnan())
    ok = ~ref["waypoints"].isnan()
    assert torch.equal(torch.as_tensor(res.waypoints)[ok], ref["waypoints"][ok])
    assert torch.allclose(torch.as_tensor(res.metrics["uncertainty"]), ref["uncertainty"],
                          rtol=1e-9)
    assert torch.allclose(res.final_state.cov, ref["cov"], atol=1e-10)


def test_cmaes_fitness():
    from ipp_rl_tpu_torch.planners.cmaes import CMAESPlanner

    raw = _config("temperature_cmaes")
    port = _port_world(raw)
    planner = CMAESPlanner(port, next(m for m in port.cfg.missions if m.type == "cmaes"))
    g = torch.Generator().manual_seed(4)
    B, K, H = 3, 5, planner.horizon
    field = torch.tensor(harness.data_file("configs", "temperature_cmaes")["ground_truth"],
                         dtype=torch.float64)
    state = port.init_state(B, g, ground_truth=field)
    lo = torch.tensor([-3.0, -3.0, 7.0], dtype=torch.float64)
    hi = torch.tensor([43.0, 43.0, 15.0], dtype=torch.float64)
    flat = (lo + (hi - lo) * torch.rand((B, K, H, 3), generator=g, dtype=torch.float64)).reshape(
        B, K, 3 * H)
    got = planner.trajectory_loss(flat, state.cov, state.mean, state.pos, state.budget)
    want = ref_cmaes.trajectory_loss(RefWorld(raw), flat, state.cov, state.mean, state.pos,
                                     state.budget, H)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-12)


def test_network_and_planes():
    from ipp_rl_tpu_torch.planners.zero.features import EpisodeHistory, feature_planes
    from ipp_rl_tpu_torch.planners.zero.train import init_network, predict_fn

    raw = _config("example")
    port = _port_world(raw)
    mc = next(m for m in port.cfg.missions if m.type == "mcts_zero")
    hp = dataclasses.replace(mc.hyper_params, num_channels=16, num_global_pooling_channels=8)
    net = init_network(port.cfg, hp, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float64)
    g = torch.Generator().manual_seed(1)
    S, L, n = 3, 3, 100
    X = torch.randn((S, L, n, n), generator=g, dtype=torch.float64)
    hist = EpisodeHistory(covs=X @ X.mT / n,
                          positions=port.actions_xyz[torch.randint(0, 200, (S, L), generator=g)],
                          budgets=torch.rand((S, L), generator=g, dtype=torch.float64),
                          length=torch.tensor([1, 2, 3], dtype=torch.int32))
    mean = torch.rand((S, n), generator=g, dtype=torch.float64)
    x = planes(RefWorld(raw), hist.covs, hist.positions, hist.budgets, hist.length, mean)
    assert torch.equal(feature_planes(port, hp, hist, mean).permute(0, 3, 1, 2), x)
    mask = (torch.rand((S, 200), generator=g) > 0.3).to(torch.float64)
    policy, value = predict_fn(net)(net.state_dict(), x.permute(0, 2, 3, 1), mask)
    p2, v2 = RefNet(net.state_dict(), dataclasses.asdict(hp))(x, mask)
    assert torch.allclose(policy.double(), p2, atol=1e-6)
    assert torch.allclose(value.double(), v2, rtol=1e-6)


def test_cmaes_generations():
    """The reference follows the port's CMA-ES (float64, plain path) from
    its covariances to within rounding, and its own whole run alike."""
    from ipp_rl_tpu_torch.planners.cmaes import cma_es_minimize

    raw = _config("temperature_cmaes")
    H, S, G, lam = 5, 4, 6, 12
    scales, lower, upper = ref_cmaes.cma_box(raw, H)
    g = torch.Generator().manual_seed(5)
    x0 = lower + (upper - lower) * torch.rand((S, 3 * H), generator=g, dtype=torch.float64)
    z = torch.randn((S, G, lam, 3 * H), generator=g, dtype=torch.float64)
    target = lower + (upper - lower) * torch.rand((S, 1, 3 * H), generator=g, dtype=torch.float64)
    gens = []

    def eigh(C):
        e, V = torch.linalg.eigh(C)
        gens.append({"C": C.clone(), "e": e, "V": V})
        return e, V

    def objective(x):
        f = torch.sum((x - target) ** 2, dim=-1)
        gens[-1].update(x=x.clone(), f=f)
        return f

    cma_es_minimize(objective, x0, scales, lower, upper, lam, G, normals=z, eigh=eigh)
    ref = RefWorld(raw)
    assert ref_cmaes.follow(ref, raw, x0, z, gens, H) < 1e-12
    own = ref_cmaes.run_cma(ref, raw, x0, z, lambda x: torch.sum((x - target) ** 2, dim=-1), H)
    assert ref_cmaes.follow(ref, raw, x0, z, own, H) < 1e-12
    gens[2]["x"] = gens[2]["x"] + 0.01
    assert ref_cmaes.follow(ref, raw, x0, z, gens, H) > 1e-4


def _mcts(raw, sims=4):
    from ipp_rl_tpu_torch.planners.zero.mcts import ZeroMCTS

    port = _port_world(raw)
    mc = next(m for m in port.cfg.missions if m.type == "mcts_zero")
    hp = dataclasses.replace(mc.hyper_params, num_mcts_simulations=sims)
    return port, ZeroMCTS(port, hp, mc.episode_horizon, None)


def test_puct_scores():
    from ipp_rl_tpu_torch.planners.zero.mcts import init_tree

    raw = _config("example")
    port, mcts = _mcts(raw)
    S, A = 6, port.num_actions
    tree = init_tree(S, 4, A, 100, port.H.shape[1], torch.float64, device="cpu")
    g = torch.Generator().manual_seed(6)
    tree.Nsa[:, 0] = torch.randint(0, 4, (S, A), generator=g).to(torch.float64)
    tree.Qsa[:, 0] = torch.rand((S, A), generator=g, dtype=torch.float64) * (tree.Nsa[:, 0] > 0)
    prior = torch.rand((S, A), generator=g, dtype=torch.float64)
    tree.prior[:, 0] = prior / prior.sum(dim=-1, keepdim=True)
    tree.valid[:, 0] = torch.rand((S, A), generator=g) > 0.2
    tree.Ns[:, 0] = tree.Nsa[:, 0].sum(dim=-1)
    node = torch.zeros(S, dtype=torch.long)
    root = torch.tensor([True, True, True, False, False, False])
    got = mcts.puct(tree, node, 15.0, root)
    hp = ref_search.hyper(raw)
    score, forced, maybe = ref_search.puct(RefWorld(raw), hp, tree.Nsa[:, 0], tree.Qsa[:, 0],
                                           tree.prior[:, 0], tree.valid[:, 0], tree.Ns[:, 0], root)
    assert forced.any()
    assert torch.all(ref_search.score_err(got, score, forced, maybe) < 1e-12)
    wrong = got.clone()
    wrong[0, torch.argmax(torch.where(torch.isfinite(got[0]), got[0], -1.0))] += 0.5
    assert ref_search.score_err(wrong, score, forced, maybe)[0] > 1e-3


def test_backup_and_path_rewards():
    """The backed-up values of a path, and its rewards from the root's
    belief, against the port's edge update and backup (float64)."""
    from ipp_rl_tpu_torch.planners.zero.mcts import init_tree

    raw = _config("example")
    port, mcts = _mcts(raw)
    S, K, A = 5, 4, port.num_actions
    g = torch.Generator().manual_seed(7)
    state = port.init_state(S, g)
    actions = torch.randint(0, A, (S, K), generator=g)
    length = torch.tensor([4, 3, 2, 1, 4])
    mask = torch.ones((S, 100), dtype=torch.bool)
    P, prev = state.cov, state.pos
    rewards = torch.zeros((S, K), dtype=torch.float64)
    for k in range(K):
        WcT, gain = mcts.edge_update(P, actions[:, k], mask)
        cost = mcts.flight_cost(prev, actions[:, k])
        rewards[:, k] = torch.where(k < length, gain / (cost + 1.0), 0.0)
        P = P - WcT.mT @ WcT
        prev = port.actions_xyz[actions[:, k]]
    # a mean of 10 puts every cell in the adaptive region: the port's mask
    # of every cell
    high = torch.full((S, 100), 10.0, dtype=torch.float64)
    assert bool(RefWorld(raw).roi(high, state.cov).all())
    want = ref_search.path_rewards(RefWorld(raw), state.cov, high, state.pos, actions, length)
    assert torch.allclose(rewards, want, rtol=1e-10, atol=1e-12)

    tree = init_tree(S, 8, A, 100, port.H.shape[1], torch.float64, device="cpu")
    nodes = torch.arange(K)[None, :].expand(S, K)
    b = torch.arange(S)[:, None]
    tree.Nsa[b, nodes, actions] = torch.randint(0, 3, (S, K), generator=g).to(torch.float64)
    tree.Qsa[b, nodes, actions] = torch.rand((S, K), generator=g, dtype=torch.float64)
    nsa, qsa = tree.Nsa[b, nodes, actions].clone(), tree.Qsa[b, nodes, actions].clone()
    value = torch.rand(S, generator=g, dtype=torch.float64)
    c = mcts._descend_init(tree, state.cov, state.pos)
    c.path_nodes[:, :K], c.path_actions[:, :K], c.path_rewards[:, :K] = nodes, actions, rewards
    c.path_len = length
    mcts._backup(tree, c, value, K)
    q = ref_search.backup(RefWorld(raw), ref_search.hyper(raw), rewards, value, nsa, qsa, length)
    assert torch.allclose(tree.Qsa[b, nodes, actions], q, rtol=1e-12)
