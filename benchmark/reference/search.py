"""Plain reference of MCTS-zero's tree statistics, for the comparison that
follows a search step by step from the program's own tree:

* ``puct``: the PUCT scores of a node's actions (min-max normalised Q,
  the exploration term that grows with the node's visits, forced
  playouts √(k·P·N) at the root, invalid actions out), and which actions
  a forced playout must take;
* ``selection_gap``: how far the action a descent step took lies below
  the best by those scores;
* ``leaf_prior``: the prior a leaf's evaluation stores (the policy on its
  valid actions, Dirichlet noise mixed in at the root's first evaluation,
  the uniform valid policy where nothing is left);
* ``path_rewards``: the rewards of a path of lattice actions from the
  root's belief (information gain over cost + 1, the belief falling by
  each measurement);
* ``backup``: the action values after a path's return is backed up.

The search's hyper-parameters are the configuration's, with the
reference experiment's defaults where it names none.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.world import RefWorld

#: the reference experiment's values of what example.yaml leaves unnamed
DEFAULTS = {"gamma": 1.0, "puct_init": 15.0, "puct_base": 10000.0,
            "forced_playout_factor": 2.0, "dirichlet_eps": 0.25}


def hyper(raw: Dict, mission: str = "mcts_zero") -> Dict:
    m = next(m for m in raw["experiment"]["missions"] if m["type"] == mission)
    return dict(DEFAULTS, **m.get("hyper_params", {}))


def puct(world: RefWorld, hp: Dict, nsa, qsa, prior, valid, ns, root):
    """(scores (S, A), forced (S, A), maybe forced (S, A)) at S nodes with
    statistics nsa, qsa, prior (S, A), valid (S, A) bool, visits ns (S,)
    and ``root`` (S,) bool: the scores of valid actions, −inf elsewhere.
    A forced playout's count √(k·P·N) rounded up is ambiguous within
    rounding of a whole number: ``maybe`` holds the actions forced on
    either side of it."""
    r, dt = world.arith.r, world.arith.dtype
    nsa, qsa, prior, ns = (x.to(dt) for x in (nsa, qsa, prior, ns))
    lo, hi = qsa.amin(dim=-1, keepdim=True), qsa.amax(dim=-1, keepdim=True)
    all_zero = (qsa == 0).all(dim=-1, keepdim=True)
    q = torch.where(lo == hi, qsa / torch.where(hi == 0, torch.ones_like(hi), hi),
                    (qsa - lo) / (hi - lo))
    q = r(torch.where(all_zero, qsa, q))
    ns = ns[:, None]
    c = r(hp["puct_init"] + torch.log((ns + hp["puct_base"] + 1.0) / hp["puct_base"]))
    score = r(q + r(c * prior * r(torch.sqrt(ns + 1.0) / (1.0 + nsa))))
    x = r(torch.sqrt(hp["forced_playout_factor"] * prior * ns))
    tol = 1e-5 * torch.clamp(x, min=1.0)
    on = root[:, None] & (nsa > 0)
    forced = on & (nsa < torch.ceil(x - tol))
    maybe = on & (nsa < torch.ceil(x + tol))
    score = torch.where(valid, score, float("-inf"))
    return score, forced & valid, maybe & valid


def selection_gap(score, forced, maybe, a) -> torch.Tensor:
    """(S,) relative gap of the taken actions ``a`` (S,) below the best
    score: 0 for a forced playout the reference allows, inf for an invalid
    action or one taken while another is certainly forced."""
    rows = torch.arange(a.shape[0], device=a.device)
    best = score.amax(dim=-1)
    mine = score[rows, a]
    gap = (best - mine) / torch.clamp(best.abs(), min=1e-3)
    gap = torch.where(forced.any(dim=-1), float("inf"), gap)
    gap = torch.where(maybe[rows, a], 0.0, gap)
    return torch.where(torch.isfinite(mine), gap, float("inf"))


def leaf_prior(world: RefWorld, hp: Dict, policy, mask, noise, root_first):
    """(S, A) prior stored at S leaves from the network's policy, the valid
    mask (S, A) bool, the root noise (S, A) and whether this is the root's
    first evaluation (S,) bool."""
    r, dt = world.arith.r, world.arith.dtype
    m = mask.to(dt)
    p = r(policy.to(dt) * m)
    eps = hp["dirichlet_eps"]
    noised = r(r((1.0 - eps) * p + eps * noise.to(dt)) * m)
    p = torch.where(root_first[:, None], noised, p)
    s = p.sum(dim=-1, keepdim=True)
    p = torch.where(s > 0, p / torch.clamp(s, min=1e-30), m)
    return r(p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30))


def path_rewards(world: RefWorld, cov, mean, pos, actions, length) -> torch.Tensor:
    """(S, K) rewards of the first ``length`` (S,) actions of the paths
    ``actions`` (S, K) from root beliefs cov (S, N, N), mean (S, N) and
    positions pos (S, 3); 0 past each path's end."""
    r, dt = world.arith.r, world.arith.dtype
    S, K = actions.shape
    P = cov.to(world.device, dt)
    mask = world.roi(mean.to(world.device, dt), P)
    prev = pos.to(world.device, torch.float64)
    out = torch.zeros((S, K), dtype=torch.float64, device=world.device)
    for k in range(K):
        on = k < length
        a = torch.clamp(actions[:, k], min=0)
        H, R = world.H[a], world.R[a]
        gain = world.gains(P, mask, H[:, None], R[:, None])[:, 0].to(torch.float64)
        cost = world.flight_time(world.xyz[a], prev)
        out[:, k] = torch.where(on, r(gain / (cost + 1.0)), 0.0)
        HP = r(H @ P)
        Sm = r(HP @ H.mT)
        Sm = r(0.5 * (Sm + Sm.mT)) + torch.diag_embed(R)
        P = torch.where(on[:, None, None], r(P - r(HP.mT @ r(torch.linalg.inv(Sm) @ HP))), P)
        prev = torch.where(on[:, None], world.xyz[a], prev)
    return out


def backup(world: RefWorld, hp: Dict, rewards, leaf_value, nsa, qsa, length):
    """(S, K) action values along S paths after their returns are backed
    up: G_k = r_k + γ·G_{k+1} from the leaf's value, Q ← (N·Q + G)/(N + 1)
    with the visits nsa and values qsa (S, K) the path's edges had before;
    entries past a path's length are kept."""
    r, dt = world.arith.r, world.arith.dtype
    S, K = rewards.shape
    G = leaf_value.to(dt)
    nsa, qsa, rewards = nsa.to(dt), qsa.to(dt), rewards.to(dt)
    out = qsa.clone()
    for k in reversed(range(K)):
        on = k < length
        G_new = r(rewards[:, k] + hp["gamma"] * G)
        q = torch.where(nsa[:, k] > 0, r((nsa[:, k] * qsa[:, k] + G_new) / (nsa[:, k] + 1.0)),
                        G_new)
        out[:, k] = torch.where(on, q, qsa[:, k])
        G = torch.where(on, G_new, G)
    return out


def score_err(prog, score, forced, maybe) -> torch.Tensor:
    """(S,) widest relative gap between the program's PUCT scores (S, A)
    (+inf on a forced playout, −inf on an invalid action) and the
    reference's: inf where one side forces or rules out an action the
    other does not (within the rounding ``maybe`` allows)."""
    prog = prog.to(score)
    p_inf, r_inf = torch.isposinf(prog), torch.isneginf(score)
    bad = (p_inf & ~maybe) | (forced & ~p_inf) | (torch.isneginf(prog) != r_inf)
    both = torch.isfinite(prog) & torch.isfinite(score)
    rel = torch.where(both, (prog - score).abs() / torch.clamp(score.abs(), min=1e-3), 0.0)
    return torch.where(bad.any(dim=-1), float("inf"), rel.amax(dim=-1))
