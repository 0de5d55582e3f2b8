"""Plain reference of classic MCTS with progressive widening (the
reference's ``planning/mcts_mission.py``, ``MCTSMission``) for one search
worker per mission, and its pieces for the comparison that follows a
search step by step from the program's own tree:

* ``rewards``: every lattice action's reward against a belief, the
  information gain over its flight cost + 1 (the all-action sweep);
* ``available``: the actions a node may expand into, affordable, at a
  positive cost and closer than the greedy radius;
* ``policy_action``: ε-greedy over those rewards, with the draws given;
* ``widens``: progressive widening, expand while the node's children
  number at most k·N^α and fewer than its feasible actions;
* ``uct_scores``: UCT over a node's children, with their values
  "min-max normalised" as the reference writes it;
* ``edge``: the rank-M downdate P·Hᵀ·S⁻¹·H·P of an edge and its masked gain;
* ``backup_sums``: a simulation's return backed up along its path;
* ``search``: the whole search of S simulations (one tree per mission,
  a node per Python object), the root's children and the action taken,
  the argmax of the children's own mean values.

The departures from ``mcts_mission.py`` that the program keeps (each
marked where it is written below):

1. the normalisation ``value − min/(max − min)``, an operator-precedence
   slip, as the reference computes it;
2. a node's rollout return is the discounted sum of the rollout's rewards;
   the descent's edges add no discount;
3. on each edge the parent gets the return and a visit and the child
   another visit, so interior nodes count two visits a traversal;
4. a row that is boxed in (no feasible action) draws uniformly over all
   actions;
5. where UCT finds no selectable child, the descent moves along action 0
   into an empty node that keeps no visits and no factor (the program's
   node −1): the belief is not downdated, no rollout is credited, and the
   backup credits the root in its place;
6. a fresh leaf at the horizon gets no rollout, and a descent that moves
   at every step ends past its last node without one;
7. the final choice takes the best child by its own mean, duplicate
   children of one action unmerged.

The search's knobs are the configuration's ``mcts`` mission's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference.world import RefWorld

#: relative tolerance within which float32 and float64 may disagree on a
#: comparison of costs, budgets, distances or the widening bound
COMPARE_TOL = 1e-5


def hyper(raw: Dict) -> Dict:
    """The ``mcts`` mission's knobs (under the port's names: ``uct_c`` for
    the reference's ``c``, ``horizontal_spacing`` for ``max_greedy_radius``)."""
    hp = dict(next(m for m in raw["experiment"]["missions"] if m["type"] == "mcts"))
    hp["horizon"] = max(int(hp["episode_horizon"]), 2)
    workers = max(1, int(hp.get("num_mcts_workers", 1)))
    if workers != 1:
        raise NotImplementedError("the reference searches one worker per mission")
    hp["simulations"] = int(hp["num_simulations"])
    return hp


def max_children(world: RefWorld, hp: Dict) -> int:
    return min(world.num_actions, hp["simulations"] + 1)


# ------------------------------------------------------------ the pieces

def costs(world: RefWorld, pos) -> torch.Tensor:
    """(S, A) float64 flight time from positions pos (S, 3) to every action."""
    return world.flight_time(world.xyz[None], pos.to(world.device, torch.float64)[:, None])


def available(world: RefWorld, hp: Dict, pos, budget, slack: float = 0.0) -> torch.Tensor:
    """(S, A) bool: the actions at a positive cost within ``budget`` (S,)
    and closer than the greedy radius; ``slack`` widens (> 0) or narrows
    (< 0) both comparisons by that share."""
    pos = pos.to(world.device, torch.float64)
    c = costs(world, pos)
    d = torch.sqrt(torch.sum((world.xyz[None] - pos[:, None]) ** 2, dim=-1))
    b = budget.to(world.device, torch.float64)[:, None]
    radius = float(hp["horizontal_spacing"])
    return (c > 0) & (c <= b * (1.0 + slack)) & (d < radius * (1.0 + slack))


def rewards(world: RefWorld, P, mean_root, pos) -> torch.Tensor:
    """(S, A) rewards of every action against beliefs P (S, N, N): the
    masked gain (the region of interest of the ROOT's mean against the
    running P) over the flight cost + 1."""
    r, dt = world.arith.r, world.arith.dtype
    P = P.to(world.device, dt)
    mask = world.roi(mean_root.to(world.device, dt), P)
    S = P.shape[0]
    H = world.H[None].expand(S, -1, -1, -1)
    R = world.R[None].expand(S, -1, -1)
    gain = world.gains(P, mask, H, R).to(torch.float64)
    return r(gain / (costs(world, pos) + 1.0))


def policy_action(rewards, avail, eps: float, g, u) -> torch.Tensor:
    """(S,) ε-greedy action: the best available reward where u > ε and
    some action is available, else the argmax of the draws g (S, A) over
    the available actions (over all where none is, departure 4)."""
    ninf = float("-inf")
    any_avail = avail.any(dim=-1)
    greedy = torch.argmax(torch.where(avail, rewards.to(torch.float64), ninf), dim=-1)
    logits = torch.where(avail | ~any_avail[:, None], 0.0, ninf).to(torch.float64)
    rand = torch.argmax(logits + g.to(torch.float64), dim=-1)
    return torch.where((u.to(torch.float64) > eps) & any_avail, greedy, rand)


def widens(hp: Dict, n_child, node_visits, n_avail, cmax: int, slack: float = 0.0):
    """(S,) bool: progressive widening at a node with ``n_child`` children
    and ``node_visits`` visits, ``n_avail`` feasible actions; ``slack``
    moves the bound k·N^α by that share."""
    n = n_child.to(torch.float64)
    bound = hp["k"] * node_visits.to(torch.float64) ** hp["alpha"]
    return (n_child == 0) | ((n <= bound * (1.0 + slack)) & (n_child < n_avail)
                             & (n_child < cmax))


def uct_scores(world: RefWorld, hp: Dict, ch_visits, ch_values, ch_actions, exists,
               parent_visits, pos, budget, flat: Optional[torch.Tensor] = None):
    """(scores (S, K), their rounding scale (S, K)) of the K child slots of
    S nodes: children's visits, value sums and actions (S, K), which slots
    hold a child (S, K) bool, the node's visits (S,), position (S, 3) and
    budget (S,).  An unvisited child scores +inf; an empty slot and a child
    whose flight costs nothing or at least the budget score −inf.  ``flat``
    (S,) bool, where given, takes the rows' children's values as all equal
    (True) or not (False), whatever their float64 values say: within
    rounding of each other either reading holds.  The scale bounds the
    terms of a score and the amplification of the values' rounding by
    max − min, for comparing another precision's scores."""
    r = world.arith.r
    dt = world.arith.dtype
    inf = float("inf")
    v = ch_visits.to(world.device, dt)
    w = ch_values.to(world.device, dt)
    cvis = torch.where(exists, v, 1.0)
    cval = r(torch.where(exists, w / torch.clamp(cvis, min=1.0), 0.0))
    vmin = torch.where(exists, cval, inf).amin(dim=-1, keepdim=True)
    vmax = torch.where(exists, cval, -inf).amax(dim=-1, keepdim=True)
    same = vmax == vmin if flat is None else flat[:, None]
    spread = torch.clamp(vmax - vmin, min=1e-30)
    # departure 1: value − min/(max − min)
    norm = torch.where(vmax == 0, cval,
                       torch.where(same, cval / torch.where(vmax == 0, 1.0, vmax),
                                   r(cval - r(vmin / spread))))
    n = torch.clamp(parent_visits.to(world.device, dt), min=1.0)[:, None]
    explore = r(hp["uct_c"] * r(torch.sqrt(torch.log(n) / torch.clamp(cvis, min=1e-30))))
    score = torch.where(v == 0, inf, r(norm + explore)).to(torch.float64)
    a = torch.clamp(ch_actions, min=0)
    c = torch.gather(costs(world, pos), 1, a.to(world.device))
    b = budget.to(world.device, torch.float64)[:, None]
    score = torch.where((c == 0) | (c >= b), -inf, score)
    score = torch.where(exists, score, -inf)
    lim = torch.maximum(vmax.abs(), vmin.abs())
    quot = torch.where(same | (vmax == 0), 1.0, lim / spread * (1.0 + 2.0 * lim / spread))
    scale = (cval.abs() + quot + explore.abs()).to(torch.float64)
    return score, torch.where(exists, scale, 0.0)


def flat_within_rounding(ch_visits, ch_values, exists, tol: float) -> torch.Tensor:
    """(S,) bool: the rows whose children's mean values lie within ``tol``
    of each other, relative, but not exactly equal: another precision may
    read them as equal or not."""
    v = torch.where(exists, ch_visits.to(torch.float64), 1.0)
    cval = ch_values.to(torch.float64) / torch.clamp(v, min=1.0)
    vmin = torch.where(exists, cval, float("inf")).amin(dim=-1)
    vmax = torch.where(exists, cval, float("-inf")).amax(dim=-1)
    lim = torch.maximum(vmax.abs(), vmin.abs())
    return exists.any(dim=-1) & (vmax != vmin) & (vmax - vmin <= tol * lim)


def rand_argmax(scores, noise) -> torch.Tensor:
    """(S,) the argmax of ``noise`` over each row's maxima of ``scores``."""
    is_max = scores == scores.amax(dim=-1, keepdim=True)
    return torch.argmax(torch.where(is_max, noise.to(torch.float64), float("-inf")), dim=-1)


def edge(world: RefWorld, P, a, mean_root):
    """(Q = P·Hᵀ·S⁻¹·H·P (S, N, N), its gain Σ m_n Q_nn (S,)) of the edges
    a (S,) from beliefs P (S, N, N), m the region of interest of the root's
    mean against P; float64 out."""
    r, dt = world.arith.r, world.arith.dtype
    P = P.to(world.device, dt)
    a = a.to(world.device)
    H, R = world.H[a], world.R[a]
    HP = r(H @ P)
    S = r(HP @ H.mT)
    S = r(0.5 * (S + S.mT)) + torch.diag_embed(R)
    Q = r(HP.mT @ r(torch.linalg.inv(S) @ HP))
    d = torch.diagonal(Q, dim1=-2, dim2=-1)
    mask = world.roi(mean_root.to(world.device, dt), P)
    if mask is not None:
        d = d * mask
    return Q.to(torch.float64), r(d.sum(-1)).to(torch.float64)


def backup_sums(world: RefWorld, visits, values, rollout_node, rollout_value, path_nodes,
                path_rewards, path_len):
    """The node visits and value sums (S, C) after one simulation's backup
    from those before: the fresh leaf ``rollout_node`` (S,) (−1: none) its
    ``rollout_value``; then from the path's last edge to its first (path
    nodes (S, Hc), −1 credited to the root, departure 5), the parent the
    return r + G and a visit, the child a visit (departures 2, 3)."""
    r, dt = world.arith.r, world.arith.dtype
    visits = visits.to(world.device, dt).clone()
    values = values.to(world.device, dt).clone()
    rows = torch.arange(visits.shape[0], device=world.device)
    leaf_ok = rollout_node >= 0
    leaf = torch.clamp(rollout_node, min=0)
    values[rows, leaf] = r(values[rows, leaf] + torch.where(leaf_ok, rollout_value.to(dt), 0.0))
    visits[rows, leaf] += leaf_ok.to(dt)
    G = rollout_value.to(dt)
    for kk in reversed(range(path_nodes.shape[1])):
        on = kk < path_len
        parent = (torch.zeros_like(path_len) if kk == 0
                  else torch.clamp(path_nodes[:, kk - 1], min=0))
        child = torch.clamp(path_nodes[:, kk], min=0)
        G_new = r(path_rewards[:, kk].to(dt) + G)
        values[rows, parent] = r(values[rows, parent] + torch.where(on, G_new, 0.0))
        visits[rows, parent] += on.to(dt)
        visits[rows, child] += on.to(dt)
        G = torch.where(on, G_new, G)
    return visits, values


def best_child_mean(ch_visits, ch_values, exists) -> torch.Tensor:
    """(S, K) each child's own mean value, −inf at an empty slot."""
    v = ch_visits.to(torch.float64)
    return torch.where(exists, ch_values.to(torch.float64) / torch.clamp(v, min=1e-30),
                       float("-inf"))


# ------------------------------------------------------------ the search

class _Node:
    __slots__ = ("P", "pos", "budget", "action", "visits", "value", "children", "root")

    def __init__(self, P, pos, budget, action=-1, root=False):
        self.P, self.pos, self.budget, self.action = P, pos, budget, action
        self.visits, self.value = 0.0, 0.0
        self.children: List["_Node"] = []
        self.root = root


def search(world: RefWorld, hp: Dict, cov, mean, pos, budget, draws: Dict) -> List[Dict]:
    """The search of every mission, float64, one tree each: cov (B, N, N),
    mean (B, N), pos (B, 3), budget (B,); ``draws`` the program's injected
    draws by kind, select (S, Hc, B, K), expand (S, Hc, B, A), expand_u
    (S, Hc, B), rollout (S, H, B, A), rollout_u (S, H, B).  Per mission:
    the root's visits, its children's actions, visits and value sums in
    the order they were made, and the action taken."""
    out = []
    for b in range(cov.shape[0]):
        out.append(_search_one(world, hp, cov[b:b + 1], mean[b:b + 1], pos[b:b + 1],
                               budget[b:b + 1], {k: v[:, :, b:b + 1] for k, v in draws.items()}))
    return out


def _search_one(world, hp, cov, mean, pos, budget, draws) -> Dict:
    f64 = torch.float64
    res = float(world.res)
    H, Hc = hp["horizon"], hp["horizon"] + 1
    K = max_children(world, hp)
    root = _Node(cov.to(world.device, f64), pos.to(world.device, f64),
                 budget.to(world.device, f64), root=True)
    empty = _Node(None, None, None)  # departure 5: never visited, never a parent

    for i in range(hp["simulations"]):
        node, P, at, left, depth = root, root.P, root.pos, root.budget, 0
        path: List = []  # (child, reward)
        leaf: Optional[_Node] = None
        for j in range(Hc):
            terminal = depth >= H or float(left) < res
            fresh = node is not root and node.visits == 0
            if terminal or fresh:
                if fresh and not terminal and node is not empty:
                    leaf = node
                break
            c = costs(world, at)
            avail = available(world, hp, at, left)
            n = len(node.children)
            if bool(widens(hp, torch.tensor([n]), torch.tensor([node.visits]),
                           avail.sum(dim=-1).cpu(), K)[0]):
                a = policy_action(rewards(world, P, mean, at), avail, hp["epsilon_expand"],
                                  draws["expand"][i, j], draws["expand_u"][i, j])
                Q, _ = edge(world, P, a, mean)
                child = _Node(P - Q, world.xyz[a], left - c[0, a], action=int(a))
                node.children.append(child)
            else:
                ch = node.children
                pad, dev = K - len(ch), world.device
                slot = int(rand_argmax(uct_scores(
                    world, hp,
                    torch.tensor([[x.visits for x in ch] + [0.0] * pad], dtype=f64, device=dev),
                    torch.tensor([[x.value for x in ch] + [0.0] * pad], dtype=f64, device=dev),
                    torch.tensor([[x.action for x in ch] + [0] * pad], device=dev),
                    torch.arange(K, device=dev)[None] < len(ch),
                    torch.tensor([node.visits], dtype=f64, device=dev), at, left)[0],
                    draws["select"][i, j])[0])
                child = ch[slot] if slot < len(ch) else empty
                a = torch.tensor([child.action if slot < len(ch) else 0], device=world.device)
            _, gain = edge(world, P, a, mean)
            cost = c[0, a]
            path.append((child, float(gain[0] / (cost[0] + 1.0))))
            if child is not empty:
                P = child.P
            at, left, depth, node = world.xyz[a], left - cost, depth + 1, child

        # the rollout from where the descent stopped (departure 2)
        G, disc = 0.0, 1.0
        Pr, atr, leftr = P, at, left
        alive = True
        for k in range(H):
            alive = alive and float(leftr) >= res
            c = costs(world, atr)
            a = policy_action(rewards(world, Pr, mean, atr), available(world, hp, atr, leftr),
                              hp["epsilon_rollout"], draws["rollout"][i, k],
                              draws["rollout_u"][i, k])
            Q, gain = edge(world, Pr, a, mean)
            if alive:
                G += disc * float(gain[0] / (c[0, a][0] + 1.0))
                Pr, atr, leftr = Pr - Q, world.xyz[a], leftr - c[0, a]
            disc *= hp["gamma"]

        # the backup (departures 3, 5)
        ret = 0.0
        if leaf is not None:
            leaf.value += G
            leaf.visits += 1
            ret = G
        for kk in reversed(range(len(path))):
            child, reward = path[kk]
            parent = root if kk == 0 else path[kk - 1][0]
            parent = root if parent is empty else parent
            ret = reward + ret
            parent.value += ret
            parent.visits += 1
            (root if child is empty else child).visits += 1

    ch = root.children
    means = [x.value / max(x.visits, 1e-30) for x in ch]
    # departure 7: first best child by its own mean; no child: action 0
    action = ch[max(range(len(ch)), key=lambda s: (means[s], -s))].action if ch else 0
    return {"visits": root.visits, "actions": [x.action for x in ch],
            "child_visits": [x.visits for x in ch], "child_values": [x.value for x in ch],
            "action": action}

