"""Classic (non-neural) MCTS planner with progressive widening
(reference planning/mcts_mission.py:24-415).

Port of ``ipp_rl_tpu/planners/mcts_classic.py``.  The JAX package vmaps
one array tree per mission and root-parallel worker; here all of them run
in lockstep as one batch of R = B·W rows (mission-major: row b·W + w), and
the loops over simulations, descent steps, rollout steps and the backup
are Python loops over batched tensors, as in planners/zero/mcts.py.

Every descent step computes, for every row, done or not, the ε-greedy
expansion action with its all-action sweep, the UCT selection and the
edge; every rollout runs all of its horizon steps; ``where`` keeps what
counts (the JAX package computes the same).  So one replan launches, per
simulation, Hc + H sweeps (``ops/kalman.kf_sweep_gains_batched``, full
precision: the JAX planner's structured sweep takes no ``fast_math``) and
Hc + H edge updates (``ops/kalman.kf_edge_factor_gain``, one
``edge_factor_gain`` launch each), with Hc = horizon + 1.  The counter
``classic.lockstep_steps`` counts those steps (S·(Hc + H) a search) on
the host.

A lockstep step is some 150 launches, most of them small, and no
read-back: on a card the Python loop leaves gaps between them that vary
with the host's speed.  With injected draws on a CUDA device (and
``use_graphs``, the default) one simulation is captured once as a CUDA
graph (``_SimGraph``) and replayed S times a search, each replay after
the simulation's draws are copied into the graph's own inputs: the same
launches, on the same shapes, in the same order, so the same trees bit
for bit.  The tree a search returns is then the graph's own, valid until
the next search.  Draws from a generator, and the CPU, take the loop.

The reference's quirks that the JAX package keeps are kept here, each
marked with the JAX line it follows (``mcts_classic.py:<line>``).

Randomness: each lockstep step takes one draw of each kind, from a
``torch.Generator`` on the world's device or injected (``ClassicDraws``,
which a test fills from the JAX package's key chain).  A categorical over
logits is ``argmax(logits + gumbel)``, first index on ties, as
``jax.random.categorical``; where the logits are only 0 or −∞ (the UCT
tie-break, the ε-branch's uniform action) any continuous noise gives the
same choice law, and the generator draws uniforms there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ipp_rl_tpu_torch.config.schema import MissionConfig
from ipp_rl_tpu_torch.env.world import BeliefState, IPPWorld
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.ops.kalman import kf_edge_factor_gain, kf_sweep_gains_batched
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask, reward_from_gain
from ipp_rl_tpu_torch.planners.base import Planner
from ipp_rl_tpu_torch.planners.zero.mcts import rand_argmax
from ipp_rl_tpu_torch.utils import tracing
from ipp_rl_tpu_torch.utils.tracing import count, span

NO_NODE = -1


@dataclasses.dataclass
class CTree:
    """The forest: one classic-MCTS tree per row, node capacity C."""

    parent: torch.Tensor  # (R, C) long
    action_in: torch.Tensor  # (R, C) long
    wc_in: torch.Tensor  # (R, C, M, N) — edge factor Wcᵀ, transposed layout
    budget: torch.Tensor  # (R, C)
    visits: torch.Tensor  # (R, C)
    value_sum: torch.Tensor  # (R, C)
    num_children: torch.Tensor  # (R, C) long
    children: torch.Tensor  # (R, C, Cmax) long — child node ids
    next_free: torch.Tensor  # (R,) long


@dataclasses.dataclass
class ClassicDraws:
    """Injected random draws of one replan over R = B·W rows (S simulations
    per worker, Hc descent steps, H rollout steps, A actions, Cmax child
    slots)."""

    select: torch.Tensor  # (S, Hc, R, Cmax) Gumbel — UCT tie-break
    expand: torch.Tensor  # (S, Hc, R, A) Gumbel — the ε-branch's uniform action
    expand_u: torch.Tensor  # (S, Hc, R) uniform — ε-greedy coin
    rollout: torch.Tensor  # (S, H, R, A) Gumbel — the rollout's uniform action
    rollout_u: torch.Tensor  # (S, H, R) uniform — its coin
    rollout_gcb: Optional[torch.Tensor] = None  # (S, H, R, A) Gumbel, GCB rollouts only


@dataclasses.dataclass
class RootStats:
    """Per-row root statistics of a search."""

    visits: torch.Tensor  # (R, A) — children's visits summed by action
    values: torch.Tensor  # (R, A) — children's value sums summed by action
    best_child_action: torch.Tensor  # (R,) — action of the best child by its own mean


def gumbel(shape, generator, dtype, device) -> torch.Tensor:
    """Standard Gumbel draws −log(−log u), u uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


class ClassicMCTSPlanner(Planner):
    name = "mcts"

    def __init__(self, world: IPPWorld, mission_cfg: MissionConfig):
        super().__init__(world, mission_cfg)
        mc = mission_cfg
        self.num_workers = max(1, mc.num_mcts_workers)
        # num_simulations / num_workers per root (mcts_classic.py:60-62)
        self.num_simulations = max(1, mc.num_simulations // self.num_workers)
        self.gamma = mc.gamma
        self.c = mc.uct_c
        self.horizon = max(mc.episode_horizon, 2)
        self.k = mc.k
        self.alpha = mc.alpha
        self.eps_expand = mc.epsilon_expand
        self.eps_rollout = mc.epsilon_rollout
        self.max_greedy_radius = mc.horizontal_spacing
        self.use_gcb = mc.use_gcb_rollout
        self.max_children = min(world.num_actions, self.num_simulations + 1)
        self.use_graphs = True
        self._graph: Optional[_SimGraph] = None

    # ------------------------------------------------------------ helpers

    def _costs(self, pos: torch.Tensor) -> torch.Tensor:
        """(R, A) flight time from positions pos (R, 3) to every action."""
        uav = self.cfg.uav
        return travel_costs(self.world.actions_xyz, pos[:, None, :], uav.max_v, uav.max_a)

    def _available(self, costs: torch.Tensor, pos: torch.Tensor, budget: torch.Tensor):
        """Feasible actions: flight time within budget, distance-capped
        (mcts_classic.py:78-84)."""
        xyz = self.world.actions_xyz
        d = torch.sqrt(torch.sum(torch.square(xyz - pos[:, None, :]), dim=-1))
        return (costs > 0) & (costs <= budget[:, None]) & (d < self.max_greedy_radius)

    def _diag_mask(self, mean: torch.Tensor, P: torch.Tensor) -> Optional[torch.Tensor]:
        """The adaptive mask of the ROOT mean against the running covariance
        (mcts_classic.py:86-92)."""
        scen = self.cfg.scenario
        if not scen.adaptive:
            return None
        return adaptive_mask(mean, torch.diagonal(P, dim1=-2, dim2=-1),
                             scen.value_threshold, scen.interval_factor)

    def _edge(self, P, a, dmask) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Wcᵀ (R, M, N), masked gain (R,)) of taking actions a from P
        (mcts_classic.py:103-114): the world's H and R tables are exact
        for lattice actions, so one ``edge_factor_gain`` launch."""
        w = self.world
        with span("classic.edge"):
            return kf_edge_factor_gain(P, w.H, w.R_diag, a, dmask)

    @staticmethod
    def _downdate(P, WcT, keep) -> torch.Tensor:
        """P − Wc·Wcᵀ for the rows where ``keep`` (R,) is set, else P: the
        rank-M update along an edge (mcts_classic.py:154, :294)."""
        with span("classic.edge"):
            return torch.where(keep[:, None, None], P - WcT.mT @ WcT, P)

    def _sweep_rewards(self, P, costs, dmask) -> torch.Tensor:
        """(R, A) reward of every action against the covariances P (R, N, N)
        with flight costs (R, A) (mcts_classic.py:94-101): one all-action
        sweep in full precision, as the JAX planner's structured sweep."""
        with span("classic.sweep"):
            gains = kf_sweep_gains_batched(P, self.world.sweep_batched, dmask, fast_math=False)
            return reward_from_gain(gains, costs)

    def _policy_action(self, P, costs, avail, dmask, eps, g_rand, u_mode, g_soft) -> torch.Tensor:
        """ε-greedy (or, with ``g_soft``, GCB softmax) action of every row
        (mcts_classic.py:116-135) from the flight costs (R, A) and the
        feasible actions."""
        rewards = self._sweep_rewards(P, costs, dmask)
        # −∞ as a Python scalar: a tensor made from it would be a copy to
        # the card, which waits for the stream every step
        ninf = float("-inf")
        if g_soft is not None:
            return torch.argmax(torch.where(avail, rewards, ninf) + g_soft, dim=-1)
        any_avail = torch.any(avail, dim=-1)
        greedy = torch.argmax(torch.where(avail, rewards, ninf), dim=-1)
        rand_logits = torch.where(avail, torch.zeros_like(rewards), ninf)
        # a boxed-in row draws uniformly over all actions (:128-133)
        rand_logits = torch.where(any_avail[:, None], rand_logits, 0.0)
        rand_a = torch.argmax(rand_logits + g_rand, dim=-1)
        use_greedy = (u_mode > eps) & any_avail
        return torch.where(use_greedy, greedy, rand_a)

    def _uct_select(self, tree: CTree, node: torch.Tensor, costs, budget, noise) -> torch.Tensor:
        """UCT over the existing children of ``node`` (R,), already wrapped
        into [0, C), with the flight costs (R, A) from the node's position;
        returns the chosen child SLOT (mcts_classic.py:164-208)."""
        return rand_argmax(self._uct_scores(tree, node, costs, budget), noise)

    def _uct_scores(self, tree: CTree, node: torch.Tensor, costs, budget) -> torch.Tensor:
        """(R, Cmax) UCT scores of the child slots of ``node``: −inf at an
        empty or unaffordable slot, +inf at an unvisited child."""
        b = torch.arange(node.shape[0], device=node.device)
        Cmax = self.max_children
        cids = tree.children[b, node]  # (R, Cmax)
        exists = torch.arange(Cmax, device=node.device) < tree.num_children[b, node][:, None]
        cidx = torch.clamp(cids, min=0)
        child_visits = tree.visits.gather(1, cidx)
        cvis = torch.where(exists, child_visits, 1.0)
        cval = torch.where(exists, tree.value_sum.gather(1, cidx) / torch.clamp(cvis, min=1.0), 0.0)
        inf = float("inf")
        vmin = torch.where(exists, cval, inf).amin(dim=-1, keepdim=True)
        vmax = torch.where(exists, cval, -inf).amax(dim=-1, keepdim=True)
        # the reference's "normalisation" value − min/(max − min), an
        # operator-precedence slip kept verbatim (:176-191)
        norm = torch.where(
            vmax == 0,
            cval,
            torch.where(
                vmax == vmin,
                cval / torch.where(vmax == 0, 1.0, vmax),
                cval - vmin / torch.clamp(vmax - vmin, min=1e-30),
            ),
        )
        parent_visits = torch.clamp(tree.visits[b, node], min=1.0)
        explore = self.c * torch.sqrt(torch.log(parent_visits)[:, None]
                                      / torch.clamp(cvis, min=1e-30))
        # unvisited children +inf, unaffordable ones −inf (:194-204)
        uct = torch.where(child_visits == 0, inf, norm + explore)
        cost = costs.gather(1, torch.clamp(tree.action_in.gather(1, cidx), min=0))
        uct = torch.where((cost == 0) | (cost >= budget[:, None]), -inf, uct)
        return torch.where(exists, uct, -inf)

    # ----------------------------------------------------------- search

    def _init_tree(self, R: int, budget: torch.Tensor) -> CTree:
        C = self.num_simulations + 2  # the root, ≤ S allocations, and node C − 1 never allocated
        dt, dev = budget.dtype, budget.device
        m, n = self.world.H.shape[1], self.cfg.environment.num_cells

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        tree = CTree(
            parent=empty((R, C), torch.long),
            action_in=empty((R, C), torch.long),
            wc_in=empty((R, C, m, n), dt),
            budget=empty((R, C), dt),
            visits=empty((R, C), dt),
            value_sum=empty((R, C), dt),
            num_children=empty((R, C), torch.long),
            children=empty((R, C, self.max_children), torch.long),
            next_free=empty((R,), torch.long),
        )
        self._reset_tree(tree, budget)
        return tree

    @staticmethod
    def _reset_tree(tree: CTree, budget: torch.Tensor) -> None:
        """Every node empty but the roots, at ``budget``."""
        for field in dataclasses.fields(tree):
            empty = NO_NODE if field.name in ("parent", "action_in", "children") else 0
            getattr(tree, field.name).fill_(empty)
        tree.next_free.fill_(1)
        tree.budget[:, 0] = budget

    def _descend(self, tree: CTree, P_root, root_pos, mean, i, draws, generator):
        """The Hc lockstep descent steps of simulation ``i``
        (mcts_classic.py:244-310); returns the state after them."""
        R, dt, dev = P_root.shape[0], P_root.dtype, P_root.device
        A, Cmax, C = self.world.num_actions, self.max_children, tree.parent.shape[1]
        res = self.cfg.environment.resolution
        Hc = self.horizon + 1
        b = torch.arange(R, device=dev)
        node = torch.zeros((R,), dtype=torch.long, device=dev)
        P, pos, budget = P_root, root_pos, tree.budget[:, 0]
        depth = torch.zeros((R,), dtype=torch.long, device=dev)
        done = torch.zeros((R,), dtype=torch.bool, device=dev)
        rollout_node = torch.full((R,), NO_NODE, dtype=torch.long, device=dev)
        path_nodes = torch.full((R, Hc), NO_NODE, dtype=torch.long, device=dev)
        path_rewards = torch.zeros((R, Hc), dtype=dt, device=dev)
        path_len = torch.zeros((R,), dtype=torch.long, device=dev)
        for j in range(Hc):
            count("classic.lockstep_steps")
            if draws is not None:
                g_sel, g_exp, u_exp = draws.select[i, j], draws.expand[i, j], draws.expand_u[i, j]
            else:
                # the UCT tie-break and the ε-branch choose among logits 0
                # or −∞: any continuous noise gives their choice law
                g_sel = torch.rand((R, Cmax), generator=generator, dtype=dt, device=dev)
                g_exp = torch.rand((R, A), generator=generator, dtype=dt, device=dev)
                u_exp = torch.rand((R,), generator=generator, dtype=dt, device=dev)
            # a boxed-in step moves to node −1, which JAX's indexing wraps to
            # node C − 1, never allocated (:247, :256, :293)
            nw = torch.remainder(node, C)
            terminal = (depth >= self.horizon) | (budget < res)  # (:246)
            node_visits = tree.visits[b, nw]
            fresh = (node_visits == 0) & (node != 0)
            newly_done = ~done & (terminal | fresh)
            rollout_node = torch.where(newly_done & fresh & ~terminal, node, rollout_node)
            done = done | terminal | fresh

            # progressive widening (:251-261)
            costs = self._costs(pos)
            avail = self._available(costs, pos, budget)
            n_child = tree.num_children[b, nw]
            widen = (n_child == 0) | (
                (n_child.to(dt) <= self.k * node_visits ** self.alpha)
                & (n_child < torch.sum(avail, dim=-1))
                & (n_child < self.max_children)
            )
            dmask = self._diag_mask(mean, P)
            a_expand = self._policy_action(P, costs, avail, dmask, self.eps_expand, g_exp, u_exp,
                                           None)
            slot_sel = self._uct_select(tree, nw, costs, budget, g_sel)
            child_sel = tree.children[b, nw, slot_sel]  # −1 at an empty slot (:266-270)
            a = torch.where(widen, a_expand,
                            torch.clamp(tree.action_in[b, torch.clamp(child_sel, min=0)], min=0))
            WcT, gain = self._edge(P, a, dmask)
            cost = costs.gather(1, a[:, None])[:, 0].to(dt)
            reward = gain / (cost + 1.0)

            # allocate (:273-288): rows that do not widen write back what
            # they read, so node C − 1 stays empty
            dw = widen & ~done
            new = tree.next_free.clone()  # ≤ S: one allocation per simulation at most

            def put(t, idx, value):
                t[idx] = torch.where(dw.view((-1,) + (1,) * (value.ndim - 1)), value, t[idx])

            put(tree.parent, (b, new), node)
            put(tree.action_in, (b, new), a)
            put(tree.wc_in, (b, new), WcT)
            put(tree.budget, (b, new), budget - cost)
            put(tree.children, (b, nw, torch.clamp(n_child, max=Cmax - 1)), new)
            tree.num_children[b, nw] += dw
            tree.next_free += dw
            child = torch.where(dw, new, child_sel)

            move = ~done
            P = self._downdate(P, tree.wc_in[b, torch.remainder(child, C)], move)
            node = torch.where(move, child, node)
            pos = torch.where(move[:, None], self.world.actions_xyz[a], pos)
            budget = torch.where(move, budget - cost, budget)
            depth = torch.where(move, depth + 1, depth)
            path_nodes[:, j] = torch.where(move, child, NO_NODE)
            path_rewards[:, j] = torch.where(move, reward, 0.0)
            path_len = path_len + move
        return P, pos, budget, rollout_node, path_nodes, path_rewards, path_len

    def _rollout(self, P, pos, budget, mean, i, draws, generator) -> torch.Tensor:
        """ε-greedy / GCB rollout of every row over all H steps
        (mcts_classic.py:137-162); γ applies only here (:153)."""
        R, dt, dev = P.shape[0], P.dtype, P.device
        A = self.world.num_actions
        res = self.cfg.environment.resolution
        G = torch.zeros((R,), dtype=dt, device=dev)
        disc = torch.ones((), dtype=dt, device=dev)
        alive = torch.ones((R,), dtype=torch.bool, device=dev)
        for k in range(self.horizon):
            count("classic.lockstep_steps")
            g_soft = None
            if draws is not None:
                g_rand, u_mode = draws.rollout[i, k], draws.rollout_u[i, k]
                if self.use_gcb:
                    g_soft = draws.rollout_gcb[i, k]
            elif self.use_gcb:
                g_rand, u_mode = None, None
                g_soft = gumbel((R, A), generator, dt, dev)
            else:
                g_rand = torch.rand((R, A), generator=generator, dtype=dt, device=dev)
                u_mode = torch.rand((R,), generator=generator, dtype=dt, device=dev)
            alive = alive & (budget >= res)
            costs = self._costs(pos)
            dmask = self._diag_mask(mean, P)
            a = self._policy_action(P, costs, self._available(costs, pos, budget), dmask,
                                    self.eps_rollout, g_rand, u_mode, g_soft)
            WcT, gain = self._edge(P, a, dmask)
            cost = costs.gather(1, a[:, None])[:, 0]
            reward = gain / (cost + 1.0)
            G = G + torch.where(alive, disc * reward, 0.0)
            P = self._downdate(P, WcT, alive)
            pos = torch.where(alive[:, None], self.world.actions_xyz[a], pos)
            budget = torch.where(alive, budget - cost, budget)
            disc = disc * self.gamma
        return G

    def _backup(self, tree: CTree, rollout_node, rollout_value, path_nodes, path_rewards,
                path_len) -> None:
        """The reference's recursion (mcts_classic.py:321-362): the fresh
        leaf gets its rollout; on each edge the parent gets the return and a
        visit and the child another visit, so interior nodes are counted
        twice per traversal; interior edges add no discount (:348)."""
        b = torch.arange(rollout_node.shape[0], device=rollout_node.device)
        leaf_ok = rollout_node >= 0
        leaf = torch.clamp(rollout_node, min=0)
        one = leaf_ok.to(tree.visits.dtype)
        tree.value_sum[b, leaf] += torch.where(leaf_ok, rollout_value, 0.0)
        tree.visits[b, leaf] += one
        G = rollout_value
        Hc = path_nodes.shape[1]
        for kk in reversed(range(Hc)):
            on = kk < path_len
            step = on.to(tree.visits.dtype)
            # an empty-slot child (−1) is credited to the root (:347)
            parent = (torch.zeros_like(path_len) if kk == 0
                      else torch.clamp(path_nodes[:, kk - 1], min=0))
            child = torch.clamp(path_nodes[:, kk], min=0)
            G_new = path_rewards[:, kk] + G
            tree.value_sum[b, parent] += torch.where(on, G_new, 0.0)
            tree.visits[b, parent] += step
            tree.visits[b, child] += step
            G = torch.where(on, G_new, G)

    def root_stats(self, tree: CTree) -> RootStats:
        """Root children's statistics by action, and the action of the best
        child by its own mean value (mcts_classic.py:394-406)."""
        A = self.world.num_actions
        cids = tree.children[:, 0]
        exists = torch.arange(self.max_children, device=cids.device) < tree.num_children[:, :1]
        cidx = torch.clamp(cids, min=0)
        acts = torch.clamp(tree.action_in.gather(1, cidx), min=0)
        vis = torch.where(exists, tree.visits.gather(1, cidx), 0.0)
        val = torch.where(exists, tree.value_sum.gather(1, cidx), 0.0)
        # the sums by action as a one-hot contraction: a fixed summation
        # order, where a scatter-add on the card would sum in any order
        hot = (acts[..., None] == torch.arange(A, device=acts.device)).to(vis.dtype)
        vis_a = torch.sum(vis[..., None] * hot, dim=1)
        val_a = torch.sum(val[..., None] * hot, dim=1)
        child_val = torch.where(exists, val / torch.clamp(vis, min=1e-30), float("-inf"))
        best = acts.gather(1, torch.argmax(child_val, dim=-1, keepdim=True))[:, 0]
        return RootStats(visits=vis_a, values=val_a, best_child_action=best)

    def search(self, state: BeliefState, generator: Optional[torch.Generator] = None,
               draws: Optional[ClassicDraws] = None) -> Tuple[CTree, RootStats]:
        """S simulations on every row: W independent trees per mission, row
        b·W + w.  Draws come from ``generator`` (on the world's device;
        None uses torch's default), or from ``draws``."""
        W = self.num_workers

        def rows(x):
            return x.repeat_interleave(W, dim=0) if W > 1 else x

        with span("classic.search"):
            P_root, pos, mean = rows(state.cov), rows(state.pos), rows(state.mean)
            budget = rows(state.budget)
            if self.use_graphs and draws is not None and P_root.is_cuda:
                g = self._graph
                if g is None or not g.fits(P_root, draws):
                    self._graph = None  # free the old graph's pool first
                    g = self._graph = _SimGraph(self, P_root, pos, mean, budget, draws)
                tree = g.search(P_root, pos, mean, budget, draws)
            else:
                tree = self._init_tree(P_root.shape[0], budget)
                for i in range(self.num_simulations):
                    self._simulate(tree, P_root, pos, mean, i, draws, generator)
            with span("classic.backup"):
                return tree, self.root_stats(tree)

    def _simulate(self, tree: CTree, P_root, pos, mean, i, draws, generator) -> None:
        """Simulation ``i`` on every row: descent, rollout, backup."""
        with span("classic.descent"):
            P, leaf_pos, budget, rollout_node, path_nodes, path_rewards, path_len = (
                self._descend(tree, P_root, pos, mean, i, draws, generator))
        with span("classic.rollout"):
            G = self._rollout(P, leaf_pos, budget, mean, i, draws, generator)
        rollout_value = torch.where(rollout_node >= 0, G, 0.0)  # (:315-319)
        with span("classic.backup"):
            self._backup(tree, rollout_node, rollout_value, path_nodes, path_rewards, path_len)

    def plan(self, state: BeliefState, generator: Optional[torch.Generator], step: int,
             draws: Optional[ClassicDraws] = None) -> torch.Tensor:
        _, root = self.search(state, generator, draws)
        if self.num_workers == 1:
            # argmax of the PER-CHILD mean, duplicates unmerged (:407-428)
            return root.best_child_action
        # W > 1: per-action sums merged over the workers (:429-435)
        B, A = state.batch_size, self.world.num_actions
        vis = root.visits.view(B, self.num_workers, A).sum(dim=1)
        val = root.values.view(B, self.num_workers, A).sum(dim=1)
        mean_val = val / torch.clamp(vis, min=1e-30)
        return torch.argmax(torch.where(vis > 0, mean_val, float("-inf")), dim=-1)


class _SimGraph:
    """One simulation of ``ClassicMCTSPlanner`` over R rows captured as a
    CUDA graph, with the tree, the root's belief and one simulation's draws
    as its own inputs (``search`` fills them, then replays the graph once a
    simulation).  The capture counts nothing and records no span; each
    replay adds to the counters what the capture's Python counted
    (``classic.lockstep_steps``, the kernels' launches)."""

    _DRAWS = tuple(f.name for f in dataclasses.fields(ClassicDraws))

    def __init__(self, planner: ClassicMCTSPlanner, P_root, pos, mean, budget,
                 draws: ClassicDraws):
        self.planner = planner
        self.P_root, self.pos, self.mean = P_root.clone(), pos.clone(), mean.clone()
        self.tree = planner._init_tree(P_root.shape[0], budget)
        self.draws = ClassicDraws(**{
            k: None if getattr(draws, k) is None else getattr(draws, k)[:1].clone()
            for k in self._DRAWS})
        self.key = self._key(P_root, draws)
        side = torch.cuda.Stream(P_root.device)
        side.wait_stream(torch.cuda.current_stream(P_root.device))
        with tracing.suspended(), torch.cuda.stream(side):
            self._body()  # loads what the launches load, off the capture
        torch.cuda.current_stream(P_root.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with tracing.suspended() as self.counted, torch.cuda.graph(self.graph):
            self._body()

    @classmethod
    def _key(cls, P_root, draws: ClassicDraws):
        shapes = tuple(None if getattr(draws, k) is None else tuple(getattr(draws, k).shape[1:])
                       for k in cls._DRAWS)
        return tuple(P_root.shape), P_root.dtype, P_root.device, shapes

    def fits(self, P_root, draws: ClassicDraws) -> bool:
        return self._key(P_root, draws) == self.key

    def _body(self) -> None:
        self.planner._simulate(self.tree, self.P_root, self.pos, self.mean, 0, self.draws, None)

    def search(self, P_root, pos, mean, budget, draws: ClassicDraws) -> CTree:
        self.P_root.copy_(P_root)
        self.pos.copy_(pos)
        self.mean.copy_(mean)
        self.planner._reset_tree(self.tree, budget)
        for i in range(self.planner.num_simulations):
            for k in self._DRAWS:
                if getattr(draws, k) is not None:
                    getattr(self.draws, k)[0].copy_(getattr(draws, k)[i])
            with span("classic.simulation"):
                self.graph.replay()
            for name, n in self.counted.items():
                count(name, n)
        return self.tree
