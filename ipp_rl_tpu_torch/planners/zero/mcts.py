"""Batched neural PUCT search — the flagship planner's engine.

Port of ``ipp_rl_tpu/planners/zero/mcts.py``.  The JAX package runs one
jitted program over a vmapped mission batch; here every array carries the
mission axis B explicitly and the loops are Python loops:

  * array tree: preallocated per-mission node arrays (B, C, …) with
    capacity C = simulations + 2 — the root, at most one allocation per
    simulation, and a DUMP slot C − 1 that takes the masked writes of
    missions that allocate nothing (never allocated, never read);
  * covariances are never stored per node: each edge stores its rank-M
    whitened gain factor Wcᵀ (P_child = P_parent − Wc·Wcᵀ), and the
    descent rebuilds the running covariance;
  * the edge update runs two GEMMs and then one hand-written kernel
    (ops/kernels.edge_factor_gain) from the innovation to the edge
    factor and its gain;
  * all missions' leaves go through one batched network forward per
    simulation;
  * KataGo's min-max-normalised Q in PUCT, forced playouts √(k·P·N) at
    the root, Dirichlet root noise on the first expansion and the
    closed-form policy-target pruning are kept as in the JAX package.

Writes into the tree are per-mission row scatters with the mission index
``arange(B)``, one index per mission, so they are deterministic.  The
tree is updated in place.  The early-exit descent reads one flag from
the device per step (``done.all()``).

Randomness: every uniform choice among tied maxima is the argmax of
continuous noise on the tied entries (``rand_argmax``), drawn from a
``torch.Generator`` or injected (``SearchDraws``), as is the Dirichlet
root noise: a test feeds the JAX package's own draws (its categorical is
the argmax of Gumbel noise) and gets its choices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ipp_rl_tpu_torch.config.schema import MCTSZeroHyperParams
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.ops.geometry import travel_costs
from ipp_rl_tpu_torch.ops.kalman import kf_edge_factor_gain
from ipp_rl_tpu_torch.ops.rewards import adaptive_mask
from ipp_rl_tpu_torch.planners.zero.features import EpisodeHistory, feature_planes, push_history
from ipp_rl_tpu_torch.planners.zero.train import cast_variables
from ipp_rl_tpu_torch.utils.tracing import count, span

NO_CHILD = -1
ROOT_ACTION = -1


@dataclasses.dataclass
class Tree:
    """The forest: one search tree per mission, node capacity C."""

    parent: torch.Tensor  # (B, C) long
    action_in: torch.Tensor  # (B, C) long — lattice action taken from the parent
    reward_in: torch.Tensor  # (B, C) — edge reward (info gain / (cost + 1))
    wc_in: torch.Tensor  # (B, C, M, N) — edge whitened gain factor, transposed
    budget: torch.Tensor  # (B, C) — remaining budget at the node
    depth: torch.Tensor  # (B, C) long
    expanded: torch.Tensor  # (B, C) bool — network-evaluated
    children: torch.Tensor  # (B, C, A) long
    Nsa: torch.Tensor  # (B, C, A)
    Qsa: torch.Tensor  # (B, C, A)
    prior: torch.Tensor  # (B, C, A)
    valid: torch.Tensor  # (B, C, A) bool
    Ns: torch.Tensor  # (B, C)
    next_free: torch.Tensor  # (B,) long


def init_tree(
    batch_size: int, num_sims: int, num_actions: int, n: int, m: int,
    dtype: torch.dtype, edge_dtype: Optional[torch.dtype] = None,
    device: str | torch.device = "cuda",
) -> Tree:
    B, c, A = batch_size, num_sims + 2, num_actions
    device = resolve_device(device)

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    return Tree(
        parent=full((B, c), NO_CHILD, torch.long),
        action_in=full((B, c), ROOT_ACTION, torch.long),
        reward_in=full((B, c), 0, dtype),
        wc_in=full((B, c, m, n), 0, edge_dtype or dtype),
        budget=full((B, c), 0, dtype),
        depth=full((B, c), 0, torch.long),
        expanded=full((B, c), False, torch.bool),
        children=full((B, c, A), NO_CHILD, torch.long),
        Nsa=full((B, c, A), 0, dtype),
        Qsa=full((B, c, A), 0, dtype),
        prior=full((B, c, A), 0, dtype),
        valid=full((B, c, A), False, torch.bool),
        Ns=full((B, c), 0, dtype),
        next_free=full((B,), 1, torch.long),
    )


@dataclasses.dataclass
class SearchDraws:
    """Injected random draws of one search over B missions."""

    select: torch.Tensor  # (sims, Hc, B, A) — tie-break noise of every descent step
    root_noise: Optional[torch.Tensor] = None  # (B, A) — the Dirichlet root noise


@dataclasses.dataclass
class _Descent:
    """Per-mission descent state of one simulation (ZeroMCTS._descend_step)."""

    node: torch.Tensor  # (B,)
    P: torch.Tensor  # (B, N, N) running covariance
    budget: torch.Tensor  # (B,)
    prev_pos: torch.Tensor  # (B, 3)
    depth: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,) stop descending
    leaf: torch.Tensor  # (B,) node to evaluate (−1: terminal)
    path_nodes: torch.Tensor  # (B, Hc)
    path_actions: torch.Tensor  # (B, Hc)
    path_rewards: torch.Tensor  # (B, Hc)
    path_covs: torch.Tensor  # (B, Hc, N, N) — P after each move
    path_bfr: torch.Tensor  # (B, Hc) — budget fraction after each move
    path_len: torch.Tensor  # (B,)


def read_flag(flag: torch.Tensor) -> bool:
    """``bool(flag)``: a read from the device, which waits for it; counted
    as one of the host's syncs (``host_syncs``)."""
    count("host_syncs")
    return bool(flag)


def normalize_q(values: torch.Tensor) -> torch.Tensor:
    """Min-max normalisation over the last axis with the reference's
    degenerate rules (reference mcts.py:267-278): all zero → zeros;
    min == max → v / max."""
    lo = values.amin(dim=-1, keepdim=True)
    hi = values.amax(dim=-1, keepdim=True)
    all_zero = (values == 0).all(dim=-1, keepdim=True)
    safe_hi = torch.where(hi == 0, torch.ones_like(hi), hi)
    out = torch.where(lo == hi, values / safe_hi, (values - lo) / (hi - lo))
    return torch.where(all_zero, values, out)


def rand_argmax(scores: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """Uniform choice among the maxima of each row of ``scores`` (reference
    mcts.py:236 np.random.choice): the argmax of the continuous noise
    ``draws`` (same shape) on the tied entries."""
    is_max = scores == scores.amax(dim=-1, keepdim=True)
    return torch.argmax(torch.where(is_max, draws, float("-inf")), dim=-1)


def standard_gamma(alpha: float, shape, generator, dtype, device) -> torch.Tensor:
    """Gamma(alpha, 1) draws from ``generator`` (torch.distributions takes
    none): Marsaglia–Tsang for alpha ≥ 1, and for alpha < 1 a Gamma(alpha + 1)
    draw scaled by U^(1/alpha)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=dtype, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while read_flag(todo.any()):
        x = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.clamp(v, min=torch.finfo(dtype).tiny))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
    if alpha < 1.0:
        u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        out = out * u ** (1.0 / alpha)
    return out


def dirichlet(alpha: float, shape, generator, dtype, device) -> torch.Tensor:
    """Symmetric Dirichlet(alpha) draws over the last axis of ``shape``."""
    g = standard_gamma(alpha, shape, generator, dtype, device)
    return g / g.sum(dim=-1, keepdim=True)


class ZeroMCTS:
    """Batched PUCT search bound to a world and a network.

    ``search`` runs ``num_simulations`` lockstep simulations for B
    missions and returns the trees (reference mcts.py:83-143 get_policy)."""

    def __init__(
        self,
        world,
        hp: MCTSZeroHyperParams,
        episode_horizon: int,
        predict_fn,  # (variables, planes (B, S, S, C), masks (B, A)) -> (policy, value)
        edge_dtype: Optional[torch.dtype] = None,
        eval_chunk: int = 0,
    ):
        """``edge_dtype`` (e.g. torch.bfloat16) stores the per-edge gain
        factors Wcᵀ, the largest tree array (B, C, M, N), at that width;
        the descent casts them back, and the edge reward is computed from
        the *rounded* factor so the gains backed up stay consistent with
        the covariances the descent rebuilds.

        ``eval_chunk`` > 0 builds the leaf planes and runs the network in
        chunks of that many missions (the last padded with leading rows),
        which bounds the activations' peak memory by the chunk."""
        self.world = world
        self.hp = hp
        self.horizon = episode_horizon
        self.predict = predict_fn
        self.edge_dtype = edge_dtype
        self.eval_chunk = eval_chunk
        cfg = world.cfg
        self.A = world.num_actions
        self.N = cfg.environment.num_cells
        self.M = world.H.shape[1]
        self.L = hp.input_history_length

    # ----------------------------------------------------------- primitives

    def valid_actions(self, pos: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
        """(B, A) distance-gated feasibility (reference mcts.py:148-153:
        Euclidean distance against the budget and
        max_valid_action_distance)."""
        d = torch.sqrt(torch.sum(torch.square(self.world.actions_xyz - pos[:, None, :]), dim=-1))
        return (d > 0) & (d <= budget[:, None]) & (d < self.hp.max_valid_action_distance)

    def edge_update(
        self, P: torch.Tensor, a: torch.Tensor, diag_mask: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Covariance-only KF update for actions ``a`` (B,) against the
        running covariances P (B, N, N): returns (Wcᵀ (B, M, N), gain (B,))
        — one simulate_prediction_step per mission (reference
        planning/common/optimization.py:14-30).  Edges stored in bfloat16
        are rounded before the gain; other edge dtypes are refused."""
        edge_dt = self.edge_dtype
        if edge_dt not in (None, P.dtype, torch.bfloat16):
            raise ValueError(f"edge_dtype must be None, bfloat16 or {P.dtype}, got {edge_dt}")
        return kf_edge_factor_gain(P, self.world.H, self.world.R_diag, a, diag_mask,
                                   round_bf16=edge_dt is not None and edge_dt != P.dtype)

    def flight_cost(self, prev_pos: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """Flight time from arbitrary positions to actions ``a`` (the budget
        falls by flight time, reference mcts.py:249)."""
        cfg = self.world.cfg
        return travel_costs(self.world.actions_xyz[a], prev_pos, cfg.uav.max_v, cfg.uav.max_a)

    def puct(self, tree: Tree, node: torch.Tensor, puct_init, force: torch.Tensor) -> torch.Tensor:
        """(B, A) PUCT scores at nodes ``node`` (B,) (reference
        mcts.py:280-296)."""
        hp = self.hp
        b = torch.arange(node.shape[0], device=node.device)
        Nsa, prior = tree.Nsa[b, node], tree.prior[b, node]
        q = normalize_q(tree.Qsa[b, node])
        ns = tree.Ns[b, node][:, None]
        c = puct_init + torch.log((ns + hp.puct_base + 1.0) / hp.puct_base)
        uct = q + c * prior * (torch.sqrt(ns + 1.0) / (1.0 + Nsa))
        num_forced = torch.ceil(torch.sqrt(hp.forced_playout_factor * prior * ns))
        num_forced = torch.where(Nsa == 0, 0.0, num_forced)
        forced = force[:, None] & (Nsa < num_forced)
        uct = torch.where(forced, float("inf"), uct)
        return torch.where(tree.valid[b, node], uct, float("-inf"))

    # ------------------------------------------------------------ simulation

    def _descend_init(self, tree: Tree, P_root, root_pos) -> _Descent:
        B, N = P_root.shape[0], P_root.shape[-1]
        dt, dev = tree.Qsa.dtype, P_root.device
        Hc = self.horizon + 1  # most edges on a path
        zeros = torch.zeros((B,), dtype=torch.long, device=dev)
        return _Descent(
            node=zeros,
            P=P_root,
            budget=tree.budget[:, 0],
            prev_pos=root_pos,
            depth=zeros,
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            leaf=torch.full((B,), -1, dtype=torch.long, device=dev),
            path_nodes=torch.full((B, Hc), NO_CHILD, dtype=torch.long, device=dev),
            path_actions=torch.full((B, Hc), ROOT_ACTION, dtype=torch.long, device=dev),
            path_rewards=torch.zeros((B, Hc), dtype=dt, device=dev),
            path_covs=torch.zeros((B, Hc, N, N), dtype=dt, device=dev),
            path_bfr=torch.zeros((B, Hc), dtype=dt, device=dev),
            path_len=zeros,
        )

    def _descend_step(self, i: int, tree: Tree, c: _Descent, draws, diag_mask, puct_init,
                      forced_playouts: bool) -> _Descent:
        """One descent step of every mission (fully masked where done)."""
        count("zero.descent_steps")
        world = self.world
        dt = tree.Qsa.dtype
        b = torch.arange(c.node.shape[0], device=c.node.device)
        # terminal: past the horizon or out of budget; an unexpanded node
        # is the network's leaf
        terminal = (c.depth > self.horizon) | (c.budget <= 0)
        is_leaf = ~tree.expanded[b, c.node] & ~terminal
        newly_done = ~c.done & (terminal | is_leaf)
        leaf = torch.where(newly_done & is_leaf, c.node, c.leaf)
        done = c.done | terminal | is_leaf

        uct = self.puct(tree, c.node, puct_init, force=(c.depth == 0) & forced_playouts)
        a = rand_argmax(uct, draws)

        # edge dynamics (discarded where done)
        WcT, gain = self.edge_update(c.P, a, diag_mask)
        cost = self.flight_cost(c.prev_pos, a).to(dt)
        reward = gain / (cost + 1.0)

        existing = tree.children[b, c.node, a]
        need_new = (existing == NO_CHILD) & ~done
        child = torch.where(need_new, tree.next_free, existing)
        # allocate with unconditional row writes: a mission that allocates
        # nothing writes the dump slot C − 1
        dump = tree.parent.shape[1] - 1
        w = torch.where(need_new, tree.next_free, dump)
        tree.parent[b, w] = c.node
        tree.action_in[b, w] = a
        tree.reward_in[b, w] = reward
        tree.wc_in[b, w] = WcT.to(tree.wc_in.dtype)
        tree.budget[b, w] = c.budget - cost
        tree.depth[b, w] = c.depth + 1
        tree.children[b, c.node, a] = child
        tree.next_free += need_new

        # move into the child and subtract its edge factor from P
        move = ~done
        child_row = torch.where(child < 0, dump, child)  # read only where moving
        wc = tree.wc_in[b, child_row].to(c.P.dtype)  # (B, M, N)
        P_next = torch.where(move[:, None, None], c.P - wc.mT @ wc, c.P)
        budget_next = torch.where(move, tree.budget[b, child_row], c.budget)
        c.path_nodes[:, i] = torch.where(move, c.node, NO_CHILD)
        c.path_actions[:, i] = torch.where(move, a, ROOT_ACTION)
        c.path_rewards[:, i] = torch.where(move, tree.reward_in[b, child_row], 0.0)
        # P_next equals c.P where not moving; slots ≥ path_len are never read
        c.path_covs[:, i] = P_next
        c.path_bfr[:, i] = budget_next / float(world.cfg.constraints.budget)
        return dataclasses.replace(
            c,
            node=torch.where(move, child, c.node),
            P=P_next,
            budget=budget_next,
            prev_pos=torch.where(move[:, None], world.actions_xyz[a], c.prev_pos),
            depth=torch.where(move, c.depth + 1, c.depth),
            done=done,
            leaf=leaf,
            path_len=torch.where(move, c.path_len + 1, c.path_len),
        )

    def _leaf_outputs(self, c: _Descent, hist_root: EpisodeHistory, root_pos: torch.Tensor):
        """The leaf's history ring from the path snapshots and the
        root-pushed episode history: ring[j] is path entry plen − 1 − j
        while that exists, else hist_root[j − plen].  Returns (history,
        valid-action mask (B, A), leaf position (B, 3))."""
        with span("zero.leaf"):
            L = self.L
            xyz = self.world.actions_xyz
            plen = c.path_len[:, None]
            js = torch.arange(L, device=plen.device)[None, :]
            kk = plen - 1 - js  # (B, L)
            on_path = kk >= 0
            p_sel = torch.clamp(kk, min=0)
            h_sel = torch.clamp(js - plen, 0, L - 1)
            rows = torch.arange(plen.shape[0], device=plen.device)[:, None]
            path_pos = xyz[torch.clamp(c.path_actions.gather(1, p_sel), min=0)]
            hist_leaf = EpisodeHistory(
                covs=torch.where(on_path[..., None, None], c.path_covs[rows, p_sel],
                                 hist_root.covs[rows, h_sel]),
                positions=torch.where(on_path[..., None], path_pos,
                                      hist_root.positions[rows, h_sel]),
                budgets=torch.where(on_path, c.path_bfr.gather(1, p_sel),
                                    hist_root.budgets.gather(1, h_sel)),
                length=torch.clamp(hist_root.length + c.path_len, max=L).to(torch.int32),
            )
            # leaf planes are inference only: build the ring at the inference
            # dtype so the plane build is half-width end to end
            infer_dt = getattr(self.predict, "infer_dtype", None)
            if infer_dt is not None:
                hist_leaf = hist_leaf.replace(
                    covs=hist_leaf.covs.to(infer_dt),
                    positions=hist_leaf.positions.to(infer_dt),
                    budgets=hist_leaf.budgets.to(infer_dt),
                )
            last = c.path_actions.gather(1, torch.clamp(plen - 1, min=0))[:, 0]
            leaf_pos = torch.where(plen > 0, xyz[torch.clamp(last, min=0)], root_pos)
            return hist_leaf, self.valid_actions(leaf_pos, c.budget), leaf_pos

    def leaf_planes(self, hist_leaf: EpisodeHistory, mean: torch.Tensor) -> torch.Tensor:
        """(B, N, N, C) planes of the leaves (planners/zero/features.py)."""
        with span("zero.leaf"):
            infer_dt = getattr(self.predict, "infer_dtype", None)
            if infer_dt is not None:
                # every plane-build operand at the inference dtype, so no op
                # promotes back to float32
                mean = mean.to(infer_dt)
            return feature_planes(self.world, self.hp, hist_leaf, mean=mean)

    def _forward(self, variables, planes: torch.Tensor, mask: torch.Tensor):
        """The network's forward over the leaves' planes (``predict``),
        counted with its batch rows."""
        count("zero.forwards")
        count("zero.forward_samples", planes.shape[0])
        with span("zero.forward"):
            return self.predict(variables, planes, mask)

    def _eval_leaves(self, variables, hist_leaf: EpisodeHistory, leaf_mask, mean, dt):
        """Plane build + batched network forward, in mission chunks of
        ``eval_chunk`` when that is set and smaller than the batch."""
        B, G = leaf_mask.shape[0], self.eval_chunk
        if not (G and B > G):
            return self._forward(variables, self.leaf_planes(hist_leaf, mean), leaf_mask.to(dt))
        # pad to whole chunks by repeating leading rows (pad < G < B)
        pad = (-B) % G
        if pad:
            def cat(x):
                return torch.cat([x, x[:pad]], dim=0)

            hist_leaf, leaf_mask, mean = hist_leaf.map(cat), cat(leaf_mask), cat(mean)
        policies, values = [], []
        for start in range(0, B + pad, G):
            part = slice(start, start + G)
            pol, val = self._forward(variables,
                                     self.leaf_planes(hist_leaf.map(lambda x: x[part]),
                                                      mean[part]),
                                     leaf_mask[part].to(dt))
            policies.append(pol)
            values.append(val)
        return torch.cat(policies)[:B], torch.cat(values)[:B]

    def _integrate_eval(self, tree: Tree, leaf, policy, value, leaf_mask, is_root_first,
                        noise) -> torch.Tensor:
        """Store the network prior and the valid mask at each leaf
        (reference mcts.py:185-233), with the Dirichlet noise added at the
        root's first evaluation (:160-164, 221-222); returns the leaf
        values to back up (0 at terminal leaves)."""
        with span("zero.backup"):
            hp = self.hp
            dt = tree.prior.dtype
            b = torch.arange(leaf.shape[0], device=leaf.device)
            leaf_ok = leaf >= 0
            idx = torch.clamp(leaf, min=0)
            lm = leaf_mask.to(dt)

            p = policy.to(dt) * lm
            p_noised = (1.0 - hp.dirichlet_eps) * p + hp.dirichlet_eps * noise.to(dt)
            p = torch.where((is_root_first & leaf_ok)[:, None], p_noised * lm, p)
            s = torch.sum(p, dim=-1, keepdim=True)
            # degenerate-policy repair (reference mcts.py:224-229)
            p = torch.where(s > 0, p / torch.clamp(s, min=1e-30), lm)
            p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)

            no_valid = torch.sum(leaf_mask, dim=-1) == 0
            ok = leaf_ok & ~no_valid
            value_out = torch.where(ok, value, 0.0)
            tree.prior[b, idx] = torch.where(ok[:, None], p, tree.prior[b, idx])
            tree.valid[b, idx] = torch.where(ok[:, None], leaf_mask, tree.valid[b, idx])
            tree.expanded[b, idx] = ok | tree.expanded[b, idx]
            tree.Ns[b, idx] = torch.where(ok, 0.0, tree.Ns[b, idx])
            return value_out

    def _backup(self, tree: Tree, c: _Descent, leaf_value: torch.Tensor, steps: int) -> None:
        """G_k = r_k + γ·G_{k+1} backwards along each path; Q ← (N·Q + G)/(N+1)
        (reference mcts.py:250-265).  Paths are at most ``steps`` edges
        long (the descent's step count); entries past a path's length are
        masked no-ops."""
        with span("zero.backup"):
            gamma = self.hp.gamma
            b = torch.arange(leaf_value.shape[0], device=leaf_value.device)
            G = leaf_value
            for k in reversed(range(steps)):
                on = k < c.path_len
                node = torch.clamp(c.path_nodes[:, k], min=0)
                a = torch.clamp(c.path_actions[:, k], min=0)
                G_new = c.path_rewards[:, k] + gamma * G
                nsa, q = tree.Nsa[b, node, a], tree.Qsa[b, node, a]
                q_new = torch.where(nsa > 0, (nsa * q + G_new) / (nsa + 1.0), G_new)
                step = on.to(tree.Nsa.dtype)
                tree.Qsa[b, node, a] = torch.where(on, q_new, q)
                tree.Nsa[b, node, a] = nsa + step
                tree.Ns[b, node] = tree.Ns[b, node] + step
                G = torch.where(on, G_new, G)

    # --------------------------------------------------------------- search

    def search(
        self,
        cov: torch.Tensor,  # (B, N, N) root covariances
        mean: torch.Tensor,  # (B, N) root means
        pos: torch.Tensor,  # (B, 3) current positions
        budget: torch.Tensor,  # (B,)
        history: EpisodeHistory,  # (B,)-batched episode history
        net_variables=None,
        puct_init: Optional[float] = None,
        dirichlet_alpha: Optional[float] = None,
        num_simulations: Optional[int] = None,
        forced_playouts: bool = True,
        root_noise: bool = True,
        generator: Optional[torch.Generator] = None,
        draws: Optional[SearchDraws] = None,
    ) -> Tuple[Tree, torch.Tensor]:
        """Run the search; returns the trees and the (B, A) root valid-action
        masks.

        ``forced_playouts`` / ``root_noise`` switch off the KataGo root
        forced playouts and the Dirichlet root noise; the reference keeps
        both on at deploy time (ZeroPlanner deploy_mode "reference").
        Draws come from ``generator`` (on the world's device; None uses
        torch's default), or from ``draws``."""
        hp = self.hp
        B, dt, dev = cov.shape[0], cov.dtype, cov.device
        sims = num_simulations or hp.num_mcts_simulations
        p_init = float(hp.puct_init if puct_init is None else puct_init)
        alpha = hp.dirichlet_alpha if dirichlet_alpha is None else dirichlet_alpha

        tree = init_tree(B, sims, self.A, self.N, self.M, dt, self.edge_dtype, dev)
        tree.budget[:, 0] = budget
        root_mask = self.valid_actions(pos, budget)

        # the inference-dtype weight cast, once for the whole search
        infer_dt = getattr(self.predict, "infer_dtype", None)
        if infer_dt is not None:
            net_variables = cast_variables(net_variables, infer_dt)

        # Dirichlet root noise: only the first root evaluation applies it
        if not root_noise:
            noise = torch.zeros((B, self.A), dtype=dt, device=dev)
        elif draws is not None:
            noise = draws.root_noise.to(dt)
        else:
            noise = dirichlet(alpha, (B, self.A), generator, dt, dev)

        # the root-pushed history ring is the same for every simulation
        budget_frac = budget / float(self.world.cfg.constraints.budget)
        hist_root = push_history(history, cov, pos, budget_frac)

        # the adaptive mask of the ROOT state, constant across the search
        # (reference mcts.py:73-81 get_adaptive_info)
        dmask = None
        if self.world.cfg.scenario.adaptive:
            scen = self.world.cfg.scenario
            dmask = adaptive_mask(mean, torch.diagonal(cov, dim1=-2, dim2=-1),
                                  scen.value_threshold, scen.interval_factor)

        Hc = self.horizon + 1
        first = torch.ones((B,), dtype=torch.bool, device=dev)
        for i in range(sims):
            c = self._descend_init(tree, cov, pos)
            # early exit: stop once every mission reached its leaf (one
            # flag read from the device per step)
            j = 0
            with span("zero.descent"):
                while j < Hc and (j == 0 or not read_flag(c.done.all())):
                    if draws is not None:
                        u = draws.select[i, j]
                    else:
                        u = torch.rand((B, self.A), generator=generator, dtype=dt, device=dev)
                    c = self._descend_step(j, tree, c, u, dmask, p_init, forced_playouts)
                    j += 1
            hist_leaf, leaf_mask, _ = self._leaf_outputs(c, hist_root, pos)
            policy, value = self._eval_leaves(net_variables, hist_leaf, leaf_mask, mean, dt)
            is_root_first = first & (c.leaf == 0) & root_noise
            leaf_value = self._integrate_eval(tree, c.leaf, policy, value, leaf_mask,
                                              is_root_first, noise)
            self._backup(tree, c, leaf_value, j)
            first = first & (c.leaf != 0)
        return tree, root_mask

    # ------------------------------------------------------- policy readout

    def root_policy(
        self,
        tree: Tree,
        temperature,
        deploy_time: bool = False,
        puct_init: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        draws: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, A) visit-count policy with forced-playout pruning (training)
        or raw visits (deploy) (reference mcts.py:96-143).  ``draws``
        (2, B, A): the tie-break noise of the pruning's argmax and of the
        temperature-0 argmax."""
        Nsa0 = tree.Nsa[:, 0]
        dt, dev = Nsa0.dtype, Nsa0.device
        if draws is None:
            draws = torch.rand((2,) + Nsa0.shape, generator=generator, dtype=dt, device=dev)
        p_init = float(self.hp.puct_init if puct_init is None else puct_init)
        visits = Nsa0
        if not deploy_time:
            visits = self.prune_forced_visits(tree, visits, draws[0], p_init)
        total = torch.sum(visits, dim=-1, keepdim=True)
        temperature = torch.as_tensor(temperature, dtype=dt, device=dev)
        one_hot = torch.zeros_like(visits)
        one_hot[torch.arange(visits.shape[0], device=dev), rand_argmax(visits, draws[1])] = 1.0
        v = torch.where(temperature == 0.0, one_hot,
                        visits ** (1.0 / torch.clamp(temperature, min=1e-8)))
        temp_policy = v / torch.clamp(torch.sum(v, dim=-1, keepdim=True), min=1e-30)
        # degenerate case: no visited root action (reference :130-132)
        fallback = tree.valid[:, 0].to(dt)
        fallback = fallback / torch.clamp(torch.sum(fallback, dim=-1, keepdim=True), min=1e-30)
        return torch.where(total > 0, temp_policy, fallback)

    def prune_forced_visits(self, tree: Tree, visits: torch.Tensor, draws: torch.Tensor,
                            puct_init) -> torch.Tensor:
        """Closed-form policy-target pruning (reference mcts.py:99-128): an
        action's visits fall while its PUCT would stay below the chosen
        action's, which stops at the first v ≤ K / (max_puct − q), so
        final = clip(⌊K / margin⌋, visits − num_forced, visits).  Visits
        equal to 1 are then zeroed (:128)."""
        hp = self.hp
        argmax_v = rand_argmax(visits, draws)
        q = normalize_q(tree.Qsa[:, 0])
        ns = tree.Ns[:, 0, None]
        prior0, Nsa0 = tree.prior[:, 0], tree.Nsa[:, 0]
        c = puct_init + torch.log((ns + hp.puct_base + 1.0) / hp.puct_base)
        K = c * prior0 * torch.sqrt(ns + 1.0)
        uct_plain = torch.where(tree.valid[:, 0], q + K / (1.0 + Nsa0), float("-inf"))
        max_puct = uct_plain.gather(1, argmax_v[:, None])

        num_forced = torch.ceil(torch.sqrt(hp.forced_playout_factor * prior0 * ns))
        num_forced = torch.where(Nsa0 == 0, 0.0, num_forced)
        margin = max_puct - q
        v_star = torch.where(margin > 0, torch.floor(K / torch.clamp(margin, min=1e-30)), visits)
        pruned = torch.clamp(v_star, min=visits - num_forced, max=visits)
        chosen = torch.arange(self.A, device=visits.device) == argmax_v[:, None]
        out = torch.where(chosen | (num_forced <= 0), visits, pruned)
        return torch.where(out == 1.0, 0.0, out)
