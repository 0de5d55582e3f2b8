"""Runner of batched classic MCTS replans through ``Planner.run``
(``ClassicMCTSPlanner``, one search worker per mission).

Set-up builds the port's world and planner from the configuration file
and makes the inputs from the seed on the device: a ground truth for
every mission, ``batch`` missions that start from the prior at the first
cell's centre with first budgets drawn uniformly in ``budget_range``, a
ring of ``ring`` replans' search draws (``ClassicDraws``, handed to
``run`` as its ``draws``) and measurement noise, and a warm-up replan of
every shape on a batch that is not timed.  Each timed call is one replan
of the batch (``run(B, max_steps=1)``), chained through ``init_state``; a
mission that could not move has ended and starts again from the prior
with the whole budget, so missions are at every stage of their flight
and every call does the same lockstep work.  On a card the search runs
as the program's CUDA graph of one simulation, replayed once a simulation
(``ClassicMCTSPlanner.use_graphs``); a program without that path cannot
run the cell, and its set-up says so and stops.  The set-up keeps the
arguments of the kernel launches that the graph's capture made
(``captured``), for the readers of the kernels' rooflines.

Kept for the comparison, for ``sample`` missions of each call drawn from
the seed: the state the replan started from, the root's children after
the search, the action and the belief after the commit.  The first
``rerun_calls`` calls keep their whole batch's state too; the comparison
searches those batches again, outside the window, through the program's
Python loop (the same launches that the graph replays), and keeps, for a
share ``keep_share`` of the simulations, every lockstep step of the
sampled missions (the belief, position and budget it started from, the
feasible actions, the sweep's rewards, the ε-greedy draws and action,
the node's children and UCT scores and the slot chosen, the edge's
action, factor and gain, the downdated belief), the rollout's return and
the backup (the tree's visits and value sums before and after).  The
loop's root must equal the graph's, bitwise; the comparison follows the
search step by step from the kept states (``benchmark/reference/classic.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import classic as ref_classic
from benchmark.reference.world import Arith, RefWorld

#: floor of a reward, gain or return in a relative error's denominator
FLOOR = 1e-3
F64 = torch.float64


class Runner:
    def __init__(self, run):
        from ipp_rl_tpu_torch.config import config_from_dict
        from ipp_rl_tpu_torch.env.world import IPPWorld
        from ipp_rl_tpu_torch.planners.mcts_classic import ClassicMCTSPlanner

        self.run = run
        cell = run.cell
        raw = run.config["config"]
        # a test's smaller search (the same knobs otherwise)
        for m in raw["experiment"]["missions"]:
            if m["type"] == cell["mission"]:
                m.update(cell.get("knobs", {}))
        self.cfg = config_from_dict(raw)
        self.world = IPPWorld(self.cfg, fast_sweeps=bool(run.config["fast_sweeps"]),
                              device=run.device)
        mission = next(m for m in self.cfg.missions if m.type == cell["mission"])
        self.planner = ClassicMCTSPlanner(self.world, mission)
        self.hp = ref_classic.hyper(raw)
        self.B = int(cell["batch"])
        if not hasattr(self.planner, "use_graphs"):
            raise RuntimeError("classic_batch: this program's classic search has no CUDA-graph "
                               "path (ClassicMCTSPlanner.use_graphs), which the cell measures")
        self.records: List[Dict] = []
        self.rerun: List = []  # (record, the whole batch's state) of the calls searched again
        self.rec = self.sim = self.step = None
        self.rerunning = False
        self.captured: Dict[str, List] = {}
        self.k = 0

    def _draws(self, g: torch.Generator):
        """One replan's search draws: uniforms, which give the draws'
        choice laws (argmaxes over logits 0 or −∞, and coins)."""
        from ipp_rl_tpu_torch.planners.mcts_classic import ClassicDraws

        p, dev, B = self.planner, self.run.device, self.B
        S, H, A, K = p.num_simulations, p.horizon, self.world.num_actions, p.max_children

        def u(*shape):
            return torch.rand(shape, generator=g, device=dev)

        return ClassicDraws(select=u(S, H + 1, B, K), expand=u(S, H + 1, B, A),
                            expand_u=u(S, H + 1, B), rollout=u(S, H, B, A), rollout_u=u(S, H, B))

    def setup(self) -> None:
        run, dev, B = self.run, self.run.device, self.B
        g = inputs.generator(run.seed, 0, dev)
        M, R = self.world.H.shape[1], int(run.cell["ring"])
        self.gt = inputs.fields(run.config, B, g, dev)
        self.noise = [torch.randn((1, B, M), generator=g, device=dev) for _ in range(R)]
        self.draws = [self._draws(g) for _ in range(R)]
        mean0, cov0 = inputs.prior(run.config, dev)
        budget0 = float(run.config["config"]["experiment"]["constraints"]["budget"])
        self.fresh = inputs.belief_state(mean0, cov0, inputs.start_pos(run.config, dev), budget0,
                                         self.gt)
        lo, hi = run.cell["budget_range"]
        budget = lo + (hi - lo) * torch.rand((B,), generator=g, device=dev)
        self.state = self.fresh.replace(budget=budget)
        self.rng = np.random.default_rng(run.seed % (2 ** 63))
        # warm-up: one replan of every shape, on a batch that is not timed;
        # on a card it captures the search's graph
        with self._captured_launches():
            self.planner.run(B, max_steps=1, init_state=self.fresh, noise=self.noise[0],
                             draws=[self.draws[0]])
        self._record_calls()

    @contextlib.contextmanager
    def _captured_launches(self):
        """Keep, by kernel name, the arguments of each launch made while a
        CUDA graph is being captured (one simulation's)."""
        from ipp_rl_tpu_torch.ops import kernels

        names = ("spd_trace_product_packed", "edge_factor_gain")
        saved = {n: getattr(kernels, n) for n in names}

        def keep(name, fn):
            def kept(*args, **kw):
                if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                    self.captured.setdefault(name, []).append(args)
                return fn(*args, **kw)
            return kept

        for n in names:
            setattr(kernels, n, keep(n, saved[n]))
        try:
            yield
        finally:
            for n in names:
                setattr(kernels, n, saved[n])

    # ------------------------------------------------------------ recording

    def _record_calls(self) -> None:
        """Wrap the planner's methods to keep the sampled missions' rows
        (slices, on the device): the root after every search, and the kept
        simulations' steps while a batch is searched again.  A call over
        fewer rows than the batch (a planted fault's) keeps the rows its
        missions fill, modulo its size."""
        p = self.planner
        search, descend, rollout, backup = p.search, p._descend, p._rollout, p._backup
        available, sweep, policy, uct, scores = (p._available, p._sweep_rewards,
                                                 p._policy_action, p._uct_select, p._uct_scores)
        edge, downdate = p._edge, p._downdate
        share = float(self.run.cell["keep_share"])

        def rows(n):
            return self.rec["rows"] % n

        def kept_search(state, generator=None, draws=None):
            tree, stats = search(state, generator, draws)
            if self.rec is not None:
                i = rows(tree.visits.shape[0])
                cidx = torch.clamp(tree.children[i, 0], min=0)
                self.rec["rerun_root" if self.rerunning else "root"] = {
                    "visits": tree.visits[i, 0].clone(), "n_child": tree.num_children[i, 0].clone(),
                    "ch_visits": tree.visits[i[:, None], cidx].clone(),
                    "ch_values": tree.value_sum[i[:, None], cidx].clone(),
                    "ch_actions": tree.action_in[i[:, None], cidx].clone(),
                    "best": stats.best_child_action[i].clone()}
            return tree, stats

        def kept_descend(tree, P_root, root_pos, mean, i, draws, generator):
            if self.rerunning and self.rng.random() < share:
                self.sim = {"i": i, "descent": [], "rollout": [], "phase": "descent",
                            "C": tree.parent.shape[1]}
            out = descend(tree, P_root, root_pos, mean, i, draws, generator)
            if self.sim is not None:
                self.sim["phase"] = "rollout"
            return out

        def kept_rollout(P, pos, budget, mean, i, draws, generator):
            G = rollout(P, pos, budget, mean, i, draws, generator)
            if self.sim is not None:
                self.sim["G"] = G[rows(G.shape[0])].clone()
            return G

        def kept_backup(tree, rollout_node, rollout_value, path_nodes, path_rewards, path_len):
            snap = None
            if self.sim is not None:
                i = rows(rollout_node.shape[0])
                snap = {"visits": tree.visits[i].clone(), "values": tree.value_sum[i].clone(),
                        "rollout_node": rollout_node[i].clone(),
                        "rollout_value": rollout_value[i].clone(),
                        "path_nodes": path_nodes[i].clone(),
                        "path_rewards": path_rewards[i].clone(), "path_len": path_len[i].clone()}
            backup(tree, rollout_node, rollout_value, path_nodes, path_rewards, path_len)
            if snap is not None:
                snap.update(visits_after=tree.visits[i].clone(),
                            values_after=tree.value_sum[i].clone())
                self.sim["backup"] = snap
                self.rec["sims"].append(self.sim)
                self.sim = None

        def kept_available(costs, pos, budget):
            avail = available(costs, pos, budget)
            if self.sim is not None:
                i = rows(pos.shape[0])
                self.step = {"pos": pos[i].clone(), "budget": budget[i].clone(),
                             "avail": avail[i].clone()}
                self.sim[self.sim["phase"]].append(self.step)
            return avail

        def kept_sweep(P, costs, dmask):
            rewards = sweep(P, costs, dmask)
            if self.step is not None:
                i = rows(P.shape[0])
                self.step.update(P=P[i].clone(), rewards=rewards[i].clone())
            return rewards

        def kept_policy(P, costs, avail, dmask, eps, g_rand, u_mode, g_soft):
            a = policy(P, costs, avail, dmask, eps, g_rand, u_mode, g_soft)
            if self.step is not None:
                i = rows(P.shape[0])
                self.step.update(g=g_rand[i].clone(), u=u_mode[i].clone(), a_exp=a[i].clone())
            return a

        def kept_uct(tree, node, costs, budget, noise):
            if self.step is None:
                return uct(tree, node, costs, budget, noise)
            i = rows(node.shape[0])
            nd = node[i]
            cidx = torch.clamp(tree.children[i, nd], min=0)
            self.step.update(
                node=nd.clone(), n_child=tree.num_children[i, nd].clone(),
                node_visits=tree.visits[i, nd].clone(),
                ch_visits=tree.visits[i[:, None], cidx].clone(),
                ch_values=tree.value_sum[i[:, None], cidx].clone(),
                ch_actions=tree.action_in[i[:, None], cidx].clone(), noise=noise[i].clone())
            slot = uct(tree, node, costs, budget, noise)
            self.step["slot"] = slot[i].clone()
            return slot

        def kept_scores(tree, node, costs, budget):
            sc = scores(tree, node, costs, budget)
            if self.step is not None:
                self.step["scores"] = sc[rows(sc.shape[0])].clone()
            return sc

        def kept_edge(P, a, dmask):
            WcT, gain = edge(P, a, dmask)
            if self.step is not None:
                i = rows(P.shape[0])
                self.step.update(a=a[i].clone(), wct=WcT[i].clone(), gain=gain[i].clone())
            return WcT, gain

        def kept_downdate(P, WcT, keep):
            out = downdate(P, WcT, keep)
            if self.step is not None:
                i = rows(P.shape[0])
                self.step.update(keep=keep[i].clone(), P_out=out[i].clone())
                self.step = None
            return out

        p.search, p._descend, p._rollout, p._backup = (kept_search, kept_descend, kept_rollout,
                                                       kept_backup)
        p._available, p._sweep_rewards, p._policy_action, p._uct_select, p._uct_scores = (
            kept_available, kept_sweep, kept_policy, kept_uct, kept_scores)
        p._edge, p._downdate = kept_edge, kept_downdate

    def call(self) -> None:
        r = self.k % len(self.noise)
        self.k += 1
        st = self.state
        rows = np.sort(self.rng.choice(self.B, size=int(self.run.cell["sample"]), replace=False))
        idx = torch.as_tensor(rows, device=self.run.device)
        self.rec = {"ring": r, "rows": idx, "sims": [], "cov": st.cov[idx].clone(),
                    "mean": st.mean[idx].clone(), "pos": st.pos[idx].clone(),
                    "budget": st.budget[idx].clone()}
        res = self.planner.run(self.B, max_steps=1, init_state=st, noise=self.noise[r],
                               draws=[self.draws[r]])
        fin = res.final_state
        self.rec.update(wp=torch.as_tensor(res.waypoints[rows, 0]),
                        mean_after=fin.mean[idx].clone(), cov_after=fin.cov[idx].clone())
        self.records.append(self.rec)
        if len(self.rerun) < int(self.run.cell["rerun_calls"]):
            self.rerun.append((self.rec, st))
        self.rec = None
        self.run.replans += int(res.num_steps.sum())
        self.run.batch_replans += 1
        # a mission that could not move has ended: it starts again
        done = ~fin.active
        self.state = dataclasses.replace(fin, **{
            f.name: torch.where(done.view((-1,) + (1,) * (getattr(fin, f.name).ndim - 1)),
                                getattr(self.fresh, f.name), getattr(fin, f.name))
            for f in dataclasses.fields(fin)})

    def _search_again(self) -> None:
        """The kept calls' whole batches searched again through the
        program's Python loop, their kept simulations recorded (once)."""
        p = self.planner
        graphs = p.use_graphs
        p.use_graphs = False
        try:
            for rec, st in self.rerun:
                self.rec, self.rerunning = rec, True
                p.search(st, draws=self.draws[rec["ring"]])
        finally:
            self.rec, self.rerunning, self.rerun = None, False, []
            p.use_graphs = graphs

    # ------------------------------------------------------------ the check

    def judge(self, records) -> Dict[str, float]:
        j = _Judge(RefWorld(self.run.config["config"], device=self.run.device), self.hp)
        for rec in records:
            if "rerun_root" in rec:
                j.same_root(rec["root"], rec["rerun_root"])
            for sim in rec["sims"]:
                j.simulation(rec, sim)
            a, moved = j.root(rec)
            mr, cr = self._commit(j.ref, rec, a, moved)
            scale = rec["cov"].to(F64).abs().amax(dim=(-2, -1), keepdim=True)
            j.worst("belief_err", torch.abs(rec["cov_after"].to(F64) - cr) / scale)
            j.worst("belief_err", torch.abs(rec["mean_after"].to(F64) - mr))
        out = dict(j.err, search_violations=j.bad)
        out.update(sims_checked=j.sims, steps_checked=j.steps,
                   replans_checked=sum(len(r["rows"]) for r in records))
        return out

    def _commit(self, world: RefWorld, rec, a, moved):
        """The belief after the commit at actions a where the missions
        moved, by ``world``'s arithmetic."""
        dt = world.arith.dtype
        i = rec["rows"]
        eps = self.noise[rec["ring"]][0][i].to(dt)
        cov0, mean0 = rec["cov"].to(dt), rec["mean"].to(dt)
        z = world.reading(self.gt[i].to(dt), world.Z[a], world.noise_std[a], eps)
        m1, c1 = world.commit(cov0, mean0, world.H[a], world.R[a], z)
        return (torch.where(moved[:, None], m1, mean0).to(torch.float64),
                torch.where(moved[:, None, None], c1, cov0).to(torch.float64))

    def check(self) -> Dict[str, float]:
        self._search_again()
        self.planner = self.world = self.state = self.fresh = self.draws = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.judge(self.records)

    def control(self) -> Dict[str, float]:
        """The plain reference in bfloat16 put in the program's place on the
        kept inputs: it prices every action, scores the same children,
        updates along the same edges, sums the same returns and backups,
        and commits the same actions; the choices stay the program's."""
        self._search_again()
        dev = self.run.device
        low = RefWorld(self.run.config["config"], device=dev, arith=Arith("bf16"))
        hp = self.hp
        K = ref_classic.max_children(low, hp)
        records = []
        for rec in self.records:
            sims = []
            for sim in rec["sims"]:
                bk = dict(sim["backup"])
                bk["path_rewards"] = bk["path_rewards"].clone()
                G, disc = 0.0, 1.0
                parts = {}
                for kind in ("descent", "rollout"):
                    parts[kind] = []
                    for j, s in enumerate(sim[kind]):
                        s = dict(s)
                        P = s["P"].float()
                        s["rewards"] = ref_classic.rewards(low, P, rec["mean"], s["pos"])
                        Q, gain = ref_classic.edge(low, P, s["a"], rec["mean"])
                        s["wct"], s["gain"] = Q, gain
                        P_out = low.arith.r(P - Q.float())
                        s["P_out"] = torch.where(s["keep"][:, None, None], P_out, P)
                        cost = ref_classic.costs(low, s["pos"])[
                            torch.arange(len(s["a"]), device=dev), s["a"]]
                        reward = low.arith.r(gain / (cost + 1.0)).float()
                        if kind == "descent":
                            exists = torch.arange(K, device=dev)[None] < s["n_child"][:, None]
                            s["scores"] = ref_classic.uct_scores(
                                low, hp, s["ch_visits"], s["ch_values"], s["ch_actions"], exists,
                                s["node_visits"], s["pos"], s["budget"])[0]
                            bk["path_rewards"][:, j] = torch.where(s["keep"], reward,
                                                                   bk["path_rewards"][:, j])
                        else:
                            G = low.arith.r(G + torch.where(s["keep"], disc * reward, 0.0))
                            disc *= hp["gamma"]
                        parts[kind].append(s)
                bk["rollout_value"] = torch.where(bk["rollout_node"] >= 0, G, 0.0)
                vis, val = ref_classic.backup_sums(low, bk["visits"], bk["values"],
                                                   bk["rollout_node"], bk["rollout_value"],
                                                   bk["path_nodes"], bk["path_rewards"],
                                                   bk["path_len"])
                bk.update(visits_after=vis, values_after=val)
                sims.append(dict(sim, backup=bk, **parts))
            wp = rec["wp"].to(dev)
            moved = ~torch.isnan(wp[:, 0])
            a = torch.where(moved, low.action_index(torch.nan_to_num(wp)), rec["root"]["best"])
            m1, c1 = self._commit(low, rec, a, moved)
            records.append(dict(rec, sims=sims, mean_after=m1, cov_after=c1))
        return self.judge(records)


class _Judge:
    """The comparison's readings, gathered while it follows the kept
    simulations and the roots of the kept replans."""

    def __init__(self, ref: RefWorld, hp: Dict):
        self.ref, self.hp = ref, hp
        self.K = ref_classic.max_children(ref, hp)
        self.err = {"reward_err": 0.0, "edge_err": 0.0, "uct_gap": 0.0, "tree_err": 0.0,
                    "belief_err": 0.0}
        self.bad = self.sims = self.steps = 0

    def worst(self, key: str, x: torch.Tensor) -> None:
        if x.numel():
            self.err[key] = max(self.err[key], float(torch.max(x)))

    def same_root(self, graph: Dict, loop: Dict) -> None:
        """The graph's root against the Python loop's on the same batch:
        every sampled mission whose root differs in any bit is a violation."""
        differ = torch.zeros_like(graph["best"], dtype=torch.bool)
        for k, v in graph.items():
            w = loop[k]
            same = (v == w) | (torch.isnan(v) & torch.isnan(w)) if v.is_floating_point() else v == w
            differ |= ~same.reshape(len(differ), -1).all(dim=-1)
        self.bad += int(torch.sum(differ))

    def simulation(self, rec: Dict, sim: Dict) -> None:
        """One kept simulation, step by step from the program's states: who
        moves on, the sweep, the feasible actions, the ε-greedy choice,
        widening and UCT, the edge and its downdate, the path's rewards, the
        chain from one step to the next, the rollout's return and the
        backup."""
        ref, hp, dev = self.ref, self.hp, self.ref.device
        H, res, tol = hp["horizon"], float(ref.res), ref_classic.COMPARE_TOL
        mean_root = rec["mean"].to(F64)
        k = len(rec["rows"])
        rows = torch.arange(k, device=dev)
        bk = sim["backup"]
        done = torch.zeros(k, dtype=torch.bool, device=dev)
        alive = torch.ones(k, dtype=torch.bool, device=dev)
        depth = torch.zeros(k, dtype=torch.long, device=dev)
        leaf = torch.full((k,), -1, dtype=torch.long, device=dev)
        G = torch.zeros(k, dtype=F64, device=dev)
        disc = 1.0
        steps = [("descent", j, s) for j, s in enumerate(sim["descent"])] + \
                [("rollout", j, s) for j, s in enumerate(sim["rollout"])]
        self.sims += 1
        self.bad += int(len(sim["descent"]) != H + 1) + int(len(sim["rollout"]) != H)
        for n, (kind, j, s) in enumerate(steps):
            self.steps += 1
            P = s["P"].to(F64)
            scale = P.abs().amax(dim=(-2, -1))
            budget = s["budget"].to(F64)
            # whether the row moves on at this step
            if kind == "descent":
                terminal = (depth >= H) | (budget < res)
                fresh = (s["node_visits"] == 0) & (s["node"] != 0)
                leaf = torch.where(~done & fresh & ~terminal, s["node"], leaf)
                done = done | terminal | fresh
                move = ~done
            else:
                alive = alive & (budget >= res)
                move = alive
            self.bad += int(torch.sum(move != s["keep"]))
            self.policy(s, mean_root, budget, hp["epsilon_" + (
                "expand" if kind == "descent" else "rollout")])
            quirk = self.selection(s, budget) if kind == "descent" else torch.zeros_like(move)
            # the edge at the action taken, and the downdate
            a = s["a"]
            Q, g_ref = ref_classic.edge(ref, P, a, mean_root)
            f = s["wct"].to(F64)
            # the program's factor Wcᵀ (M, N) is compared through Wc·Wcᵀ; a
            # control hands its (N, N) product itself
            prod = f if f.shape[-2] == f.shape[-1] else f.mT @ f
            self.worst("edge_err", (prod - Q).abs().amax(dim=(-2, -1)) / scale)
            self.worst("edge_err", _rel(s["gain"], g_ref))
            P_out = s["P_out"].to(F64)
            d_full = (P_out - (P - Q)).abs().amax(dim=(-2, -1)) / scale
            d_none = (P_out - P).abs().amax(dim=(-2, -1)) / scale
            # departure 5: an empty slot's edge downdates nothing
            self.worst("edge_err", torch.where(
                move, torch.where(quirk, torch.minimum(d_full, d_none), d_full), d_none))
            cost = ref_classic.costs(ref, s["pos"])[rows, a]
            reward = g_ref / (cost + 1.0)
            if kind == "descent":
                self.worst("tree_err",
                           torch.where(move, _rel(bk["path_rewards"][:, j], reward), 0.0))
                depth = depth + move
            else:
                G = G + torch.where(move, disc * reward, 0.0)
                disc *= hp["gamma"]
            # the next step starts where this one ended
            if n + 1 < len(steps):
                nxt = steps[n + 1][2]
                want_b = torch.where(move, budget - cost, budget)
                self.worst("tree_err", torch.abs(nxt["budget"].to(F64) - want_b)
                           / torch.clamp(budget.abs(), min=1.0))
                want_p = torch.where(move[:, None], ref.xyz[a], s["pos"].to(F64))
                self.bad += int(torch.sum((nxt["pos"].to(F64) - want_p).abs().amax(dim=-1)
                                          > 1e-4))
                self.worst("edge_err",
                           (nxt["P"].to(F64) - P_out).abs().amax(dim=(-2, -1)) / scale)
        # the rollout's return and the backup
        C = sim["C"]
        node = bk["rollout_node"]
        self.bad += int(torch.sum(~((node == leaf) | ((node == -1) & (leaf == C - 1)))))
        self.bad += int(torch.sum(bk["path_len"] != depth))
        credited = node >= 0
        self.worst("tree_err", torch.where(credited, _rel(bk["rollout_value"], G), 0.0))
        self.bad += int(torch.sum(~credited & (bk["rollout_value"] != 0)))
        vis, val = ref_classic.backup_sums(ref, bk["visits"], bk["values"], node,
                                           bk["rollout_value"], bk["path_nodes"],
                                           bk["path_rewards"], bk["path_len"])
        self.bad += int(torch.sum(bk["visits_after"].to(F64) != vis))
        vscale = torch.clamp(val.abs().amax(dim=-1, keepdim=True), min=FLOOR)
        self.worst("tree_err", torch.abs(bk["values_after"].to(F64) - val) / vscale)

    def policy(self, s: Dict, mean_root, budget, eps: float) -> None:
        """The step's sweep against the reference's rewards, its feasible
        actions, and its ε-greedy action: the best reward where the coin
        says greedy, else the draws' choice."""
        ref, tol = self.ref, ref_classic.COMPARE_TOL
        rw = ref_classic.rewards(ref, s["P"].to(F64), mean_root, s["pos"])
        row_scale = torch.clamp(rw.abs().amax(dim=-1, keepdim=True), min=1e-12)
        self.worst("reward_err", torch.abs(s["rewards"].to(F64) - rw) / row_scale)
        av = s["avail"]
        lo = ref_classic.available(ref, self.hp, s["pos"], budget, -tol)
        hi = ref_classic.available(ref, self.hp, s["pos"], budget, tol)
        self.bad += int(torch.sum(av & ~hi) + torch.sum(~av & lo))
        a = s["a_exp"]
        rows = torch.arange(len(a), device=a.device)
        greedy = (s["u"].to(F64) > eps) & av.any(dim=-1)
        best = torch.where(av, rw, float("-inf")).amax(dim=-1)
        gap = (best - rw[rows, a]) / torch.clamp(best.abs(), min=FLOOR)
        gap = torch.where(av[rows, a], gap, float("inf"))
        self.worst("uct_gap", torch.where(greedy, gap, 0.0))
        drawn = ref_classic.policy_action(rw, av, eps, s["g"], s["u"])
        self.bad += int(torch.sum(~greedy & (a != drawn)))

    def selection(self, s: Dict, budget) -> torch.Tensor:
        """A descent step's UCT scores and choice, and progressive widening:
        the edge taken is the expansion's action or the chosen child's.
        Returns where the step may have moved into an empty slot."""
        ref, hp, K, tol = self.ref, self.hp, self.K, ref_classic.COMPARE_TOL
        rows = torch.arange(len(s["a"]), device=ref.device)
        exists = torch.arange(K, device=ref.device)[None] < s["n_child"][:, None]
        args = (ref, hp, s["ch_visits"], s["ch_values"], s["ch_actions"], exists,
                s["node_visits"], s["pos"], budget)
        sc, scs = ref_classic.uct_scores(*args)
        e_score = _score_err(s["scores"], sc, scs, ref, s, budget, tol)
        e_gap = _selection_gap(sc, scs, s["slot"], s["noise"])
        # children's values equal within rounding: either reading holds
        amb = ref_classic.flat_within_rounding(s["ch_visits"], s["ch_values"], exists, tol)
        if bool(amb.any()):
            sc2, scs2 = ref_classic.uct_scores(*args, flat=torch.ones_like(amb))
            e_score = torch.where(amb, torch.minimum(
                e_score, _score_err(s["scores"], sc2, scs2, ref, s, budget, tol)), e_score)
            e_gap = torch.where(amb, torch.minimum(
                e_gap, _selection_gap(sc2, scs2, s["slot"], s["noise"])), e_gap)
        self.worst("uct_gap", e_score)
        self.worst("uct_gap", e_gap)
        n_av = s["avail"].sum(dim=-1)
        w_lo = ref_classic.widens(hp, s["n_child"], s["node_visits"], n_av, K, -tol)
        w_hi = ref_classic.widens(hp, s["n_child"], s["node_visits"], n_av, K, tol)
        slot = s["slot"]
        empty = slot >= s["n_child"]
        child_a = torch.where(empty, 0, s["ch_actions"][rows, slot])
        ok = (w_hi & (s["a"] == s["a_exp"])) | (~w_lo & (s["a"] == child_a))
        self.bad += int(torch.sum(~ok))
        return ~w_lo & empty

    def root(self, rec: Dict):
        """The root after the search: its visits, its children within the
        widening bound, the action the best child's by its own mean, and the
        move affordable and within the radius.  Returns the action and
        whether the mission moved."""
        ref, hp, tol = self.ref, self.hp, ref_classic.COMPARE_TOL
        dev = ref.device
        rt = rec["root"]
        k = len(rec["rows"])
        budget = rec["budget"].to(F64)
        searched = budget >= float(ref.res)
        self.bad += int(torch.sum(rt["visits"].to(F64)
                                  != torch.where(searched, float(hp["simulations"]), 0.0)))
        exists = torch.arange(self.K, device=dev)[None] < rt["n_child"][:, None]
        n_av = ref_classic.available(ref, hp, rec["pos"], budget, tol).sum(dim=-1)
        self.bad += int(torch.sum((rt["n_child"] > torch.clamp(n_av, min=1)) & searched))
        means = ref_classic.best_child_mean(rt["ch_visits"], rt["ch_values"], exists)
        mine = torch.where(rt["ch_actions"] == rt["best"][:, None], means,
                           float("-inf")).amax(dim=-1)
        top = means.amax(dim=-1)
        has = exists.any(dim=-1)
        self.worst("uct_gap",
                   torch.where(has, (top - mine) / torch.clamp(top.abs(), min=FLOOR), 0.0))
        self.bad += int(torch.sum(~has & (rt["best"] != 0)))
        wp = rec["wp"].to(dev)
        moved = ~torch.isnan(wp[:, 0])
        a = torch.where(moved, ref.action_index(torch.nan_to_num(wp)), rt["best"])
        self.bad += int(torch.sum(moved & (a != rt["best"])))
        c = ref_classic.costs(ref, rec["pos"])[torch.arange(k, device=dev), a]
        dist = torch.sqrt(torch.sum((ref.xyz[a] - rec["pos"].to(F64)) ** 2, dim=-1))
        paid = (c > 0) & (c <= budget * (1 + tol))
        surely = (c > 0) & (c <= budget * (1 - tol))
        # a boxed-in root may expand out of the radius (departure 4)
        boxed = ~ref_classic.available(ref, hp, rec["pos"], budget, -tol).any(dim=-1)
        far = dist >= float(hp["horizontal_spacing"]) * (1 + tol)
        self.bad += int(torch.sum(moved & (~paid | (~boxed & far))))
        self.bad += int(torch.sum(~moved & surely))
        return a, moved


def _rel(got, want) -> torch.Tensor:
    want = want.to(F64)
    return torch.abs(got.to(want) - want) / torch.clamp(want.abs(), min=FLOOR)


def _score_err(prog, score, scale, world: RefWorld, s, budget, tol) -> torch.Tensor:
    """(S,) widest gap between the program's UCT scores (S, K) and the
    reference's, relative to the larger of a score and its rounding scale:
    inf where one side rules a child out (−inf) or takes it as unvisited
    (+inf) and the other does not, but where its flight cost lies within
    rounding of the budget."""
    prog = prog.to(score)
    a = torch.clamp(s["ch_actions"], min=0)
    c = torch.gather(ref_classic.costs(world, s["pos"]), 1, a)
    near = (c - budget[:, None]).abs() <= tol * torch.clamp(budget[:, None].abs(), min=1.0)
    same = (torch.isposinf(prog) == torch.isposinf(score)) & (torch.isneginf(prog)
                                                              == torch.isneginf(score))
    both = torch.isfinite(prog) & torch.isfinite(score)
    den = torch.clamp(torch.maximum(score.abs(), scale), min=FLOOR)
    out = torch.where(both, (prog - score).abs() / den, 0.0)
    out = torch.where(same | near, out, float("inf"))
    return out.amax(dim=-1)


def _selection_gap(score, scale, slot, noise) -> torch.Tensor:
    """(S,) how far the chosen child's reference score lies below the best,
    relative to the larger of the best and the scores' rounding scale: an
    unvisited child must be taken while there is one, and with no
    selectable child the draws' choice over all slots."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    best = score.amax(dim=-1)
    mine = score[rows, slot]
    den = torch.clamp(torch.maximum(best.abs(), scale.amax(dim=-1)), min=FLOOR)
    gap = (best - mine) / den
    inf_best = torch.isposinf(best)
    gap = torch.where(inf_best, torch.where(torch.isposinf(mine), 0.0, float("inf")), gap)
    none = torch.isneginf(best)
    drawn = ref_classic.rand_argmax(score, noise)
    gap = torch.where(none, torch.where(slot == drawn, 0.0, float("inf")), gap)
    return torch.where(torch.isfinite(mine) | inf_best | none, gap, float("inf"))
