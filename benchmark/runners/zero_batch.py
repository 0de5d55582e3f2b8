"""Runner of batched MCTS-zero deploy replans through ``ZeroPlanner.run``
(deploy mode "reference": root Dirichlet noise and forced playouts on).

Set-up builds the port's world, network and planner from the
configuration file at its published widths, loads the benchmark's
seeded weights into the network (``benchmark/weights.py``), makes
``pool`` batches of ``batch`` missions' inputs from the seed and warms
every shape up with a two-simulation replan.  A mission's input is a
ground truth, a belief (the prior after 0 to ``premeasure`` random
lattice measurements, the last of which is where the robot is), the
budget left (what the config's budget leaves after that path, at least a
quarter of it) and the noise of its next measurement.  The planner keeps
an episode history it starts anew at each call, so a call cannot carry a
mission on: each timed call is one replan of a pool batch
(``run(B, max_steps=1)``), cycling through the pool, its search draws
from a generator seeded from the seed.

Kept for the comparison, for ``sample`` missions of each call drawn from
the seed: a share ``keep_share`` of the descent's steps (the node's
statistics, the PUCT scores and the action taken), edge updates (inputs,
factor and gain), network evaluations (the leaves' history and root
mean, the policy and value), the leaves' priors and the backups (the
path, its rewards, the leaf's value, the edges' visits and values before
and after), the root's visit counts, the action taken and the belief
after the commit.  The comparison follows the search step by step from
those states (``benchmark/reference/search.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs, weights
from benchmark.reference import search as ref_search
from benchmark.reference.network import RefNet, planes
from benchmark.reference.world import Arith, RefWorld


class Runner:
    def __init__(self, run):
        from ipp_rl_tpu_torch.config import config_from_dict
        from ipp_rl_tpu_torch.env.world import IPPWorld
        from ipp_rl_tpu_torch.models.networks import build_network
        from ipp_rl_tpu_torch.planners.zero import ZeroPlanner
        from ipp_rl_tpu_torch.planners.zero.train import inference_dtype, predict_fn

        self.run = run
        cell = run.cell
        self.cfg = config_from_dict(run.config["config"])
        self.world = IPPWorld(self.cfg, device=run.device)
        self.mission = next(m for m in self.cfg.missions if m.type == cell["mission"])
        hp = self.mission.hyper_params
        for k, v in cell.get("hyper_params", {}).items():  # a test's smaller widths
            hp = dataclasses.replace(hp, **{k: v})
        self.mission = dataclasses.replace(self.mission, hyper_params=hp)
        self.hp = hp
        self.net = build_network(self.cfg, hp).to(run.device).eval()
        self.weights = weights.seeded(self.net.state_dict(), run.seed, run.device)
        self.net.load_state_dict(self.weights)
        self.predict = predict_fn(self.net, dtype=inference_dtype(hp))
        self.planner = ZeroPlanner(self.world, self.mission, self.predict, self.net.state_dict(),
                                   deploy_mode="reference")
        self.B = int(cell["batch"])
        self.records: List[Dict] = []
        self.rec = None
        self.step = None  # the descent step being kept
        self.k = 0

    def _beliefs(self, gt: torch.Tensor, g: torch.Generator):
        """Beliefs after 0..premeasure random lattice measurements (the
        reference's float64 commits, handed over in float32)."""
        world = RefWorld(self.run.config["config"], device=self.run.device)
        B, dev = gt.shape[0], self.run.device
        mean0, cov0 = self.mean0.to(torch.float64), self.cov0.to(torch.float64)
        mean, cov = mean0.expand(B, -1).clone(), cov0.expand(B, -1, -1).clone()
        pos = self.pos0.to(torch.float64).expand(B, 3).clone()
        spent = torch.zeros(B, dtype=torch.float64, device=dev)
        K = int(self.run.cell["premeasure"])
        count = torch.randint(0, K + 1, (B,), generator=g, device=dev)
        for j in range(K):
            a = torch.randint(0, world.num_actions, (B,), generator=g, device=dev)
            eps = torch.randn((B, world.H.shape[1]), generator=g, device=dev, dtype=torch.float64)
            z = world.reading(gt.to(torch.float64), world.Z[a], world.noise_std[a], eps)
            m1, c1 = world.commit(cov, mean, world.H[a], world.R[a], z)
            on = j < count
            mean = torch.where(on[:, None], m1, mean)
            cov = torch.where(on[:, None, None], c1, cov)
            spent = spent + torch.where(on, world.flight_time(world.xyz[a], pos), 0.0)
            pos = torch.where(on[:, None], world.xyz[a], pos)
        budget = torch.clamp(self.budget0 - spent, min=0.25 * self.budget0)
        from ipp_rl_tpu_torch.env.world import BeliefState

        f32 = torch.float32
        return BeliefState(mean=mean.to(f32), cov=cov.to(f32), pos=pos.to(f32),
                           budget=budget.to(f32), ground_truth=gt,
                           active=torch.ones(B, dtype=torch.bool, device=dev),
                           step=torch.zeros(B, dtype=torch.int32, device=dev))

    def setup(self) -> None:
        from ipp_rl_tpu_torch.planners.zero import ZeroPlanner

        run, dev, B = self.run, self.run.device, self.B
        g = inputs.generator(run.seed, 0, dev)
        self.mean0, self.cov0 = inputs.prior(run.config, dev)
        self.pos0 = inputs.start_pos(run.config, dev)
        self.budget0 = float(run.config["config"]["experiment"]["constraints"]["budget"])
        M = self.world.H.shape[1]
        P = int(run.cell["pool"])
        self.states = [self._beliefs(inputs.fields(run.config, B, g, dev), g) for _ in range(P)]
        self.noise = [torch.randn((1, B, M), generator=g, device=dev) for _ in range(P)]
        self.draws = inputs.generator(run.seed, 1, dev)
        self.rng = np.random.default_rng(run.seed % (2 ** 63))
        # warm-up: every shape of a replan, with two simulations
        mc = dataclasses.replace(self.mission, hyper_params=dataclasses.replace(
            self.hp, num_mcts_simulations=2))
        ZeroPlanner(self.world, mc, self.predict, self.net.state_dict()).run(
            B, max_steps=1, init_state=self.states[0], noise=self.noise[0],
            generator=inputs.generator(run.seed, 2, dev))
        self._record_calls()

    def _record_calls(self) -> None:
        mcts = self.planner.mcts
        edge, evaluate, search = mcts.edge_update, mcts._eval_leaves, mcts.search
        step, puct, integrate, backup = (mcts._descend_step, mcts.puct, mcts._integrate_eval,
                                         mcts._backup)
        share = float(self.run.cell["keep_share"])

        def kept_edge(P, a, mask):
            WcT, gain = edge(P, a, mask)
            if self.rec is not None and self.rng.random() < share:
                i = self.rec["rows"] % P.shape[0]
                self.rec["edges"].append((P[i].clone(), a[i].clone(),
                                          None if mask is None else mask[i].clone(),
                                          WcT[i].clone(), gain[i].clone()))
            return WcT, gain

        def kept_eval(variables, hist, leaf_mask, mean, dt):
            policy, value = evaluate(variables, hist, leaf_mask, mean, dt)
            if self.rec is not None and self.rng.random() < share:
                i = self.rec["rows"] % leaf_mask.shape[0]
                self.rec["evals"].append((hist.covs[i].clone(), hist.positions[i].clone(),
                                          hist.budgets[i].clone(), hist.length[i].clone(),
                                          leaf_mask[i].clone(), mean[i].clone(),
                                          policy[i].clone(), value[i].clone()))
            return policy, value

        def kept_search(*args, **kw):
            tree, root_mask = search(*args, **kw)
            if self.rec is not None:
                i = self.rec["rows"] % tree.Ns.shape[0]
                self.rec["root_ns"] = tree.Ns[i, 0].clone()
                self.rec["root_nsa"] = tree.Nsa[i, 0].clone()
            return tree, root_mask

        def kept_step(j, tree, c, draws, diag_mask, puct_init, forced):
            keep = self.rec is not None and self.rng.random() < share
            if keep:
                i = self.rec["rows"] % c.node.shape[0]
                node = c.node[i]
                self.step = {"rows": i, "depth": c.depth[i].clone(),
                             "nsa": tree.Nsa[i, node].clone(), "qsa": tree.Qsa[i, node].clone(),
                             "prior": tree.prior[i, node].clone(),
                             "valid": tree.valid[i, node].clone(), "ns": tree.Ns[i, node].clone()}
            out = step(j, tree, c, draws, diag_mask, puct_init, forced)
            if keep:
                # the action taken (−1 where the mission had stopped)
                self.step["a"] = out.path_actions[self.step["rows"], j].clone()
                self.rec["steps"].append(self.step)
                self.step = None
            return out

        def kept_puct(tree, node, puct_init, force):
            score = puct(tree, node, puct_init, force)
            if self.step is not None:
                self.step["score"] = score[self.step["rows"]].clone()
            return score

        def kept_integrate(tree, leaf, policy, value, leaf_mask, is_root_first, noise):
            keep = self.rec is not None and self.rng.random() < share
            if keep:
                i = self.rec["rows"] % leaf.shape[0]
                at = torch.clamp(leaf[i], min=0)
                snap = {"leaf": leaf[i].clone(), "policy": policy[i].clone(),
                        "value": value[i].clone(), "mask": leaf_mask[i].clone(),
                        "noise": noise[i].clone(), "prior_before": tree.prior[i, at].clone()}
            out = integrate(tree, leaf, policy, value, leaf_mask, is_root_first, noise)
            if keep:
                snap.update(prior=tree.prior[i, at].clone(), value_out=out[i].clone())
                self.rec["leaves"].append(snap)
            return out

        def kept_backup(tree, c, leaf_value, steps):
            keep = self.rec is not None and self.rng.random() < share
            if keep:
                i = self.rec["rows"] % leaf_value.shape[0]
                at = (i[:, None], torch.clamp(c.path_nodes[i, :steps], min=0),
                      torch.clamp(c.path_actions[i, :steps], min=0))
                snap = {"actions": c.path_actions[i, :steps].clone(),
                        "length": c.path_len[i].clone(),
                        "rewards": c.path_rewards[i, :steps].clone(),
                        "value": leaf_value[i].clone(), "nsa": tree.Nsa[at].clone(),
                        "qsa": tree.Qsa[at].clone(), "ns": tree.Ns[at[:2]].clone()}
            backup(tree, c, leaf_value, steps)
            if keep:
                snap.update(nsa_after=tree.Nsa[at].clone(), qsa_after=tree.Qsa[at].clone(),
                            ns_after=tree.Ns[at[:2]].clone())
                self.rec["backups"].append(snap)

        mcts.edge_update, mcts._eval_leaves, mcts.search = kept_edge, kept_eval, kept_search
        mcts._descend_step, mcts.puct = kept_step, kept_puct
        mcts._integrate_eval, mcts._backup = kept_integrate, kept_backup

    def call(self) -> None:
        p = self.k % len(self.states)
        self.k += 1
        st = self.states[p]
        rows = np.sort(self.rng.choice(self.B, size=int(self.run.cell["sample"]), replace=False))
        idx = torch.as_tensor(rows, device=self.run.device)
        self.rec = {"pool": p, "rows": idx, "edges": [], "evals": [], "steps": [], "leaves": [],
                    "backups": []}
        res = self.planner.run(self.B, max_steps=1, init_state=st, noise=self.noise[p],
                               generator=self.draws)
        fin = res.final_state
        self.rec.update(wp=torch.as_tensor(res.waypoints[rows, 0]),
                        mean_after=fin.mean[idx].clone(), cov_after=fin.cov[idx].clone())
        self.records.append(self.rec)
        self.rec = None
        self.run.replans += int(res.num_steps.sum())
        self.run.batch_replans += 1

    # ------------------------------------------------------------ the check

    def _commit(self, world: RefWorld, rec):
        """The belief after the commit at the action taken (the kept
        missions of one call), by ``world``'s arithmetic."""
        st, i, dev = self.states[rec["pool"]], rec["rows"], self.run.device
        dt = world.arith.dtype
        wp = rec["wp"].to(dev)
        moved = ~torch.isnan(wp[:, 0])
        a = world.action_index(torch.nan_to_num(wp))
        eps = self.noise[rec["pool"]][0][i].to(dt)
        cov0, mean0 = st.cov[i].to(dt), st.mean[i].to(dt)
        z = world.reading(st.ground_truth[i].to(dt), world.Z[a], world.noise_std[a], eps)
        m1, c1 = world.commit(cov0, mean0, world.H[a], world.R[a], z)
        return (torch.where(moved[:, None], m1, mean0), torch.where(moved[:, None, None], c1, cov0),
                moved, a)

    def judge(self, records) -> Dict[str, float]:
        dev = self.run.device
        ref = RefWorld(self.run.config["config"], device=dev)
        ref_net = RefNet(self.weights, dataclasses.asdict(self.hp))
        sims = int(self.hp.num_mcts_simulations)
        hp = ref_search.hyper(self.run.config["config"])
        net_err, edge_err, puct_err, tree_err, err, bad = 0.0, 0.0, 0.0, 0.0, 0.0, 0
        n_evals = n_edges = 0
        for rec in records:
            for covs, pos, bud, length, mask, mean, policy, value in rec["evals"]:
                p_ref, v_ref = ref_net(planes(ref, covs, pos, bud, length, mean), mask)
                net_err = max(net_err, float(torch.max(torch.abs(policy.to(p_ref) - p_ref))),
                              float(torch.max(torch.abs(value.to(v_ref) - v_ref)
                                              / torch.clamp(v_ref.abs(), min=1e-3))))
                n_evals += 1
            for P, a, mask, factor, gain in rec["edges"]:
                Q, g_ref = _edge(ref, P, a, mask)
                scale = P.to(torch.float64).abs().amax(dim=(-2, -1))
                f = factor.to(torch.float64)
                # the program's factor Wcᵀ (M, N) is compared through Wc·Wcᵀ;
                # a control hands its (N, N) product itself
                prod = f if f.shape[-2] == f.shape[-1] else f.mT @ f
                edge_err = max(edge_err,
                               float(torch.max((prod - Q).abs().amax(dim=(-2, -1)) / scale)),
                               float(torch.max(torch.abs(gain.to(g_ref) - g_ref)
                                               / torch.clamp(g_ref.abs(), min=1e-3))))
                n_edges += 1
            # the descent's choices, from the node's statistics
            for st in rec["steps"]:
                score, forced, maybe = ref_search.puct(ref, hp, st["nsa"], st["qsa"], st["prior"],
                                                       st["valid"], st["ns"], st["depth"] == 0)
                moved = st["a"] >= 0
                gap = ref_search.selection_gap(score, forced, maybe, torch.clamp(st["a"], min=0))
                puct_err = max(puct_err, float(torch.max(torch.maximum(
                    ref_search.score_err(st["score"], score, forced, maybe),
                    torch.where(moved, gap, 0.0)))))
            # the leaves' priors and the values they back up
            for lf in rec["leaves"]:
                ok = (lf["leaf"] >= 0) & lf["mask"].any(dim=-1)
                want = torch.where(ok[:, None],
                                   ref_search.leaf_prior(ref, hp, lf["policy"], lf["mask"],
                                                         lf["noise"], lf["leaf"] == 0),
                                   lf["prior_before"].to(torch.float64))
                v = torch.where(ok, lf["value"].to(torch.float64), 0.0)
                tree_err = max(tree_err, float(torch.max(torch.abs(lf["prior"].to(want) - want))),
                               float(torch.max(torch.abs(lf["value_out"].to(v) - v)
                                               / torch.clamp(v.abs(), min=1e-3))))
            # each backup: the path's rewards from the root's belief, the
            # edges' values after its return, one visit more on each edge
            st0 = self.states[rec["pool"]]
            i = rec["rows"]
            for bk in rec["backups"]:
                rew = ref_search.path_rewards(ref, st0.cov[i], st0.mean[i], st0.pos[i],
                                              bk["actions"], bk["length"])
                q = ref_search.backup(ref, hp, rew, bk["value"], bk["nsa"], bk["qsa"],
                                      bk["length"])
                on = torch.arange(rew.shape[1], device=dev)[None, :] < bk["length"][:, None]
                rel_r = torch.abs(bk["rewards"].to(rew) - rew) / torch.clamp(rew.abs(), min=1e-3)
                rel_q = torch.abs(bk["qsa_after"].to(q) - q) / torch.clamp(q.abs(), min=1e-3)
                tree_err = max(tree_err, float(torch.max(torch.where(on, rel_r, 0.0))),
                               float(torch.max(torch.where(on, rel_q, 0.0))))
                bad += int(torch.sum(on & (bk["nsa_after"] != bk["nsa"] + 1)))
                bad += int(torch.sum(on & (bk["ns_after"] != bk["ns"] + 1)))
            # the search's root: every simulation but the first backed up
            # through it, and the action taken one of its most visited
            mr, cr, moved, a = self._commit(ref, rec)
            nsa = rec["root_nsa"]
            most = nsa == nsa.amax(dim=-1, keepdim=True)
            bad += int(torch.sum(rec["root_ns"] != sims - 1))
            bad += int(torch.sum(moved & ~most[torch.arange(len(a), device=dev), a]))
            scale = self.states[rec["pool"]].cov[rec["rows"]].to(torch.float64).abs().amax(
                dim=(-2, -1), keepdim=True)
            err = max(err, float(torch.max(torch.abs(rec["cov_after"].to(cr) - cr) / scale)),
                      float(torch.max(torch.abs(rec["mean_after"].to(mr) - mr))))
        return {"net_err": net_err, "edge_err": edge_err, "puct_err": puct_err,
                "tree_err": tree_err, "belief_err": err, "search_violations": bad,
                "evals_checked": n_evals, "edges_checked": n_edges,
                "steps_checked": sum(len(r["steps"]) for r in records),
                "backups_checked": sum(len(r["backups"]) for r in records),
                "replans_checked": sum(len(r["rows"]) for r in records)}

    def check(self) -> Dict[str, float]:
        self.planner = self.predict = self.net = self.world = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.judge(self.records)

    def control(self) -> Dict[str, float]:
        """The plain reference in bfloat16 in the program's place: its
        network evaluates the same leaves, its edge update the same
        covariances, its PUCT scores and chooses at the same nodes, it
        stores the same leaves' priors, backs up the same paths, and it
        commits the same actions."""
        low = RefWorld(self.run.config["config"], device=self.run.device, arith=Arith("bf16"))
        low_net = RefNet(self.weights, dataclasses.asdict(self.hp), dtype=torch.bfloat16)
        hp = ref_search.hyper(self.run.config["config"])
        records = []
        for rec in self.records:
            evals = []
            for covs, pos, bud, length, mask, mean, _, _ in rec["evals"]:
                p, v = low_net(planes(low, covs, pos, bud, length, mean, dtype=torch.bfloat16),
                               mask)
                evals.append((covs, pos, bud, length, mask, mean, p.float(), v.float()))
            edges = [(P, a, mask, *_edge(low, P, a, mask)) for P, a, mask, _, _ in rec["edges"]]
            steps = []
            for st in rec["steps"]:
                score, forced, _ = ref_search.puct(low, hp, st["nsa"], st["qsa"], st["prior"],
                                                   st["valid"], st["ns"], st["depth"] == 0)
                score = torch.where(forced, float("inf"), score)
                a = torch.where(st["a"] >= 0, torch.argmax(score, dim=-1), st["a"])
                steps.append(dict(st, score=score, a=a))
            leaves = [dict(lf, prior=ref_search.leaf_prior(low, hp, lf["policy"], lf["mask"],
                                                           lf["noise"], lf["leaf"] == 0))
                      for lf in rec["leaves"]]
            st0, i = self.states[rec["pool"]], rec["rows"]
            backups = []
            for bk in rec["backups"]:
                rew = ref_search.path_rewards(low, st0.cov[i], st0.mean[i], st0.pos[i],
                                              bk["actions"], bk["length"])
                q = ref_search.backup(low, hp, rew, bk["value"], bk["nsa"], bk["qsa"],
                                      bk["length"])
                backups.append(dict(bk, rewards=rew, qsa_after=q))
            m1, c1, _, _ = self._commit(low, rec)
            records.append(dict(rec, evals=evals, edges=edges, steps=steps, leaves=leaves,
                                backups=backups, mean_after=m1, cov_after=c1))
        return self.judge(records)


def _edge(world: RefWorld, P, a, mask):
    """(P Hᵀ S⁻¹ H P, its masked trace) of the edge update at actions a."""
    r = world.arith.r
    dt = world.arith.dtype
    P = P.to(dt)
    H, R = world.H[a], world.R[a]
    HP = r(H @ P)
    S = r(HP @ H.mT)
    S = r(0.5 * (S + S.mT)) + torch.diag_embed(R)
    Q = r(HP.mT @ r(torch.linalg.inv(S) @ HP))
    d = torch.diagonal(Q, dim1=-2, dim2=-1)
    if mask is not None:
        d = d * mask.to(dt)
    return Q.to(torch.float64), d.sum(-1).to(torch.float64)
