"""Runner of batched CMA-ES missions through ``CMAESPlanner.run``.

Set-up builds the port's world and planner from the configuration file
and makes the inputs from the seed: the configuration's field for every
mission, a ring of ``ring`` steps' measurement noise and CMA-ES's normals
(handed to ``run`` as its ``draws``), and ``batch`` missions that start
from the prior at the first cell's centre with a budget drawn uniformly
up to the whole; then it warms up with one replan.  Each timed call is
one replan step of the batch (``run(B, max_steps=1)``), chained through
``init_state``: the planner keeps no state but the belief, so a mission
computes what one long call would.  A mission whose budget ended starts
again from the prior with the whole budget, so the missions are at every
stage of their flight and every call does the same work: where a window
ends does not move its rate (batches flown from a common start left
fewer missions active late in a batch, and a window of 32 or 33 calls
read 1% apart).

Kept for the comparison, from each call's missions that were active,
``sample`` drawn from the seed: the states the replan started from, every
fitness call's candidates and losses, every generation's covariance and
its eigendecomposition, the plan returned, and the belief after the
commit.  The comparison follows the program step by step from those
states (``benchmark/reference/cmaes.py``): it holds the replan to the
configuration's generations and population, and follows CMA-ES's
update from the greedy initial plan and the normals.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import cmaes as ref_cmaes
from benchmark.reference.greedy import BUDGET_TOL
from benchmark.reference.world import Arith, RefWorld


class Runner:
    def __init__(self, run):
        from ipp_rl_tpu_torch.config import config_from_dict
        from ipp_rl_tpu_torch.env.world import IPPWorld
        from ipp_rl_tpu_torch.planners.cmaes import CMAESPlanner

        self.run = run
        self.cfg = config_from_dict(run.config["config"])
        self.world = IPPWorld(self.cfg, fast_sweeps=bool(run.cell["fast_sweeps"]),
                              device=run.device)
        mission = next(m for m in self.cfg.missions if m.type == run.cell["mission"])
        self.planner = CMAESPlanner(self.world, mission)
        spec = next(m for m in run.config["config"]["experiment"]["missions"]
                    if m["type"] == run.cell["mission"])
        self.G, self.lam = int(spec["cma_maxiter"]), int(spec["cma_popsize"])
        self.B = int(run.cell["batch"])
        self.records: List[Dict] = []
        self.rec = None
        self.k = 0

    def setup(self) -> None:
        run, dev, B = self.run, self.run.device, self.B
        g = inputs.generator(run.seed, 0, dev)
        M, D, R = self.world.m_max_cont, 3 * self.planner.horizon, int(run.cell["ring"])
        self.gt = inputs.fields(run.config, B, g, dev)
        self.noise = [torch.randn((1, B, M), generator=g, device=dev) for _ in range(R)]
        self.normals = [torch.randn((1, B, self.G, self.lam, D), generator=g, device=dev)
                        for _ in range(R)]
        mean0, cov0 = inputs.prior(run.config, dev)
        budget0 = float(run.config["config"]["experiment"]["constraints"]["budget"])
        self.fresh = inputs.belief_state(mean0, cov0, inputs.start_pos(run.config, dev), budget0,
                                         self.gt)
        budget = budget0 * (1.0 - torch.rand((B,), generator=g, device=dev))
        self.state = self.fresh.replace(budget=budget)
        self.rng = np.random.default_rng(run.seed % (2 ** 63))
        # warm-up: one replan of every shape, on a batch that is not timed
        self.planner.run(B, max_steps=1, init_state=self.fresh, noise=self.noise[0],
                         draws=self.normals[0])
        self._record_calls()

    def _record_calls(self) -> None:
        """Keep the sampled missions' inputs and outputs of the replan's
        fitness calls, of CMA-ES's eigendecompositions and of the replan
        itself (slices, on the device).  A call over fewer missions than the
        batch (a planted fault's) keeps the rows its missions fill, modulo
        its size."""
        loss, replan, eigh = (self.planner.trajectory_loss, self.planner.replan_batch,
                              self.planner.eigh)

        def kept_loss(flat, cov, mean, pos, budget):
            out = loss(flat, cov, mean, pos, budget)
            if self.rec is not None:
                idx = self.rec["rows"] % flat.shape[0]
                self.rec["calls"].append((flat[idx].clone(), out[idx].clone()))
            return out

        def kept_replan(state, *args, **kw):
            wps, valid = replan(state, *args, **kw)
            if self.rec is not None:
                self.rec["plan"] = wps[self.rec["rows"] % wps.shape[0]].clone()
            return wps, valid

        def kept_eigh(C):
            e, V = eigh(C)
            if self.rec is not None:
                idx = self.rec["rows"] % C.shape[0]
                self.rec["eighs"].append((C[idx].clone(), e[idx].clone(), V[idx].clone()))
            return e, V

        self.planner.trajectory_loss = kept_loss
        self.planner.eigh = kept_eigh
        self.planner.replan_batch = kept_replan

    def call(self) -> None:
        r = self.k % len(self.noise)
        self.k += 1
        st = self.state
        active = st.active.nonzero()[:, 0].cpu().numpy()
        rows = self.rng.choice(active, size=min(len(active), int(self.run.cell["sample"])),
                               replace=False)
        idx = torch.as_tensor(np.sort(rows), device=self.run.device)
        self.rec = {"ring": r, "rows": idx, "calls": [], "eighs": [],
                    "cov": st.cov[idx].clone(), "mean": st.mean[idx].clone(),
                    "pos": st.pos[idx].clone(), "budget": st.budget[idx].clone()}
        res = self.planner.run(self.B, max_steps=1, init_state=st,
                               noise=self.noise[r], draws=self.normals[r])
        fin = res.final_state
        self.rec.update(moved=torch.as_tensor(~np.isnan(res.waypoints[idx.cpu().numpy(), 0, 0])),
                        wp=torch.as_tensor(res.waypoints[idx.cpu().numpy(), 0]),
                        mean_after=fin.mean[idx].clone(), cov_after=fin.cov[idx].clone())
        self.records.append(self.rec)
        self.rec = None
        self.run.replans += int(res.num_steps.sum())
        self.run.batch_replans += 1
        # a mission that could not move has ended: it starts again
        done = ~fin.active
        self.state = dataclasses.replace(fin, **{
            f.name: torch.where(done.view((-1,) + (1,) * (getattr(fin, f.name).ndim - 1)),
                                getattr(self.fresh, f.name), getattr(fin, f.name))
            for f in dataclasses.fields(fin)})

    # ------------------------------------------------------------ the check

    def judge(self, records) -> Dict[str, float]:
        dev, raw = self.run.device, self.run.config["config"]
        world = RefWorld(raw, device=dev)
        H, G, lam = self.planner_horizon, self.G, self.lam
        fit, gap, cma, err, bad, n = 0.0, 0.0, 0.0, 0.0, 0, 0
        for rec in records:
            if not len(rec["rows"]):
                continue
            st = (rec["cov"], rec["mean"], rec["pos"], rec["budget"])
            calls = rec["calls"]
            # the configuration's generations of its population, then the
            # greedy initial plan priced alone
            bad += int(len(calls) != G + 1) + int(len(rec["eighs"]) != G)
            bad += sum(int(flat.shape[1] != lam) for flat, _ in calls[:-1])
            losses = []
            for flat, out in calls:
                ref = ref_cmaes.trajectory_loss(world, flat, *st, H)
                scale = torch.clamp(ref.abs(), min=1e-3)
                fit = max(fit, float(torch.max(torch.abs(out.to(ref) - ref) / scale)))
                losses.append(ref)
            best = torch.min(torch.cat(losses, dim=1), dim=1).values
            chosen = ref_cmaes.trajectory_loss(world, rec["plan"].reshape(len(rec["rows"]), 1, -1),
                                               *st, H)[:, 0]
            # the plan kept against the best priced, and the greedy initial
            # plan (priced last) against the best lattice actions
            x0 = calls[-1][0][:, 0]
            gap = max(gap, float(torch.max((chosen - best) / torch.clamp(best.abs(), min=1e-3))),
                      float(ref_cmaes.greedy_horizon(world, *st, H, plan=x0.reshape(-1, H, 3))[1]))
            # CMA-ES's generations from the initial plan and the normals
            z = self.normals[rec["ring"]][0][rec["rows"]]
            gens = [{"C": C, "e": e, "V": V, "x": flat, "f": out}
                    for (C, e, V), (flat, out) in zip(rec["eighs"], calls[:-1])]
            cma = max(cma, ref_cmaes.follow(world, raw, x0, z, gens, H))
            # the commit at the first waypoint, with the run's noise
            wp, moved = rec["wp"].to(dev), rec["moved"].to(dev)
            cost = world.flight_time(rec["plan"][:, 0], rec["pos"])
            bad += int(torch.sum(moved & (cost > rec["budget"].to(cost) + BUDGET_TOL)))
            Hm, R, Z, var = world.measurement_model(torch.nan_to_num(wp), rows=world.H.shape[1])
            gt = self.gt[rec["rows"]].to(torch.float64)
            eps = self.noise[rec["ring"]][0][rec["rows"]].to(torch.float64)
            z = world.reading(gt, Z, var, eps)
            cov0 = rec["cov"].to(torch.float64)
            mean1, cov1 = world.commit(cov0, rec["mean"].to(torch.float64), Hm, R, z)
            mean1 = torch.where(moved[:, None], mean1, rec["mean"].to(torch.float64))
            cov1 = torch.where(moved[:, None, None], cov1, cov0)
            scale = cov0.abs().amax(dim=(-2, -1), keepdim=True)
            err = max(err, float(torch.max(torch.abs(rec["cov_after"].to(cov1) - cov1) / scale)),
                      float(torch.max(torch.abs(rec["mean_after"].to(mean1) - mean1))))
            n += len(rec["rows"])
        return {"fitness_err": fit, "choice_gap": gap, "cma_err": cma, "belief_err": err,
                "violations": bad, "replans_checked": n}

    def check(self) -> Dict[str, float]:
        self.planner_horizon = self.planner.horizon
        self.planner = self.world = self.state = self.fresh = None
        return self.judge(self.records)

    def control(self) -> Dict[str, float]:
        """The plain reference in bfloat16 put in the program's place on the
        kept replans: it makes its own greedy initial plan, runs CMA-ES from
        it on the same normals, prices every generation's members and the
        initial plan, keeps the best, and commits its first waypoint."""
        dev, raw = self.run.device, self.run.config["config"]
        low = RefWorld(raw, device=dev, arith=Arith("bf16"))
        H = self.planner.horizon
        self.planner_horizon = H
        records = []
        for rec in self.records:
            if not len(rec["rows"]):
                continue
            st = (rec["cov"], rec["mean"], rec["pos"], rec["budget"])
            x0 = ref_cmaes.greedy_horizon(low, *st, H)[0].reshape(len(rec["rows"]), -1).float()
            z = self.normals[rec["ring"]][0][rec["rows"]]
            gens = ref_cmaes.run_cma(low, raw, x0, z,
                                     lambda x: ref_cmaes.trajectory_loss(low, x, *st, H), H)
            calls = [(g["x"], g["f"]) for g in gens]
            calls.append((x0[:, None], ref_cmaes.trajectory_loss(low, x0[:, None], *st, H)))
            flat = torch.cat([c[0] for c in calls], dim=1)
            loss = torch.cat([c[1] for c in calls], dim=1)
            plan = flat[torch.arange(len(flat)), torch.argmin(loss, dim=1)].reshape(-1, H, 3)
            Hm, R, Z, var = low.measurement_model(plan[:, 0], rows=low.H.shape[1])
            gt = self.gt[rec["rows"]].float()
            eps = self.noise[rec["ring"]][0][rec["rows"]].float()
            z = low.reading(gt, Z.float(), var.float(), eps)
            moved = rec["moved"].to(dev)
            mean1, cov1 = low.commit(rec["cov"].float(), rec["mean"].float(), Hm.float(),
                                     R.float(), z)
            records.append(dict(rec, calls=calls, plan=plan, wp=plan[:, 0],
                                eighs=[(g["C"], g["e"], g["V"]) for g in gens],
                                mean_after=torch.where(moved[:, None], mean1, rec["mean"]),
                                cov_after=torch.where(moved[:, None, None], cov1, rec["cov"])))
        return self.judge(records)
