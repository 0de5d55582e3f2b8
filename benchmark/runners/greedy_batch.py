"""Runner of batched greedy missions through ``Planner.run``.

Set-up builds the port's world and planner from the configuration file,
makes a pool of ``pool`` input batches from the seed (ground truths and
the noise of every step; every mission starts from the prior at the
first cell's centre with the whole budget) and warms the shapes up with
a two-step call.  Each timed call runs one batch of ``batch`` whole
missions (``Planner.run`` to its step bound), cycling through the pool.
A call's replans are the moves of missions that were still active.

From each call ``sample`` missions drawn from the seed, and the
longest mission of the call, are kept for the comparison with the plain
reference (``benchmark/reference/greedy.py``), which runs once the
window has closed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference.greedy import belief_err, greedy_loop
from benchmark.reference.world import Arith, RefWorld


class Runner:
    def __init__(self, run):
        from ipp_rl_tpu_torch.config import config_from_dict
        from ipp_rl_tpu_torch.env.world import IPPWorld
        from ipp_rl_tpu_torch.planners.greedy import GreedyPlanner

        self.run = run
        cell = run.cell
        self.cfg = config_from_dict(run.config["config"])
        self.world = IPPWorld(self.cfg, fast_sweeps=bool(cell["fast_sweeps"]), device=run.device)
        mission = next(m for m in self.cfg.missions if m.type == cell["mission"])
        self.planner = GreedyPlanner(self.world, mission)
        self.B = int(cell["batch"])
        self.T = self.planner.max_steps()
        self.records: List[Dict] = []
        self.k = 0

    def setup(self) -> None:
        run, world, B, T = self.run, self.world, self.B, self.T
        dev = run.device
        g = inputs.generator(run.seed, 0, dev)
        P = int(run.cell["pool"])
        M = world.H.shape[1]
        self.gt = [inputs.fields(run.config, B, g, dev) for _ in range(P)]
        self.noise = [torch.randn((T, B, M), generator=g, device=dev) for _ in range(P)]
        self.mean0, self.cov0 = inputs.prior(run.config, dev)
        self.pos0 = inputs.start_pos(run.config, dev)
        self.budget0 = float(run.config["config"]["experiment"]["constraints"]["budget"])
        self.rng = np.random.default_rng(run.seed % (2 ** 63))
        # warm-up: every shape of a call, two steps
        self.planner.run(B, max_steps=2, init_state=self._state(0), noise=self.noise[0][:2])

    def _state(self, p: int):
        return inputs.belief_state(self.mean0, self.cov0, self.pos0, self.budget0, self.gt[p])

    def call(self) -> None:
        p = self.k % len(self.gt)
        self.k += 1
        res = self.planner.run(self.B, init_state=self._state(p), noise=self.noise[p])
        run = self.run
        run.replans += int(res.num_steps.sum())
        run.batch_replans += self.T
        rows = self.rng.choice(self.B, size=int(run.cell["sample"]), replace=False)
        rows = np.unique(np.append(rows, int(np.argmax(res.num_steps))))
        idx = torch.as_tensor(rows, device=run.device)
        self.records.append({
            "pool": p, "rows": idx,
            "waypoints": torch.as_tensor(res.waypoints[rows]),
            "uncertainty": torch.as_tensor(res.metrics["uncertainty"][rows]),
            "rmse": torch.as_tensor(res.metrics["rmse"][rows]),
            "mean": res.final_state.mean[idx].clone(), "cov": res.final_state.cov[idx].clone(),
        })

    # ------------------------------------------------------------ the check

    def _inputs(self, rec):
        idx = rec["rows"]
        return {"mean": self.mean0.expand(len(idx), -1), "cov": self.cov0.expand(len(idx), -1, -1),
                "pos": self.pos0.expand(len(idx), 3),
                "budget": torch.full((len(idx),), self.budget0, device=self.run.device),
                "gt": self.gt[rec["pool"]][idx]}, self.noise[rec["pool"]][:, idx].transpose(0, 1)

    def judge(self, records) -> Dict[str, float]:
        """The comparison: each kept mission replayed by the float64
        reference along the waypoints it flew."""
        ref_world = RefWorld(self.run.config["config"], device=self.run.device)
        gap, err, bad, moves = 0.0, 0.0, 0, 0
        for rec in records:
            init, noise = self._inputs(rec)
            ref = greedy_loop(ref_world, init, noise, self.T, waypoints=rec["waypoints"])
            ref["cov0"] = init["cov"].to(torch.float64)
            gap = max(gap, float(ref["reward_gap"]))
            err = max(err, float(belief_err(ref, rec)))
            bad += int(ref["violations"])
            moves += int(ref["moves"])
        return {"reward_gap": gap, "belief_err": err, "violations": bad, "moves_checked": moves,
                "missions_checked": sum(len(r["rows"]) for r in records)}

    def check(self) -> Dict[str, float]:
        self.planner = self.world = None
        torch.cuda.empty_cache() if self.run.device.type == "cuda" else None
        return self.judge(self.records)

    def control(self) -> Dict[str, float]:
        """The plain reference in bfloat16 put in the program's place on the
        same kept missions, judged as the program is."""
        low = RefWorld(self.run.config["config"], device=self.run.device, arith=Arith("bf16"))
        records = []
        for rec in self.records:
            init, noise = self._inputs(rec)
            out = greedy_loop(low, init, noise, self.T)
            records.append({"pool": rec["pool"], "rows": rec["rows"], "waypoints": out["waypoints"],
                            "uncertainty": out["uncertainty"], "rmse": out["rmse"],
                            "mean": out["mean"], "cov": out["cov"]})
        return self.judge(records)
