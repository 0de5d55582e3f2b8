"""Plain reference of the CMA-ES replanner's pieces, for the comparison
that judges a CMA-ES run step by step from the program's own states
(CMA-ES's samples hang on eigenvectors that a last-bit difference turns,
so no independent run follows the program's draws):

* ``trajectory_loss``: the objective of a horizon of continuous
  waypoints: −Σ gain / path cost, each waypoint's information gain
  against the belief the earlier waypoints left while the budget lasts,
  100 for a plan that leaves the box or has no length;
* ``greedy_horizon``: the greedy initial plan, or how far each waypoint
  of a given one lies below the best affordable lattice action against
  the hypothetical belief the plan's earlier waypoints leave;
* ``cma``: CMA-ES's generations (the port's minimal variant: CSA step
  size, rank-1 and rank-μ covariance adaptation, h_σ without the
  generation term), either run whole (``run_cma``) or followed from the
  program's covariances (``follow``), which judges every generation's
  covariance, its eigendecomposition and its members.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from benchmark.reference.world import RefWorld

PENALTY = 100.0
#: the reference experiment's initial step size where the config names none
SIGMA0 = 1.0


def trajectory_loss(world: RefWorld, flat: torch.Tensor, cov, mean, pos, budget,
                    horizon: int) -> torch.Tensor:
    """(S, K) losses of K candidate plans flat (S, K, 3·horizon)."""
    r = world.arith.r
    dt = world.arith.dtype
    S, K, _ = flat.shape
    wps = flat.to(world.device, torch.float64).reshape(S * K, horizon, 3)
    oob = torch.any(world.out_of_bounds(wps), dim=-1)
    prev = torch.cat([pos.to(torch.float64).repeat_interleave(K, 0)[:, None], wps[:, :-1]], 1)
    seg = world.flight_time(wps, prev)  # (SK, H)
    path = torch.sum(seg, dim=-1)
    P = cov.to(world.device, dt).repeat_interleave(K, 0)
    mask = world.roi(mean.to(world.device, dt), cov.to(world.device, dt))
    mask = None if mask is None else mask.repeat_interleave(K, 0)
    rem = budget.to(world.device, torch.float64).repeat_interleave(K, 0)
    total = torch.zeros_like(rem)
    alive = torch.ones_like(rem, dtype=torch.bool)
    M = world.H.shape[1]
    for h in range(horizon):
        cost = seg[:, h]
        alive = alive & (cost <= rem)
        Hm, R, _, _ = world.measurement_model(wps[:, h], rows=M)
        Hm, R = Hm.to(dt), R.to(dt)
        gain = world.gains(P, mask, Hm[:, None], R[:, None])[:, 0].to(torch.float64)
        total = total + torch.where(alive, gain, 0.0)
        if h + 1 < horizon:
            HP = r(Hm @ P)
            Sm = r(HP @ Hm.mT)
            Sm = r(0.5 * (Sm + Sm.mT)) + torch.diag_embed(R)
            P_new = r(P - r(HP.mT @ r(torch.linalg.inv(Sm) @ HP)))
            P = torch.where(alive[:, None, None], r(0.5 * (P_new + P_new.mT)), P)
        rem = torch.where(alive, rem - cost, rem)
    loss = -total / torch.clamp(path, min=1e-12)
    return torch.where(oob | (path <= 0), PENALTY, loss).view(S, K)


def greedy_horizon(world: RefWorld, cov, mean, pos, budget, horizon: int, plan=None):
    """The greedy initial plan: each step the best affordable lattice
    action against the covariance-only belief of the steps before (with
    nothing affordable the first lattice action, the belief kept).  Given
    a ``plan`` (S, horizon, 3) it follows that plan instead.  Returns the
    plan and the widest relative gap by which one of its steps lies below
    the best affordable action."""
    dt = world.arith.dtype
    S = cov.shape[0]
    P = cov.to(world.device, dt)
    mean = mean.to(world.device, dt)
    pos = pos.to(world.device, torch.float64)
    rem = budget.to(world.device, torch.float64)
    rows = torch.arange(S, device=world.device)
    gap = torch.zeros((), dtype=torch.float64, device=world.device)
    steps = []
    for h in range(horizon):
        costs = world.flight_time(world.xyz[None], pos[:, None])
        ok = (costs > 0) & (costs <= rem[:, None])
        g = world.gains(P, world.roi(mean, P), world.H[None].expand(S, -1, -1, -1),
                        world.R[None].expand(S, -1, -1)).to(torch.float64)
        rewards = torch.where(ok, g / (costs + 1.0), float("-inf"))
        best, a = torch.max(rewards, dim=-1)
        if plan is not None:
            a = world.action_index(plan[:, h])
        any_ok = ok.any(dim=-1)
        rel = (best - rewards[rows, a]) / torch.clamp(best, min=1e-6)
        gap = torch.maximum(gap, torch.max(torch.where(any_ok, rel, 0.0)))
        _, P_n = world.commit(P, mean, world.H[a], world.R[a], torch.zeros_like(world.R[a]))
        P = torch.where(any_ok[:, None, None], P_n, P)
        rem = torch.where(any_ok, rem - costs[rows, a], rem)
        pos = torch.where(any_ok[:, None], world.xyz[a], pos)
        steps.append(world.xyz[a])
    return torch.stack(steps, dim=1), gap


def cma_box(raw: Dict, horizon: int):
    """(sigma scales, lower, upper) (3·horizon,) of the flattened plan:
    x and y at cma_sigma, z at most half the altitude band; the box the
    map and the altitudes span."""
    env, con = raw["environment"], raw["experiment"]["constraints"]
    m = next(m for m in raw["experiment"]["missions"] if m["type"] == "cmaes")
    s = float(m.get("cma_sigma", SIGMA0))
    lo_z, hi_z = float(con["min_altitude"]), float(con["max_altitude"])
    sz = min(s, (hi_z - lo_z) / 2.0)
    ext_x, ext_y = env["x_dim"] * float(env["resolution"]), env["y_dim"] * float(env["resolution"])

    def tile(v):
        return torch.tensor(v * horizon, dtype=torch.float64)

    return tile([s, s, sz]), tile([0.0, 0.0, lo_z]), tile([ext_x, ext_y, hi_z])


def cma_constants(D: int, lam: int) -> Dict:
    mu = lam // 2
    w = [math.log(mu + 0.5) - math.log(i + 1) for i in range(mu)]
    w = [v / sum(w) for v in w]
    mu_eff = 1.0 / sum(v * v for v in w)
    c_sigma = (mu_eff + 2.0) / (D + mu_eff + 5.0)
    c_c = (4.0 + mu_eff / D) / (D + 4.0 + 2.0 * mu_eff / D)
    chi_n = math.sqrt(D) * (1.0 - 1.0 / (4.0 * D) + 1.0 / (21.0 * D * D))
    c_1 = 2.0 / ((D + 1.3) ** 2 + mu_eff)
    return {
        "mu": mu, "w": w, "c_sigma": c_sigma, "c_c": c_c, "c_1": c_1,
        "c_mu": min(1.0 - c_1, 2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((D + 2.0) ** 2 + mu_eff)),
        "d_sigma": 1.0 + 2.0 * max(0.0, math.sqrt((mu_eff - 1.0) / (D + 1.0)) - 1.0) + c_sigma,
        "chi_n": chi_n, "path_sigma": math.sqrt(c_sigma * (2.0 - c_sigma) * mu_eff),
        "path_c": math.sqrt(c_c * (2.0 - c_c) * mu_eff),
        "h_norm": math.sqrt(1.0 - (1.0 - c_sigma) ** 2),
        "h_limit": (1.4 + 2.0 / (D + 1.0)) * chi_n,
    }


def _eigh(world: RefWorld, C):
    """The eigendecomposition of C in the working precision (values
    clamped at 1e-20, as CMA-ES floors them)."""
    r = world.arith.r
    e, V = torch.linalg.eigh(C.to(world.arith.dtype))
    return r(torch.clamp(e, min=1e-20)), r(V)


def _update(world: RefWorld, k: Dict, st: Dict, C, x, f) -> Dict:
    """One generation's update of (mean, sigma, p_sigma, p_c) and the new
    covariance, from the covariance C the generation sampled with, its
    members x (S, λ, D) and their losses f (S, λ) (ranked stably)."""
    r, dt = world.arith.r, world.arith.dtype
    S, lam, D = x.shape
    mu = k["mu"]
    w = torch.tensor(k["w"], dtype=dt, device=x.device)
    x, C = x.to(dt), C.to(dt)
    mean, sigma = st["mean"], st["sigma"]
    order = torch.argsort(f, dim=-1, stable=True)[:, :mu]
    x_sel = torch.gather(x, 1, order[:, :, None].expand(S, mu, D))
    y_sel = r((x_sel - mean[:, None]) / sigma[:, None, None])
    mean_new = r(mean + torch.sum(w[None, :, None] * r(x_sel - mean[:, None]), dim=1))
    y_w = r(torch.sum(w[None, :, None] * y_sel, dim=1))
    e, V = _eigh(world, C)
    C_inv_sqrt = r((V * (1.0 / torch.sqrt(e))[:, None, :]) @ V.mT)
    p_sigma = r((1.0 - k["c_sigma"]) * st["p_sigma"]
                + k["path_sigma"] * (C_inv_sqrt @ y_w[..., None])[..., 0])
    norm = torch.sqrt(torch.sum(p_sigma * p_sigma, dim=-1))
    sigma_new = r(sigma * torch.exp((k["c_sigma"] / k["d_sigma"]) * (norm / k["chi_n"] - 1.0)))
    h = (norm / k["h_norm"] < k["h_limit"]).to(dt)
    p_c = r((1.0 - k["c_c"]) * st["p_c"] + (h * k["path_c"])[:, None] * y_w)
    rank1 = p_c[:, :, None] * p_c[:, None, :]
    rank_mu = r((w[None, :, None] * y_sel).mT @ y_sel)
    C_new = r((1.0 - k["c_1"] - k["c_mu"]) * C
              + k["c_1"] * (rank1 + ((1.0 - h) * k["c_c"] * (2.0 - k["c_c"]))[:, None, None] * C)
              + k["c_mu"] * rank_mu)
    return {"mean": mean_new, "sigma": sigma_new, "p_sigma": p_sigma, "p_c": p_c,
            "C": r(0.5 * (C_new + C_new.mT))}


def _sample(world: RefWorld, st: Dict, e, V, z, lower, upper):
    """Members clamp(mean + sigma · z (V √e)ᵀ) (S, λ, D)."""
    r, dt = world.arith.r, world.arith.dtype
    Dm = r(V.to(dt) * torch.sqrt(e.to(dt))[:, None, :])
    y = r(z.to(dt) @ Dm.mT)
    x = r(st["mean"][:, None] + st["sigma"][:, None, None] * y)
    return torch.clamp(x, lower.to(x), upper.to(x))


def _start(world: RefWorld, x0, scales):
    dt = world.arith.dtype
    S, D = x0.shape
    zeros = torch.zeros((S, D), dtype=dt, device=x0.device)
    C0 = torch.diag_embed(scales.to(x0.device, dt) ** 2).expand(S, D, D)
    return {"mean": x0.to(dt), "sigma": torch.ones((S,), dtype=dt, device=x0.device),
            "p_sigma": zeros, "p_c": zeros.clone(), "C": C0}


def run_cma(world: RefWorld, raw: Dict, x0, z, objective: Callable, horizon: int) -> List[Dict]:
    """CMA-ES whole in the world's arithmetic from x0 (S, D) with the
    normals z (S, G, λ, D): each generation's (C, e, V, x, f)."""
    scales, lower, upper = cma_box(raw, horizon)
    S, G, lam, D = z.shape
    k = cma_constants(D, lam)
    st = _start(world, x0, scales)
    gens = []
    for g in range(G):
        e, V = _eigh(world, st["C"])
        x = _sample(world, st, e, V, z[:, g], lower, upper)
        f = objective(x)
        gens.append({"C": st["C"], "e": e, "V": V, "x": x, "f": f})
        st = _update(world, k, st, st["C"], x, f)
    return gens


def follow(world: RefWorld, raw: Dict, x0, z, gens: List[Dict], horizon: int) -> float:
    """The widest relative error of the program's CMA-ES generations
    ``gens`` (each the covariance C it sampled with, that covariance's
    eigenpairs e, V, its members x and their losses f) from x0 (S, D)
    with the normals z (S, G, λ, D): each covariance against the
    reference's update of the one before (the first against the scales'
    diagonal), each eigendecomposition against its covariance, and each
    generation's members against the reference's mean and step size
    through the program's eigenvectors (an eigenbasis is the program's
    choice where eigenvalues repeat)."""
    scales, lower, upper = cma_box(raw, horizon)
    k = cma_constants(z.shape[-1], z.shape[2])
    f64 = torch.float64
    st = _start(world, x0, scales)
    err = 0.0
    for g, gen in enumerate(gens):
        C = gen["C"].to(f64)
        scale = st["C"].abs().amax(dim=(-2, -1))
        err = max(err, float(torch.max((C - st["C"]).abs().amax(dim=(-2, -1)) / scale)))
        e, V = gen["e"].to(f64), gen["V"].to(f64)
        eye = torch.eye(V.shape[-1], dtype=f64, device=V.device)
        back = (V * e[:, None, :]) @ V.mT
        err = max(err, float(torch.max((back - C).abs().amax(dim=(-2, -1)) / scale)),
                  float(torch.max((V.mT @ V - eye).abs())))
        x = _sample(world, st, e, V, z[:, g], lower, upper)
        err = max(err, float(torch.max((gen["x"].to(f64) - x).abs()
                                       / torch.clamp(x.abs(), min=1.0))))
        st = _update(world, k, st, C, gen["x"], gen["f"])
    return err
