#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ipp_rl_tpu_torch``) on one card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card (an H100: the kernels are built for sm_90a) and
the CUDA toolkit; it exits non-zero, printing no result, without them.
Phases, each of which fails the run on a failed check:

1. the card (``nvidia-smi`` name and power limit) and the build of
   ``ipp_rl_tpu_torch/csrc/smallchol.cu`` from the repository's source;
2. each hand-written kernel against its plain PyTorch version on the card,
   at the main path's shapes, bit for bit: ``spd_inverse`` at B = 4096 and
   4097 (ragged tail) on random SPD 9x9 inputs and on inputs whose last
   pivot goes negative (the clamp); ``spd_trace_product`` on packed lower
   triangles in both sweep layouts of one B = 4096 replan step, (100, 45,
   4096) for the dense group and (4096, 45, 100) for the gather group
   (819,200 blocks), on a ragged ``inner`` and on clamped pivots.  Times:
   the kernel's device time from a CUDA graph of many launches replayed
   between CUDA events (``ms``), the per-call time of back-to-back calls
   between CUDA events (``call_ms``, host-paced for a short kernel), the
   wrapper's host time per call (``host_ms``), the plain version's and one
   library call's; for ``spd_inverse`` also the device time of one CTA's
   tile of 32 matrices (``one_cta_ms``: one thread's chain and a launch);
3. the greedy slice through its entry points: canonical
   ``ipp_rl_tpu_torch/config/example.yaml``, ``IPPWorld(cfg, fast_sweeps=True)``,
   ``GreedyPlanner.run`` with B = 4096 for 10 replan steps, with the launch
   counters set to 0 just before and read just after;
4. at B = 512, the same slice with the kernels and with their plain
   versions, from the same state and noise: the actions must agree and the
   metric curves must match.

Float32 products run in full float32: TF32 is switched off for matmuls
and cuDNN.  The last stdout line is ``{"ok": true, "device": {...}}``;
the lines before it carry the per-kernel JSON and the card.  A fuller
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from ipp_rl_tpu_torch.config import CONFIG_DIR, MissionConfig, load_config
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kernels, smallchol
from ipp_rl_tpu_torch.planners import GreedyPlanner

ROOT = pathlib.Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
M = 9  # measurement rows per action on the canonical config
T = M * (M + 1) // 2  # entries of a packed lower triangle
ACTIONS_PER_GROUP = 100  # each of the canonical config's two sweep groups
REPLAN_B, REPLAN_STEPS = 4096, 10
AGREE_B, AGREE_STEPS = 512, 4
# the kernels repeat their plain versions' operations in the same order,
# one rounding each: they are held to bitwise equality; the metric curves
# of the agreement phase to this relative tolerance
METRIC_RTOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int, replays: int = 5) -> float:
    """Device time per call of fn(): a CUDA graph of `launches` calls,
    replayed between CUDA events, so the host sets no pace."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def host_ms(fn, iters: int) -> float:
    """Host time per call of fn(): enqueue only, no synchronisation inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


# ------------------------------------------------------------ bound model

def _inverse_factor_ops(m: int) -> int:
    """Operations of the shared Cholesky + forward substitution, counted
    one per add, multiply, divide, square root, compare and negation."""
    ops = 0
    for j in range(m):
        ops += 2 * j + 3  # pivot: j mul, j sub, clamp, sqrt, reciprocal
        ops += (m - j - 1) * (2 * j + 1)  # column below the pivot
        ops += 1  # Li diagonal reciprocal
        ops += sum(2 * (i - j) + 1 for i in range(j + 1, m))  # Li entries
    return ops


def inverse_ops(m: int) -> int:
    entries = sum(2 * (m - i) - 1 for i in range(m) for _ in range(i + 1))
    return _inverse_factor_ops(m) + entries


def trace_ops(m: int) -> int:
    pairs = [(i, j) for i in range(m) for j in range(i + 1)]
    entries = sum(2 * (m - i) - 1 + 1 + (i != j) for i, j in pairs) + len(pairs) - 1
    return _inverse_factor_ops(m) + entries


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel phase

def random_spd(n: int, gen: torch.Generator) -> torch.Tensor:
    A = torch.randn((n, M, M), generator=gen, device="cuda")
    return A @ A.mT + 0.5 * torch.eye(M, device="cuda")


def make_indefinite(S: torch.Tensor) -> torch.Tensor:
    """S with its last pivot driven negative, so the kernels clamp it."""
    S = S.clone()
    S[..., -1, -1] -= 2.0 * S.diagonal(dim1=-2, dim2=-1).sum(-1)
    return S


def packed(S: torch.Tensor, outer: int, inner: int) -> torch.Tensor:
    """(outer * inner, M, M) blocks → the kernel's (outer, T, inner) layout."""
    return smallchol.pack_lower(S).view(outer, inner, T).transpose(1, 2).contiguous()


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    check(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    check(bool(torch.isfinite(want).all()), f"{name}: plain output not finite")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel = err / scale
    same = bool(torch.equal(got, want))
    log(f"  {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
        f"bitwise_equal={same} (tolerance: bitwise)")
    check(same, f"{name}: kernel differs from its plain version ({rel:.3e})")
    return {"max_abs_err": err, "max_rel_err": rel}


def times(fn, graph_launches: int, calls: int) -> dict:
    return {"ms": graph_ms(fn, graph_launches), "call_ms": cuda_ms(fn, calls),
            "host_ms": host_ms(fn, calls)}


def kernel_phase(gen: torch.Generator) -> list:
    log("== kernels against their plain versions")
    rows = []

    # spd_inverse: the commit's B innovation inverses per replan step
    S = random_spd(REPLAN_B, gen)
    inv_err = compare("spd_inverse B=4096", kernels.spd_inverse(S), smallchol.spd_inverse(S))
    S_tail = random_spd(REPLAN_B + 1, gen)
    compare("spd_inverse B=4097", kernels.spd_inverse(S_tail), smallchol.spd_inverse(S_tail))
    S_bad = make_indefinite(random_spd(REPLAN_B + 1, gen))
    got_bad = kernels.spd_inverse(S_bad)
    compare("spd_inverse indefinite (clamped pivot)", got_bad, smallchol.spd_inverse(S_bad))
    check(got_bad[:, -1, -1].abs().min().item() > 1e29, "clamped pivot: expected ~1e30 entries")
    ref = torch.linalg.inv(S.double())
    check((kernels.spd_inverse(S).double() - ref).abs().max().item()
          <= 1e-3 * ref.abs().max().item(), "spd_inverse: far from torch.linalg.inv (f64)")
    t = times(lambda: kernels.spd_inverse(S), graph_launches=200, calls=200)
    S_cta = S[:32]
    t["one_cta_ms"] = graph_ms(lambda: kernels.spd_inverse(S_cta), 200)
    plain_ms = cuda_ms(lambda: smallchol.spd_inverse(S), 10)
    lib_ms = cuda_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(S)), 50)
    nbytes = 2 * S.numel() * S.element_size()
    b_ms, b_by = bound(nbytes, REPLAN_B * inverse_ops(M))
    rows.append({
        "name": "spd_inverse", "route": "cuda",
        "source": "ipp_rl_tpu_torch/csrc/smallchol.cu",
        "replaces": "ipp_rl_tpu/ops/pallas_kernels.py:71",
        "shape": [REPLAN_B, M, M], "dtype": "float32",
        **inv_err, **t, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes": nbytes, "library_ms": lib_ms,
        "library_call": "torch.cholesky_inverse(torch.linalg.cholesky(S))",
    })

    # spd_trace_product: both sweep groups of one replan step, 2 x 100 x 4096
    # blocks, each group in its own packed layout
    A, B = ACTIONS_PER_GROUP, REPLAN_B
    n = 2 * A * B
    S_full, G_full = random_spd(n, gen), random_spd(n, gen)
    layouts = {  # name: (outer, inner), as ops/kalman.py builds them
        "dense (100, 45, 4096)": (A, B),
        "gather (4096, 45, 100)": (B, A),
    }
    tr_err = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    per_layout = {}
    for k, (name, (outer, inner)) in enumerate(layouts.items()):
        part = slice(k * A * B, (k + 1) * A * B)
        Sp, Gp = packed(S_full[part], outer, inner), packed(G_full[part], outer, inner)
        err = compare(f"spd_trace_product {name}", kernels.spd_trace_product_packed(Sp, Gp),
                      smallchol.spd_trace_product_packed(Sp, Gp))
        tr_err = {key: max(tr_err[key], err[key]) for key in tr_err}
        per_layout[name] = {
            **times(lambda: kernels.spd_trace_product_packed(Sp, Gp), graph_launches=20,
                    calls=20),
            "plain_ms": cuda_ms(lambda: smallchol.spd_trace_product_packed(Sp, Gp), 3, warmup=1),
        }
    Sr, Gr = packed(S_full[:3 * 1001], 3, 1001), packed(G_full[:3 * 1001], 3, 1001)
    compare("spd_trace_product ragged (3, 45, 1001)", kernels.spd_trace_product_packed(Sr, Gr),
            smallchol.spd_trace_product_packed(Sr, Gr))
    Sb = packed(make_indefinite(S_full[:B * 7]), B, 7)
    Gb = packed(G_full[:B * 7], B, 7)
    got_bad = kernels.spd_trace_product_packed(Sb, Gb)
    compare("spd_trace_product indefinite (clamped pivot)", got_bad,
            smallchol.spd_trace_product_packed(Sb, Gb))
    check(got_bad.abs().min().item() > 1e20, "clamped pivot: expected huge trace products")
    lib_ms = cuda_ms(
        lambda: torch.cholesky_solve(G_full, torch.linalg.cholesky(S_full))
        .diagonal(dim1=-2, dim2=-1).sum(-1),
        3, warmup=1,
    )
    nbytes = (2 * T + 1) * n * S_full.element_size()
    b_ms, b_by = bound(nbytes, n * trace_ops(M))
    rows.append({
        "name": "spd_trace_product", "route": "cuda",
        "source": "ipp_rl_tpu_torch/csrc/smallchol.cu",
        "replaces": "ipp_rl_tpu/ops/smallchol.py:51",
        "shape": [n, T], "dtype": "float32", "layouts": per_layout,
        **tr_err,
        **{key: sum(v[key] for v in per_layout.values())
           for key in ("ms", "call_ms", "host_ms", "plain_ms")},
        "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
        "library_ms": lib_ms,
        "library_call": "torch.cholesky_solve(G, torch.linalg.cholesky(S)).diagonal(...).sum(-1)"
                        " on the full (n, 9, 9) blocks",
    })
    log(f"  spd_inverse on 32 matrices (one CTA): {rows[0]['one_cta_ms']:.4f} ms device")
    for r in rows:
        log(f"  {r['name']}: kernel {r['ms']:.4f} ms device (graph), {r['call_ms']:.4f} ms "
            f"per back-to-back call, host {r['host_ms']:.4f} ms per call; plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_bytes'] / 1e6:.2f} MB), "
            f"{r['bound_ms'] / r['ms']:.0%} of it")
    for name, v in per_layout.items():
        log(f"    spd_trace_product {name}: {v['ms']:.4f} ms device, "
            f"{v['call_ms']:.4f} ms per call, plain {v['plain_ms']:.3f} ms")
    return rows


# ------------------------------------------------------------ greedy slice

@contextlib.contextmanager
def plain_versions():
    """Route the sweep and the commit through the plain versions (for the
    comparison only; the port itself has no such switch)."""
    saved = kernels.spd_inverse, kernels.spd_trace_product_packed
    kernels.spd_inverse, kernels.spd_trace_product_packed = (
        smallchol.spd_inverse, smallchol.spd_trace_product_packed,
    )
    try:
        yield
    finally:
        kernels.spd_inverse, kernels.spd_trace_product_packed = saved


def greedy_phase(cfg) -> dict:
    log(f"== greedy slice: example.yaml, fast_sweeps, B={REPLAN_B}, {REPLAN_STEPS} steps")
    world = IPPWorld(cfg, fast_sweeps=True)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    planner.run(REPLAN_B, max_steps=1, generator=gen)  # warm-up: handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = planner.run(REPLAN_B, max_steps=REPLAN_STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "spd_inverse": kernels.spd_inverse.launches,
        "spd_trace_product": kernels.spd_trace_product_packed.launches,
    }
    log(f"  launches in the run: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    unc = res.metrics["uncertainty"]
    check(unc.shape == (REPLAN_B, REPLAN_STEPS + 1), f"uncertainty shape {unc.shape}")
    # wrmse and wmll keep the reference's weighting, which can go negative
    # under a square root or log (NaN); the JAX package gives the same
    for k in ("rmse", "mll", "uncertainty", "uncertainty_difference"):
        check(bool(np.isfinite(res.metrics[k]).all()), f"metric {k} not finite")
    mean_unc = unc.mean(axis=0)
    log(f"  mean uncertainty per step: {np.array2string(mean_unc, precision=3)}")
    check(bool(np.all(np.diff(mean_unc) < 0)), "uncertainty does not fall step over step")

    # steady replan step, split into sweep (plan) and commit (step_index)
    state = res.final_state
    action = planner.plan(state, gen, 0)
    plan_ms = cuda_ms(lambda: planner.plan(state, gen, 0), 5)
    commit_ms = cuda_ms(lambda: world.step_index(state, action, generator=gen), 5)
    out = {
        "batch": REPLAN_B, "steps": REPLAN_STEPS,
        "run_wall_s": wall,
        "ms_per_step": wall / REPLAN_STEPS * 1e3,
        "replans_per_s": REPLAN_B * REPLAN_STEPS / wall,
        "plan_ms": plan_ms, "commit_ms": commit_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mean_uncertainty": mean_unc.tolist(),
        "launches": launches,
    }
    log(f"  run: {out['ms_per_step']:.3f} ms/step, {out['replans_per_s']:.1f} replans/s; "
        f"plan {plan_ms:.3f} ms, commit {commit_ms:.3f} ms; "
        f"peak {out['peak_mem_gb']:.2f} GB")
    return out


def agreement_phase(cfg) -> dict:
    log(f"== kernels vs plain versions on the slice: B={AGREE_B}, {AGREE_STEPS} steps")
    world = IPPWorld(cfg, fast_sweeps=True)
    planner = GreedyPlanner(world, MissionConfig(type="greedy"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    state0 = world.init_state(AGREE_B, gen)
    noise = torch.randn((AGREE_STEPS, AGREE_B, world.H.shape[1]), generator=gen, device="cuda")
    with_kernels = planner.run(AGREE_B, AGREE_STEPS, init_state=state0, noise=noise)
    with plain_versions():
        plain = planner.run(AGREE_B, AGREE_STEPS, init_state=state0, noise=noise)
    same = np.array_equal(with_kernels.waypoints, plain.waypoints, equal_nan=True)
    check(same, "the kernels and the plain versions chose different actions")
    worst = 0.0
    for k, v in plain.metrics.items():
        got = with_kernels.metrics[k]
        check(np.array_equal(np.isnan(got), np.isnan(v)), f"metric {k}: NaN patterns differ")
        rel = np.nanmax(np.abs(got - v)) / max(np.nanmax(np.abs(v)), 1e-30)
        worst = max(worst, float(rel))
    log(f"  actions identical; worst metric rel diff {worst:.3e} (tolerance {METRIC_RTOL:g})")
    check(worst <= METRIC_RTOL, "metric curves differ between kernels and plain versions")
    return {"batch": AGREE_B, "steps": AGREE_STEPS, "actions_identical": True,
            "worst_metric_rel_diff": worst}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    lib_path = kernels.build()
    build_s = time.perf_counter() - t0
    log(f"build: {lib_path.name} in {build_s:.1f} s (nvcc {kernels.build_seconds:.1f} s)")
    report = lib_path.with_suffix(".log")
    if report.exists():  # the compiler's register/spill report for the M = 9 f32 kernels
        show = False
        for line in report.read_text().splitlines():
            if "Compiling entry function" in line:
                show = "ILi9EfE" in line
            if show:
                log("  ptxas:", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = kernel_phase(gen)
    cfg = load_config(str(CONFIG_DIR / "example.yaml"))
    greedy = greedy_phase(cfg)
    agreement = agreement_phase(cfg)
    for r in rows:
        r["launches"] = greedy["launches"][r["name"]]

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s, "kernels": rows,
        "greedy": greedy, "agreement": agreement,
    }, indent=1))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
