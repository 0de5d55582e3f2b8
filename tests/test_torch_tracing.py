"""The port's tracer (ipp_rl_tpu_torch/utils/tracing.py): off it records
nothing; on, spans nest with their parents and requests, on the clock the
profiler stamps its events with; the planners give the same results with
it on and off; ``host_syncs`` counts the search's reads from the device;
the kernel launch counters are views of its counters."""

import dataclasses

import numpy as np
import pytest
import torch

from ipp_rl_tpu_torch.config import MCTSZeroHyperParams, MissionConfig
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.ops import kernels
from ipp_rl_tpu_torch.planners import CMAESPlanner, GreedyPlanner
from ipp_rl_tpu_torch.planners.zero import ZeroPlanner
from ipp_rl_tpu_torch.planners.zero import train
from ipp_rl_tpu_torch.planners.zero.features import init_history, push_history
from ipp_rl_tpu_torch.utils import tracing

from test_torch_world import port_cfg
from test_torch_zero_search import one_thread  # noqa: F401 (an autouse fixture)

B = 3
ZERO_HP = dict(num_mcts_simulations=2, num_channels=8, num_encoder_res_blocks=2,
               num_global_pooling_channels=4, input_history_length=3,
               max_valid_action_distance=11.5)
CMAES_MC = dict(type="cmaes", episode_horizon=2, cma_popsize=4, cma_maxiter=2, cma_sigma=2.0)


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off and empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def world(small_cfg):
    return IPPWorld(port_cfg(small_cfg), device="cpu")


def zero_planner(world, sims=2):
    hp = MCTSZeroHyperParams(**dict(ZERO_HP, num_mcts_simulations=sims))
    net = train.init_network(world.cfg, hp, torch.Generator().manual_seed(0), device="cpu")
    mc = MissionConfig(type="mcts_zero", episode_horizon=3, hyper_params=hp)
    return ZeroPlanner(world, mc, train.predict_fn(net), net.state_dict())


def planner_of(kind, world):
    if kind == "greedy":
        return GreedyPlanner(world, MissionConfig(type="greedy"))
    if kind == "zero":
        return zero_planner(world)
    return CMAESPlanner(world, MissionConfig(**CMAES_MC))


# ------------------------------------------------------------ the tracer


def test_off_records_nothing_with_one_noop_context():
    first, second = tracing.span("plan.run"), tracing.span("plan.sweep")
    assert first is second
    with first:
        with second:
            pass
    assert tracing.snapshot().spans == []


def test_nested_spans_carry_parents_and_requests():
    tracing.enable()
    with tracing.span("outside") as out:
        pass
    with tracing.span("plan.run") as run:
        with tracing.span("plan.sweep") as sweep:
            with tracing.span("plan.commit") as commit:
                pass
        with tracing.span("plan.run") as inner:  # a run inside a run: one request
            pass
    with tracing.span("plan.run") as run2:
        with tracing.span("plan.evaluate") as ev:
            pass
    tracing.disable()
    with tracing.span("plan.run"):
        pass
    spans = tracing.snapshot().spans
    assert [s.name for s in spans] == ["outside", "plan.run", "plan.sweep", "plan.commit",
                                       "plan.run", "plan.run", "plan.evaluate"]
    assert spans == [out, run, sweep, commit, inner, run2, ev]
    assert len({s.id for s in spans}) == len(spans)
    assert out.parent is None and out.request is None
    assert run.parent is None and run.request is not None
    assert sweep.parent == run.id and commit.parent == sweep.id and inner.parent == run.id
    assert sweep.request == commit.request == inner.request == run.request
    assert run2.request not in (None, run.request) and ev.request == run2.request
    assert ev.parent == run2.id
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None  # no card: no events
    assert run.start_ns <= sweep.start_ns <= commit.start_ns <= commit.end_ns <= sweep.end_ns
    assert sweep.end_ns <= inner.start_ns <= inner.end_ns <= run.end_ns


def test_an_open_span_is_left_out_of_a_snapshot():
    tracing.enable()
    with tracing.span("plan.run"):
        with tracing.span("plan.sweep"):
            pass
        names = [s.name for s in tracing.snapshot().spans]
    assert names == ["plan.sweep"]
    assert [s.name for s in tracing.snapshot().spans] == ["plan.run", "plan.sweep"]


def test_counters_count_on_and_off():
    tracing.count("host_syncs")
    tracing.enable()
    tracing.count("host_syncs", 4)
    tracing.count("kernel.spd_inverse", 2)
    assert tracing.snapshot().counters == {"host_syncs": 5, "kernel.spd_inverse": 2}
    assert tracing.counts("kernel.") == {"kernel.spd_inverse": 2}
    tracing.reset(counters="kernel.")
    assert tracing.counts() == {"host_syncs": 5}


def test_suspended_records_no_span_and_leaves_the_counters():
    """Inside ``suspended`` (a CUDA graph's capture) no span is recorded and
    the counters end as they began; what was counted inside is given back."""
    tracing.enable()
    tracing.count("host_syncs", 2)
    with tracing.suspended() as inside:
        with tracing.span("classic.descent"):
            tracing.count("classic.lockstep_steps", 6)
            tracing.count("host_syncs")
    assert inside == {"classic.lockstep_steps": 6, "host_syncs": 1}
    snap = tracing.snapshot()
    assert snap.spans == [] and snap.counters == {"host_syncs": 2}
    with tracing.span("classic.search"):
        pass
    assert [s.name for s in tracing.snapshot().spans] == ["classic.search"]


def test_launch_counts_are_views_of_the_counters():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    tracing.count("kernel.edge_factor_gain", 3)
    tracing.count("kernel.spd_trace_product")
    tracing.count("host_syncs")
    assert kernels.launch_counts() == {"spd_inverse": 0, "spd_inverse_factor": 0,
                                       "spd_trace_product": 1, "edge_factor_gain": 3,
                                       "sweep_tap_blocks": 0}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert tracing.counts() == {"host_syncs": 1}


def test_span_stamps_contain_the_profilers_host_event():
    """The spans' clock is the profiler's: an op run inside a span is
    stamped by the profiler inside the span's host interval."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("probe") as s:
            torch.mm(a, a)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(events) == 1
    start, end = events[0].start_ns(), events[0].start_ns() + events[0].duration_ns()
    assert s.start_ns <= start <= end <= s.end_ns


# ------------------------------------------------------------ the planners


def _assert_same_result(a, b):
    np.testing.assert_array_equal(a.waypoints, b.waypoints)
    np.testing.assert_array_equal(a.budgets, b.budgets)
    np.testing.assert_array_equal(a.num_steps, b.num_steps)
    np.testing.assert_array_equal(a.flight_times, b.flight_times)
    assert a.metrics.keys() == b.metrics.keys()
    for k in a.metrics:
        np.testing.assert_array_equal(a.metrics[k], b.metrics[k])
    for f in dataclasses.fields(a.final_state):
        assert torch.equal(getattr(a.final_state, f.name), getattr(b.final_state, f.name))


@pytest.mark.parametrize("kind, steps, names", [
    ("greedy", 4, {"plan.run", "plan.sweep", "plan.commit", "plan.evaluate", "plan.history"}),
    ("zero", 2, {"plan.run", "zero.replan", "zero.descent", "zero.leaf", "zero.forward",
                 "zero.backup", "plan.commit", "plan.evaluate", "plan.history"}),
    ("cmaes", 2, {"plan.run", "cmaes.replan", "cmaes.init", "plan.sweep", "cmaes.minimize",
                  "cmaes.eigh", "cmaes.fitness", "plan.commit", "plan.evaluate",
                  "plan.history"}),
])
def test_results_are_bitwise_the_same_with_the_tracer_on(world, kind, steps, names):
    planner = planner_of(kind, world)

    def run():
        g = torch.Generator().manual_seed(7)
        return planner.run(B, max_steps=steps, generator=g)

    off = run()
    tracing.enable()
    on = run()
    tracing.disable()
    _assert_same_result(off, on)
    snap = tracing.snapshot()
    assert {s.name for s in snap.spans} == names
    runs = [s for s in snap.spans if s.name == "plan.run"]
    assert len(runs) == 1 and all(s.request == runs[0].request for s in snap.spans)
    assert sum(s.name == "plan.commit" for s in snap.spans) == steps
    assert sum(s.name == "plan.evaluate" for s in snap.spans) == steps + 1


def test_host_syncs_count_the_searchs_reads(world, monkeypatch):
    """``host_syncs`` in a zero replan equals the reads of a device flag
    (``bool`` of a tensor: the descent's ``done.all()`` and the Dirichlet
    draw's ``todo.any()``) that a test double counts."""
    planner = zero_planner(world, sims=3)
    g = torch.Generator().manual_seed(3)
    state = world.init_state(B, g)
    cfg, hp = world.cfg, planner.hp
    hist = push_history(init_history(cfg, hp, B, world.dtype, world.device), state.cov,
                        state.pos, state.budget / float(cfg.constraints.budget))
    reads = {"bool": 0, "steps": 0}
    as_bool = torch.Tensor.__bool__

    def counted_bool(self):
        reads["bool"] += 1
        return as_bool(self)

    step = planner.mcts._descend_step

    def counted_step(*args):
        reads["steps"] += 1
        return step(*args)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
    monkeypatch.setattr(planner.mcts, "_descend_step", counted_step)
    before = tracing.counts()
    planner._replan(state, hist, g, None)
    after = tracing.counts()
    monkeypatch.undo()
    syncs = after["host_syncs"] - before.get("host_syncs", 0)
    assert reads["bool"] > hp.num_mcts_simulations and syncs == reads["bool"]
    assert after["zero.descent_steps"] - before.get("zero.descent_steps", 0) == reads["steps"]
    assert after["zero.forwards"] - before.get("zero.forwards", 0) == hp.num_mcts_simulations
    assert (after["zero.forward_samples"] - before.get("zero.forward_samples", 0)
            == B * hp.num_mcts_simulations)
