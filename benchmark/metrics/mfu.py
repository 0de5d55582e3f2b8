"""mfu: the whole replan step's share of the card's float32 peak: the
network's FLOPs over every forward in the traced window (multiply-adds
× 2 of its convolutions and dense layers, counted from their output
shapes by the frozen ``network_flops`` on one sample, times the samples
each forward took) over (the traced window × 67 TFLOP/s, the float32
peak outside the tensor cores, which the configuration's float32 with
TF32 off allows).  The descent, the leaf planes and the host's gaps
count in the window and do no network work."""

import torch

from benchmark.yardsticks import PEAK_F32_OPS_PER_S, network_flops


def prepare(run, runner):
    from ipp_rl_tpu_torch.models.networks import plane_channels

    n = runner.world.cfg.environment.num_cells
    planes = torch.zeros((1, n, n, plane_channels(runner.hp)), device=run.device)
    mask = torch.ones((1, runner.world.num_actions), device=run.device)
    per_sample = network_flops(runner.net, planes, mask)
    mcts = runner.planner.mcts
    predict = mcts.predict
    samples = run.values.setdefault("mfu_samples", [0])

    def counted(variables, planes, mask):
        if run.tracing:
            samples[0] += planes.shape[0]
        return predict(variables, planes, mask)

    counted.__dict__.update(getattr(predict, "__dict__", {}))
    mcts.predict = counted
    run.values["mfu_flops_per_sample"] = per_sample


def read(run, runner):
    t = run.trace_summary
    samples = run.values.get("mfu_samples", [0])[0]
    if t is None or not samples:
        return None
    flops = run.values["mfu_flops_per_sample"] * samples
    return 100.0 * flops / (t["window_s"] * PEAK_F32_OPS_PER_S)
