"""Training and inference of the policy-value network.

Port of ``ipp_rl_tpu/planners/zero/train.py``, which reproduces the
reference optimisation recipe (reference
planning/mcts_zero/network_wrappers/policy_value_network_wrappers.py:34-215):

  * SGD + momentum + coupled weight decay (``torch.optim.SGD``, one
    parameter group, the LR set per step);
  * three-phase linear OneCycle LR (``onecycle_lr``, host float math);
  * global-norm gradient clipping with optax's rule: scale by
    max_norm / norm only when norm ≥ max_norm, no epsilon (torch's
    ``clip_grad_norm_`` divides by norm + 1e-6, so it is not used);
  * losses: masked policy cross-entropy, value MSE on √-scaled targets,
    optional reward MSE and reconstruction, entropy subtracted, per-sample
    PER importance weights.

A train state owns its network and optimiser, and a train step updates
them in place (the forward in training mode also moves the BatchNorm
running statistics), returning the state with its metrics as device
tensors: nothing is read back to the host inside a step.

A predict function has the JAX package's interface,
``predict(variables, planes, valid_mask) -> (policy, value)``: the
weights are passed in as a ``state_dict`` (``torch.func.functional_call``,
the counterpart of ``net.apply``), so a caller can swap or cast weights
without rebuilding the module.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from ipp_rl_tpu_torch.config.schema import Config, MCTSZeroHyperParams
from ipp_rl_tpu_torch.device import resolve_device
from ipp_rl_tpu_torch.models.networks import PolicyNetwork, PolicyValueNetwork, ValueNetwork
from ipp_rl_tpu_torch.ops.rewards import invert_scaled_value_target

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled by this factor to keep the variance 1 / fan_in
_TRUNCATED_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def flax_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``net``'s weights as flax initialises its modules: kernels
    lecun-normal, biases 0, BatchNorm scale 1, bias 0, mean 0, var 1."""
    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = module.weight
            if isinstance(module, nn.ConvTranspose2d):  # (in, out, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:  # (out, in, ...)
                fan_in = w[0].numel()
            _lecun_normal_(w, fan_in, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return net


def init_network(
    cfg: Config,
    hp: MCTSZeroHyperParams,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> PolicyValueNetwork:
    """A ``PolicyValueNetwork`` on ``device`` in inference mode, its weights
    drawn from ``generator`` (a generator on that device) as flax draws
    them."""
    dev = resolve_device(device)
    net = PolicyValueNetwork(hp, cfg.num_actions).to(device=dev, dtype=dtype).eval()
    return flax_init_(net, generator)


def cast_variables(variables, dtype: torch.dtype):
    """Floating tensors of a (nested) state dict cast to ``dtype``."""
    if isinstance(variables, dict):
        return {k: cast_variables(v, dtype) for k, v in variables.items()}
    return variables.to(dtype) if variables.is_floating_point() else variables


def _compute_variables(variables: Dict[str, torch.Tensor], dtype: torch.dtype):
    """The weights in the computation's dtype.  flax promotes float32
    weights to the planes' dtype (float64 in the tests); torch does not,
    so the weights are cast where they differ."""
    if all(not v.is_floating_point() or v.dtype == dtype for v in variables.values()):
        return variables
    return cast_variables(variables, dtype)


def _outputs(log_policy: torch.Tensor, value: torch.Tensor):
    # the value head emits √-scaled values; outputs come back as float32
    return torch.exp(log_policy.float()), invert_scaled_value_target(value.float())


def predict_fn(net: PolicyValueNetwork, dtype: Optional[torch.dtype] = None):
    """Inference: (variables, planes (B, S, S, C), mask (B, A)) → (policy
    probabilities (B, A), value (B,)), both float32, the value on its true
    scale (v² + 2v; reference wrappers :217-231).

    ``dtype=torch.bfloat16`` runs the forward in bf16.  The function
    carries ``infer_dtype`` so the search casts its weights once before the
    simulation loop (the cast here is then an identity) and builds the
    leaf planes at that width."""

    def predict(variables, planes, valid_mask):
        dt = dtype or planes.dtype
        planes = planes.to(dt)
        with torch.no_grad():
            log_policy, value, _, _ = functional_call(
                net, _compute_variables(variables, dt), (planes, valid_mask)
            )
        return _outputs(log_policy, value)

    predict.infer_dtype = dtype
    return predict


def split_predict_fn(nets: Tuple[PolicyNetwork, ValueNetwork], dtype: Optional[torch.dtype] = None):
    """:func:`predict_fn` over the split networks, with
    ``variables = {"policy": ..., "value": ...}``."""
    p_net, v_net = nets

    def predict(variables, planes, valid_mask):
        dt = dtype or planes.dtype
        planes = planes.to(dt)
        with torch.no_grad():
            log_policy = functional_call(
                p_net, _compute_variables(variables["policy"], dt), (planes, valid_mask)
            )
            value, _ = functional_call(v_net, _compute_variables(variables["value"], dt), (planes,))
        return _outputs(log_policy, value)

    predict.infer_dtype = dtype
    return predict


def inference_dtype(hp: MCTSZeroHyperParams) -> Optional[torch.dtype]:
    """hp.inference_dtype as the dtype for :func:`predict_fn` (None = the
    planes' own)."""
    return torch.bfloat16 if hp.inference_dtype == "bfloat16" else None


# ------------------------------------------------------------ training


class TrainBatch(NamedTuple):
    """One replay minibatch; leading axis B."""

    planes: torch.Tensor  # (B, S, S, C)
    policy: torch.Tensor  # (B, A) — visit-count target
    value: torch.Tensor  # (B,) — √-scaled n-step return
    reward: torch.Tensor  # (B,)
    valid_mask: torch.Tensor  # (B, A)
    weight: torch.Tensor  # (B,) — PER importance weights (1.0 if uniform)


@dataclasses.dataclass
class ZeroTrainState:
    """A network, its optimiser and the count of steps taken (a host int)."""

    net: nn.Module
    optimizer: torch.optim.SGD
    step: int = 0

    def variables(self) -> Dict[str, torch.Tensor]:
        """The weights as a ``state_dict`` (the predict functions' and the
        checkpoints' currency); the tensors share the network's storage."""
        return self.net.state_dict()


class SplitTrainState(NamedTuple):
    policy: ZeroTrainState
    value: ZeroTrainState

    def variables(self):
        return {"policy": self.policy.variables(), "value": self.value.variables()}


TrainState = Union[ZeroTrainState, SplitTrainState]


def onecycle_lr(hp: MCTSZeroHyperParams, step: int, total_steps: int) -> float:
    """LR at ``step`` of a torch-exact three-phase linear OneCycle
    (``torch.optim.lr_scheduler.OneCycleLR(max_lr, total_steps,
    div_factor=max_lr/lr, final_div_factor=100, anneal_strategy="linear",
    three_phase=True, pct_start=0.40)``), which the reference builds afresh
    every self-play iteration.  Phase ends at torch's ``pct·total − 1``,
    ``2·pct·total − 2`` and ``total − 1``."""
    initial_lr = hp.learning_rate  # max_lr / div_factor
    max_lr = hp.max_learning_rate
    min_lr = initial_lr / 100.0  # final_div_factor
    pct = 0.40
    total = max(total_steps, 1)
    p1_end = pct * total - 1.0
    p2_end = 2.0 * pct * total - 2.0
    p3_end = total - 1.0
    s = float(step)

    def lerp(a, b, frac):
        return a + (b - a) * frac

    if s <= p1_end:
        return lerp(initial_lr, max_lr, s / max(p1_end, 1e-12))
    if s <= p2_end:
        return lerp(max_lr, initial_lr, (s - p1_end) / max(p2_end - p1_end, 1e-12))
    return lerp(initial_lr, min_lr, (s - p2_end) / max(p3_end - p2_end, 1e-12))


def make_optimizer(hp: MCTSZeroHyperParams, net: nn.Module) -> torch.optim.SGD:
    """SGD with momentum and coupled weight decay on every parameter
    (BatchNorm scales and biases included), no dampening: per step
    g + wd·p, then buf = m·buf + g, then p − lr·buf — optax's
    ``add_decayed_weights`` then ``trace``.  The LR is set by each step."""
    return torch.optim.SGD(net.parameters(), lr=hp.learning_rate, momentum=hp.momentum,
                           weight_decay=hp.weight_decay, dampening=0.0)


def init_train_state(
    cfg: Config,
    hp: MCTSZeroHyperParams,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Tuple[PolicyValueNetwork, ZeroTrainState]:
    """A seeded network (``init_network``) and a fresh optimiser."""
    net = init_network(cfg, hp, generator, device, dtype)
    return net, ZeroTrainState(net, make_optimizer(hp, net))


def init_split_train_state(
    cfg: Config,
    hp: MCTSZeroHyperParams,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> Tuple[Tuple[PolicyNetwork, ValueNetwork], SplitTrainState]:
    """The split policy and value networks (drawn in that order from
    ``generator``) with an optimiser each."""
    dev = resolve_device(device)
    p_net = flax_init_(PolicyNetwork(hp, cfg.num_actions).to(device=dev, dtype=dtype).eval(),
                       generator)
    v_net = flax_init_(ValueNetwork(hp).to(device=dev, dtype=dtype).eval(), generator)
    state = SplitTrainState(ZeroTrainState(p_net, make_optimizer(hp, p_net)),
                            ZeroTrainState(v_net, make_optimizer(hp, v_net)))
    return (p_net, v_net), state


def reset_optimizer(hp: MCTSZeroHyperParams, state: TrainState) -> TrainState:
    """A fresh SGD (zero momentum, step 0) over the same network — the
    reference builds a new ``torch.optim.SGD`` every ``train()`` call, so
    momentum does not carry across self-play iterations."""
    if isinstance(state, SplitTrainState):
        return SplitTrainState(reset_optimizer(hp, state.policy),
                               reset_optimizer(hp, state.value))
    return ZeroTrainState(state.net, make_optimizer(hp, state.net))


def global_norm(tensors) -> torch.Tensor:
    """√(Σ‖t‖²) over ``tensors``, on the device (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def _sgd_step(hp: MCTSZeroHyperParams, state: ZeroTrainState, lr: float) -> torch.Tensor:
    """Clip the gradients by their global norm as optax does, then one SGD
    step at ``lr``; returns the norm before the clip."""
    grads = [p.grad for p in state.net.parameters()]
    norm = global_norm(grads)
    max_norm = hp.max_grad_norm
    keep = norm < max_norm
    with torch.no_grad():
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    state.optimizer.param_groups[0]["lr"] = float(lr)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return norm.detach()


def loss_fn(net: PolicyValueNetwork, hp: MCTSZeroHyperParams, batch: TrainBatch,
            generator: Optional[torch.Generator]):
    """(loss, metrics, per-sample value losses) of ``net`` in training mode
    on ``batch`` (reference wrappers :120-154, 251-272)."""
    log_policy, value, reward, recon = net(batch.planes, batch.valid_mask, train=True,
                                           generator=generator)
    policy_l = -torch.sum(batch.policy * log_policy * batch.valid_mask, dim=-1)
    value_l = torch.square(value - batch.value)
    entropy = -torch.sum(torch.exp(log_policy) * log_policy, dim=-1)
    total = (hp.policy_loss_coeff * policy_l + hp.value_loss_coeff * value_l
             - hp.entropy_regularization_coeff * entropy)
    metrics = {"policy_loss": policy_l.mean(), "value_loss": value_l.mean(),
               "entropy": entropy.mean()}
    if hp.use_reward_target:
        reward_l = torch.square(reward - batch.reward)
        total = total + hp.reward_loss_coeff * reward_l
        metrics["reward_loss"] = reward_l.mean()
    if hp.use_autoencoder:
        target = batch.planes[..., 0]  # the most recent state plane
        recon_l = torch.mean(torch.square(target - recon).reshape(target.shape[0], -1), dim=-1)
        total = total + hp.reconstruction_loss_coeff * recon_l
        metrics["reconstruction_loss"] = recon_l.mean()
    loss = torch.mean(total * batch.weight)  # PER importance weights (reference :149)
    metrics["total_loss"] = loss
    return loss, metrics, value_l


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(hp: MCTSZeroHyperParams):
    """Returns ``step(state, batch, generator, lr) -> (state, metrics,
    value_l)``: one SGD step of the state's network in place.  ``lr`` is a
    host float (``onecycle_lr``), so one function serves every iteration's
    schedule; dropout draws from ``generator``.  ``metrics`` (device
    scalars) hold the losses and ``grad_norm``, the norm before the clip;
    ``value_l`` (B,) the per-sample value losses for PER."""

    def train_step(state: ZeroTrainState, batch: TrainBatch,
                   generator: Optional[torch.Generator], lr: float):
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics, value_l = loss_fn(state.net, hp, batch, generator)
        loss.backward()
        metrics["grad_norm"] = _sgd_step(hp, state, lr)
        return state, _detached(metrics), value_l.detach()

    return train_step


def cudnn_deterministic(step):
    """``step`` run under cuDNN's deterministic algorithms, without its
    autotuning (``torch.backends.cudnn.deterministic = True``,
    ``benchmark = False``), the caller's settings restored after each
    call.  cuDNN's default weight-gradient algorithms for the convolutions
    accumulate in an order that varies from run to run, so without this two
    train steps from the same weights and batch differ in the last bits
    (``python3 -m ipp_rl_tpu_torch.tools.probe_determinism``); the forward
    and the search are repeatable either way."""

    @functools.wraps(step)
    def wrapped(*args, **kw):
        cudnn = torch.backends.cudnn
        saved = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            return step(*args, **kw)
        finally:
            cudnn.deterministic, cudnn.benchmark = saved

    return wrapped


def make_split_train_step(hp: MCTSZeroHyperParams):
    """``make_train_step`` over the split networks: the policy network on
    CE − entropy, the value network on the value (+ reward) MSE, each
    weighted and averaged, one SGD step each.  ``grad_norm`` is the sum of
    the two norms, ``total_loss`` the sum of the two losses."""

    def train_step(state: SplitTrainState, batch: TrainBatch,
                   generator: Optional[torch.Generator], lr: float):
        p_state, v_state = state
        for st in state:
            st.optimizer.zero_grad(set_to_none=True)
        log_policy = p_state.net(batch.planes, batch.valid_mask, train=True, generator=generator)
        pl = -torch.sum(batch.policy * log_policy * batch.valid_mask, dim=-1)
        ent = -torch.sum(torch.exp(log_policy) * log_policy, dim=-1)
        p_loss = torch.mean((pl - hp.entropy_regularization_coeff * ent) * batch.weight)
        p_loss.backward()
        p_norm = _sgd_step(hp, p_state, lr)

        value, reward = v_state.net(batch.planes, train=True, generator=generator)
        value_l = torch.square(value - batch.value)
        total = hp.value_loss_coeff * value_l
        if hp.use_reward_target:
            total = total + hp.reward_loss_coeff * torch.square(reward - batch.reward)
        v_loss = torch.mean(total * batch.weight)
        v_loss.backward()
        v_norm = _sgd_step(hp, v_state, lr)
        metrics = {"policy_loss": pl.mean(), "entropy": ent.mean(),
                   "value_loss": value_l.mean(), "total_loss": p_loss + v_loss,
                   "grad_norm": p_norm + v_norm}
        return state, _detached(metrics), value_l.detach()

    return train_step
