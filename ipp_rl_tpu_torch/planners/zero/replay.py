"""Replay buffers over self-play trajectories.

Port of ``ipp_rl_tpu/planners/zero/replay.py``.  Each self-play iteration
contributes one ``Trajectory``, kept as host numpy and as the device copy
self-play produced; the buffer holds a sliding window of iterations and
samples (iteration, env, step) rows.  Feature planes are not stored: they
are rebuilt from the belief history when a batch is gathered
(``planes_from_sample``).

Uniform and prioritized (α-exponent priorities, β-annealed importance
weights, priorities updated from the per-sample value loss — reference
planning/mcts_zero/replay_buffers.py:104-141) variants, and the
reference's random-shift augmentation (replication pad 4 + random crop,
reference :58-75).

The fused paths keep the whole window on the card (``DeviceWindow``) and
run gather → planes → train step for a chunk of steps with no read back
to the host inside the chunk: the rows and LRs of the chunk are computed
on the host first, and the metrics are stacked on the device.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ipp_rl_tpu_torch.config.schema import MCTSZeroHyperParams
from ipp_rl_tpu_torch.env.world import IPPWorld
from ipp_rl_tpu_torch.planners.zero.selfplay import Trajectory, gumbel, planes_from_sample
from ipp_rl_tpu_torch.planners.zero.train import TrainBatch


class DeviceWindow(NamedTuple):
    """The replay window stacked on the card: (K slots, E envs, T steps, ...).
    Slots beyond the live window are zero-filled, so every window has
    K = max_train_examples_history slots."""

    cov: torch.Tensor  # (K, E, T, N, N)
    mean: torch.Tensor  # (K, E, T, N)
    prev_pos: torch.Tensor  # (K, E, T, 3)
    budget: torch.Tensor  # (K, E, T)
    policy: torch.Tensor  # (K, E, T, A)
    valid_mask: torch.Tensor  # (K, E, T, A)
    reward: torch.Tensor  # (K, E, T)
    value: torch.Tensor  # (K, E, T)


def _stack_metrics(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


class ReplayBuffer:
    """Sliding-window uniform replay over trajectory iterations."""

    def __init__(self, world: IPPWorld, hp: MCTSZeroHyperParams, window_size: int):
        self.world = world
        self.hp = hp
        self.window_size = window_size
        self._iters: Dict[int, Trajectory] = {}  # host numpy
        self._dev_iters: Dict[int, Trajectory] = {}  # device copies
        self._index: Optional[np.ndarray] = None  # (num_samples, 3) iter, e, t

    def add_iteration(self, iteration: int, traj: Trajectory,
                      device_traj: Optional[Trajectory] = None):
        """Register a finished self-play iteration (host numpy) and drop
        iterations outside the window (reference mcts_zero_mission.py:364-368).
        ``device_traj`` keeps self-play's device copy, so the fused epoch
        runner does not upload it again."""
        self._iters[iteration] = traj.map(np.asarray)
        if device_traj is not None:
            self._dev_iters[iteration] = device_traj
        self.set_window(iteration, self.window_size)

    def set_window(self, current_iteration: int, window_size: int):
        self.window_size = window_size
        start = max(0, current_iteration - window_size + 1)
        for store in (self._iters, self._dev_iters):
            for k in [k for k in store if k < start]:
                del store[k]
        self._rebuild_index()

    def _rebuild_index(self):
        rows = []
        for it, traj in sorted(self._iters.items()):
            e_idx, t_idx = np.nonzero(traj.sample_ok)
            rows.append(np.stack([np.full_like(e_idx, it), e_idx, t_idx], axis=1))
        self._index = np.concatenate(rows, axis=0) if rows else np.zeros((0, 3), np.int64)

    def __len__(self) -> int:
        return 0 if self._index is None else len(self._index)

    def num_batches(self, batch_size: int) -> int:
        return len(self) // self.draw(batch_size)

    def draw(self, batch_size: int) -> int:
        """Rows drawn per batch before augmentation."""
        return max(1, batch_size // (self.hp.num_augmented_samples + 1))

    # ----------------------------------------------------------- sampling

    def _device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.world.device)

    def _gather(self, rows: np.ndarray) -> TrainBatch:
        """A TrainBatch for index rows (iter, env, step), gathered on the
        host: the L-step history of sample (e, t) is rows t, t−1, …, t−L+1
        of its trajectory (zero where t − k < 0); float32, as the JAX
        package's host gather."""
        world, hp = self.world, self.hp
        L = hp.input_history_length
        n = world.cfg.environment.num_cells
        B = len(rows)
        budget0 = np.float32(world.cfg.constraints.budget)
        covs = np.zeros((B, L, n, n), np.float32)
        poss = np.zeros((B, L, 3), np.float32)
        bfrs = np.zeros((B, L), np.float32)
        lens = np.zeros((B,), np.int32)
        means = np.zeros((B, n), np.float32)
        pols = np.zeros((B, world.num_actions), np.float32)
        vals = np.zeros((B,), np.float32)
        rews = np.zeros((B,), np.float32)
        msks = np.zeros((B, world.num_actions), np.float32)
        ks = np.arange(L)
        for it in np.unique(rows[:, 0]):
            sel = np.nonzero(rows[:, 0] == it)[0]
            e, t = rows[sel, 1], rows[sel, 2]
            traj = self._iters[int(it)]
            tk = t[:, None] - ks[None, :]  # (b, L) history step indices
            valid = tk >= 0
            tkc = np.maximum(tk, 0)
            eL = e[:, None]
            covs[sel] = traj.cov[eL, tkc] * valid[:, :, None, None]
            poss[sel] = traj.prev_pos[eL, tkc] * valid[:, :, None]
            bfrs[sel] = traj.budget[eL, tkc] / budget0 * valid
            lens[sel] = np.minimum(L, t + 1)
            means[sel] = traj.mean[e, t]
            pols[sel] = traj.policy[e, t]
            vals[sel] = traj.value[e, t]
            rews[sel] = traj.reward[e, t]
            msks[sel] = traj.valid_mask[e, t]
        dev = self._device
        planes = planes_from_sample(world, hp, dev(covs), dev(poss), dev(bfrs), dev(lens),
                                    dev(means))
        return TrainBatch(planes=planes, policy=dev(pols), value=dev(vals), reward=dev(rews),
                          valid_mask=dev(msks),
                          weight=torch.ones((B,), dtype=torch.float32, device=planes.device))

    def device_window(self, max_slots: int) -> Tuple[DeviceWindow, Dict[int, int]]:
        """Stack the live window on the card, zero-padded to ``max_slots``;
        returns (window, {iteration: slot}).  An iteration without a device
        copy (after a resume from disk) is uploaded once."""
        its = sorted(self._iters)
        if len(its) > max_slots:
            raise ValueError(f"window of {len(its)} iterations > {max_slots} slots")
        devs = []
        for it in its:
            if it not in self._dev_iters:
                self._dev_iters[it] = self._iters[it].map(self._device)
            devs.append(self._dev_iters[it])
        fields = {}
        for name in DeviceWindow._fields:
            parts = [getattr(d, name) for d in devs]
            parts += [torch.zeros_like(parts[0])] * (max_slots - len(parts))
            fields[name] = torch.stack(parts, dim=0)
        return DeviceWindow(**fields), {it: k for k, it in enumerate(its)}

    def epoch_rows(self, num_steps: int, batch_size: int, rng: np.random.Generator,
                   slot_map: Dict[int, int]) -> np.ndarray:
        """Uniform-with-replacement samples for ``num_steps`` minibatches as
        (num_steps, draw, 3) int32 (slot, env, step) rows."""
        if len(self) == 0:
            raise ValueError("empty replay buffer")
        idx = rng.integers(0, len(self), size=(num_steps, self.draw(batch_size)))
        rows = self._index[idx]  # (num_steps, draw, 3) — (iter, e, t)
        slots = np.vectorize(slot_map.__getitem__)(rows[..., 0])
        return np.stack([slots, rows[..., 1], rows[..., 2]], axis=-1).astype(np.int32)

    def _gather_device(self, win: DeviceWindow, rows: torch.Tensor) -> TrainBatch:
        """``_gather`` against a DeviceWindow, on the card, for (B, 3) rows
        (slot, env, step), in the window's dtype."""
        hp = self.hp
        L = hp.input_history_length
        dt = win.cov.dtype
        rows = rows.long()
        k, e, t = rows[:, 0], rows[:, 1], rows[:, 2]
        ks = torch.arange(L, device=rows.device)
        tk = t[:, None] - ks[None, :]  # (B, L)
        valid = (tk >= 0).to(dt)
        tkc = torch.clamp(tk, min=0)
        kL, eL = k[:, None], e[:, None]
        budget0 = float(self.world.cfg.constraints.budget)
        planes = planes_from_sample(
            self.world, hp,
            win.cov[kL, eL, tkc] * valid[:, :, None, None],
            win.prev_pos[kL, eL, tkc] * valid[:, :, None],
            win.budget[kL, eL, tkc] / budget0 * valid,
            torch.clamp(t + 1, max=L),
            win.mean[k, e, t],
        )
        return TrainBatch(planes=planes, policy=win.policy[k, e, t], value=win.value[k, e, t],
                          reward=win.reward[k, e, t], valid_mask=win.valid_mask[k, e, t],
                          weight=torch.ones((rows.shape[0],), dtype=dt, device=rows.device))

    def _augment(self, batch: TrainBatch, generator: Optional[torch.Generator] = None,
                 shifts: Optional[torch.Tensor] = None) -> TrainBatch:
        """Random-shift augmentation: replication-pad 4 + random crop
        (reference replay_buffers.py:58-75) as k extra copies, targets
        tiled.  The crop at shift (i, j) of the padded planes reads row
        clamp(r + i − 4) and column clamp(c + j − 4) of the planes.
        ``shifts`` (k, B, 2) in 0..8 are drawn from ``generator`` unless
        given."""
        k = self.hp.num_augmented_samples
        if k == 0:
            return batch
        planes = batch.planes
        B, H, W, _ = planes.shape
        dev = planes.device
        if shifts is None:
            shifts = torch.randint(0, 9, (k, B, 2), generator=generator, device=dev)
        shifts = shifts.to(device=dev, dtype=torch.long)
        b = torch.arange(B, device=dev)[:, None, None]
        rr = torch.arange(H, device=dev)[None, :] - 4
        cc = torch.arange(W, device=dev)[None, :] - 4
        aug = [planes]
        for j in range(k):
            rows = torch.clamp(rr + shifts[j, :, 0:1], 0, H - 1)  # (B, H)
            cols = torch.clamp(cc + shifts[j, :, 1:2], 0, W - 1)  # (B, W)
            aug.append(planes[b, rows[:, :, None], cols[:, None, :]])

        def tile(x):
            return torch.cat([x] * (k + 1), dim=0)

        return TrainBatch(planes=torch.cat(aug, dim=0), policy=tile(batch.policy),
                          value=tile(batch.value), reward=tile(batch.reward),
                          valid_mask=tile(batch.valid_mask), weight=tile(batch.weight))

    def make_epoch_runner(self, train_step):
        """Returns ``run(state, win, rows, lrs, generator) -> (state,
        metrics)`` over ``rows.shape[0]`` minibatches: rows (steps, draw, 3)
        and lrs (steps,) come from the host; metrics are stacked per step on
        the card (the caller reads the last)."""

        def run(state, win: DeviceWindow, rows, lrs, generator=None):
            rows = torch.as_tensor(rows, device=win.cov.device)
            metrics = []
            for s in range(rows.shape[0]):
                batch = self._augment(self._gather_device(win, rows[s]), generator)
                state, m, _ = train_step(state, batch, generator, float(lrs[s]))
                metrics.append(m)
            return state, _stack_metrics(metrics)

        return run

    def sample(self, batch_size: int, rng: np.random.Generator,
               generator: Optional[torch.Generator] = None) -> Tuple[TrainBatch, np.ndarray]:
        """Uniform sample with replacement (reference :90-101)."""
        if len(self) == 0:
            raise ValueError("empty replay buffer")
        idx = rng.integers(0, len(self), size=self.draw(batch_size))
        return self._augment(self._gather(self._index[idx]), generator), idx

    def step(self):
        pass

    def update(self, indices: np.ndarray, priorities: np.ndarray):
        pass


def per_sample_rows(
    priorities: torch.Tensor,
    flat_valid: torch.Tensor,
    alpha: float,
    beta: float,
    n_valid: torch.Tensor,
    draw: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
):
    """PER draw: ``draw`` rows with replacement from softmax(α·log p) over
    the valid slots — the distribution of the host ``rng.choice(n,
    p=p^α/Σp^α)`` — by Gumbel-max (``noise`` (draw, K·E·T) Gumbel draws,
    else from ``generator``), plus the β-annealed, max-normalised importance
    weights (prob·n)^(−β) (reference replay_buffers.py:129-137).  Returns
    (flat indices (draw,), (draw, 3) (slot, env, step) rows, weights)."""
    K, E, T = priorities.shape
    logits = torch.where(flat_valid, alpha * torch.log(priorities.reshape(-1)), float("-inf"))
    if noise is None:
        noise = gumbel((draw, logits.shape[0]), generator, logits.dtype, logits.device)
    flat_idx = torch.argmax(logits[None, :] + noise.to(logits.dtype), dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    w = torch.exp(-beta * (logp[flat_idx] + torch.log(n_valid)))
    w = w / torch.max(w)
    rows = torch.stack([flat_idx // (E * T), (flat_idx // T) % E, flat_idx % T], dim=-1)
    return flat_idx, rows, w


def scatter_last(flat: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``flat`` with ``flat[idx[i]] = values[i]``, the last i winning where
    ``idx`` repeats (numpy's fancy assignment and XLA's serial scatter on
    the CPU).  A CUDA scatter with repeated indices writes in no fixed
    order, so the last occurrence of each index is found first (the
    largest position per index, a max: order-free) and the values are
    then gathered, not scattered."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full(flat.shape, -1, dtype=torch.long, device=flat.device)
    last = last.scatter_reduce(0, idx, pos, reduce="amax")
    return torch.where(last >= 0, values[torch.clamp(last, min=0)].to(flat.dtype), flat)


class PrioritizedReplayBuffer(ReplayBuffer):
    """α-priority sampling with β-annealed importance weights (reference
    replay_buffers.py:104-141)."""

    def __init__(self, world: IPPWorld, hp: MCTSZeroHyperParams, window_size: int):
        self._priorities: Optional[np.ndarray] = None
        super().__init__(world, hp, window_size)
        self.alpha = hp.replay_alpha
        self.beta0 = hp.replay_beta0
        self.beta = hp.replay_beta0
        self.total_steps = 1

    def _rebuild_index(self):
        super()._rebuild_index()
        n = len(self)
        self._priorities = np.ones(n) / n if n else None

    def begin_training(self, batch_size: int, num_epochs: int):
        self.total_steps = max(1, self.num_batches(batch_size) * num_epochs)
        self.beta = self.beta0

    def step(self):
        self.beta = min(self.beta + (1.0 - self.beta0) / self.total_steps, 1.0)

    def sample(self, batch_size: int, rng: np.random.Generator,
               generator: Optional[torch.Generator] = None) -> Tuple[TrainBatch, np.ndarray]:
        if len(self) == 0:
            raise ValueError("empty replay buffer")
        probs = self._priorities ** self.alpha
        probs = probs / probs.sum()
        idx = rng.choice(len(self), size=self.draw(batch_size), p=probs)
        batch = self._gather(self._index[idx])
        weights = (probs[idx] * len(self)) ** (-self.beta)
        weights = weights / weights.max()
        batch = batch._replace(weight=self._device(weights.astype(np.float32)))
        return self._augment(batch, generator), idx

    def update(self, indices: np.ndarray, priorities: np.ndarray):
        self._priorities[indices] = np.asarray(priorities)

    # ------------------------------------------------- fused PER path

    def device_valid(self, max_slots: int) -> torch.Tensor:
        """(K, E, T) bool sample-validity mask aligned with device_window."""
        parts = [self._device(self._iters[it].sample_ok) for it in sorted(self._iters)]
        parts += [torch.zeros_like(parts[0])] * (max_slots - len(parts))
        return torch.stack(parts, dim=0).bool()

    def init_device_priorities(self, valid: torch.Tensor) -> torch.Tensor:
        """Uniform 1/n over the valid slots (the host buffer's start), float32."""
        n = torch.clamp(valid.sum(), min=1).to(torch.float32)
        return torch.where(valid, 1.0 / n, 0.0).to(torch.float32)

    def make_per_epoch_runner(self, train_step, draw: int):
        """Returns ``run(state, priorities, win, valid, lrs, betas,
        generator) -> (state, priorities, metrics)`` over ``lrs.shape[0]``
        minibatches, sampling from and updating the priorities on the card;
        ``draw`` rows per step before augmentation."""
        alpha = self.alpha

        def run(state, priorities, win: DeviceWindow, valid, lrs, betas, generator=None):
            shape = priorities.shape
            n_valid = valid.sum().to(torch.float32)
            flat_valid = valid.reshape(-1)
            metrics = []
            for s in range(len(lrs)):
                flat_idx, rows, w = per_sample_rows(priorities, flat_valid, alpha,
                                                    float(betas[s]), n_valid, draw, generator)
                batch = self._gather_device(win, rows)
                batch = self._augment(batch._replace(weight=w.to(batch.weight.dtype)), generator)
                state, m, value_l = train_step(state, batch, generator, float(lrs[s]))
                priorities = scatter_last(priorities.reshape(-1), flat_idx,
                                          value_l[:draw].to(priorities.dtype) + 1e-8).reshape(shape)
                metrics.append(m)
            return state, priorities, _stack_metrics(metrics)

        return run
