"""Device-mesh utilities: the multi-device story, on ``torch.distributed``.

Port of ``ipp_rl_tpu/parallel/mesh.py``.  One process per device (rank),
and the ranks form one (dp, mp) ``DeviceMesh``:

  * axis ``dp`` — mission/data parallelism: a mission batch is split
    over it, each rank running its contiguous slice (``shard_batch``) and
    the slices gathered back where the whole batch is needed
    (``gather_batch``);
  * axis ``mp`` — state parallelism for large grids: the (N, N)
    covariance and its Kalman commit shard over rows
    (parallel/sharded_kalman.py), each rank seeing only its mp subgroup.

The JAX package places arrays with ``NamedSharding`` objects
(``batch_sharding``, ``replicated_sharding``) and lets XLA partition the
program.  torch has no such object: a rank holds plain tensors, so
``shard_batch`` takes this rank's slice and ``gather_batch`` all-gathers
the slices; a replicated tensor is one that every rank holds whole.

The process group comes first (``initialize_multihost``, or the caller's
own ``torch.distributed.init_process_group``): NCCL for the card, gloo
for the CPU, which is used only when asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ipp_rl_tpu_torch.device import resolve_device


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    mp: int = 1,
    device: str | torch.device = "cuda",
) -> DeviceMesh:
    """Build a (dp, mp) mesh, axes named "dp" and "mp", over the first
    ``n_devices`` ranks of the initialised process group (default: all,
    on dp).  Every rank of the group calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(initialize_multihost or torch.distributed.init_process_group)")
    device_type = resolve_device(device).type
    total = dist.get_world_size() if n_devices is None else n_devices
    if not 1 <= total <= dist.get_world_size():
        raise ValueError(f"{total} devices asked for, {dist.get_world_size()} ranks in the group")
    if dp is None:
        if total % mp != 0:
            raise ValueError(f"{total} devices not divisible by mp={mp}")
        dp = total // mp
    if dp * mp != total:
        raise ValueError(f"mesh {dp}x{mp} != {total} devices")
    return DeviceMesh(device_type, torch.arange(total).reshape(dp, mp),
                      mesh_dim_names=("dp", "mp"))


def _tree_map(fn, tree):
    """fn on every tensor of a tree of dataclasses, dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's contiguous slice of the leading (mission) axis of every
    tensor in ``tree`` (a ``BeliefState`` qualifies), by its dp
    coordinate: the counterpart of placing the tree with a dp-sharded
    ``NamedSharding``.  The batch must divide by the dp size."""
    dp, i = mesh["dp"].size(), mesh.get_local_rank("dp")

    def take(x):
        if x.shape[0] % dp:
            raise ValueError(f"batch {x.shape[0]} does not divide over dp={dp}")
        n = x.shape[0] // dp
        return x[i * n:(i + 1) * n].clone()

    return _tree_map(take, tree)


def gather_batch(mesh: DeviceMesh, tree):
    """The inverse of :func:`shard_batch`: every tensor's dp slices
    all-gathered along the leading axis, in dp order, on every rank."""
    group = mesh.get_group("dp")
    dp = mesh["dp"].size()

    def gather(x):
        x = x.contiguous()
        out = torch.empty((dp * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    return _tree_map(gather, tree)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> DeviceMesh:
    """Initialise ``torch.distributed`` and return the global (dp, mp)
    mesh, every rank on dp (``make_mesh()``).

    ``coordinator_address`` is "host:port" of rank 0's store, with
    ``num_processes`` ranks, this one being ``process_id``; without it the
    group is this process alone (world size 1).  The backend follows the
    device: NCCL for "cuda" (rank r on card r mod the card count), gloo
    for "cpu".
    Multi-host usage (the same invocation on every host):

        mesh = initialize_multihost("10.0.0.1:1234", num_processes=4,
                                    process_id=int(os.environ["TASK_ID"]))
    """
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = process_id or 0
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if not dist.is_initialized():
        if coordinator_address is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=rank)
    return make_mesh(device=dev)
