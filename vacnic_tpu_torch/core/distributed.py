"""Multi-process initialisation (port of vacnic_tpu/core/distributed.py).

The reference's bootstrap is `dist.init_process_group("nccl")` driven by
torchrun's LOCAL_RANK (train...match.py:616-629); JAX's is
`jax.distributed.initialize()`. Here it is torch.distributed itself: one
process a card, NCCL between cards, gloo between CPU processes (the tests'
4-process groups). The data-parallel training step
(`train/train_step.make_train_step(group=)`) takes its rank's rows of the
global batch with `local_batch_slice`; `grid_groups` cuts the world into
the data and model groups of a dp x tp grid (`make_train_step(group=,
model_group=)`, core/tensor_parallel).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from vacnic_tpu_torch.core.device import resolve_device


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None, *,
               device=None, timeout: datetime.timedelta | None = None) -> None:
    """Join the process group, from the explicit arguments or torchrun's
    environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).

    `coordinator_address` is "host:port" or an init-method URL
    ("tcp://...", "file://..."). The backend is `backend`, else nccl on the
    card and gloo for device="cpu"; on the card the process binds its local
    rank's card (LOCAL_RANK, else the rank modulo the cards). Returns
    without a group in a single-process environment (no address given or
    found), and raises there if more than one process was asked for: never
    a silent fall back to training without cross-process gradients. A group
    already initialised is kept."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"initialize: {num_processes} processes asked for, but no "
                             "coordinator address was given or found in MASTER_ADDR")
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator address needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=url, world_size=num_processes, rank=process_id,
                            **kwargs)


def process_count(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0, or the
    only process)."""
    return process_index() == 0


def local_batch_slice(global_batch: int, group=None) -> slice:
    """This process's rows of the global batch (DistributedSampler's
    equivalent, train...match.py:775): equal contiguous shares."""
    per = global_batch // process_count(group)
    start = per * process_index(group)
    return slice(start, start + per)


def grid_groups(data_parallel: int, model_parallel: int, *,
                timeout: datetime.timedelta | None = None):
    """(data_group, model_group) of this process in a data_parallel x
    model_parallel grid over the world, in JAX's mesh order
    (`np.asarray(devices).reshape(dp, mp)`, vacnic_tpu/core/mesh.py:36):
    rank = d * model_parallel + m; the data group holds the ranks of one m,
    the model group those of one d. Every rank creates every group, in the
    same order (torch.distributed's rule: a rank that skips one hangs the
    others), each with the collectives' `timeout`."""
    world = dist.get_world_size()
    if data_parallel * model_parallel != world:
        raise ValueError(f"grid {data_parallel}x{model_parallel} does not cover {world} ranks")
    rank = dist.get_rank()
    kwargs = {} if timeout is None else {"timeout": timeout}
    mine = []
    for rows in ([[d * model_parallel + m for d in range(data_parallel)]
                  for m in range(model_parallel)],
                 [[d * model_parallel + m for m in range(model_parallel)]
                  for d in range(data_parallel)]):
        for ranks in rows:
            group = dist.new_group(ranks, **kwargs)
            if rank in ranks:
                mine.append(group)
    return mine[0], mine[1]
