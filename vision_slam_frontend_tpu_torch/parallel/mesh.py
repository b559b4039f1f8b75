"""Shard groups and multi-process initialization (port of parallel/mesh.py).

The JAX package shards over a 1-D device mesh and lets GSPMD place the
collectives. The port writes each distributed formulation once against a
small shard-group object that holds the reductions it needs:

  - `segsum(data, ids, num, shard=None)`: this shard's partial sums of the
    rows of `data` into `num` segments by `ids`;
  - `all_reduce(partial)`: the sum of every shard's partial;
  - `local_rows(n)`: the rows of n rows split evenly over the shards that
    this process holds, and `gather_rows(x)`: every shard's rows, gathered;
  - `total(x)`: the sum of x's rows over every shard (segsum + all_reduce).

Two groups implement them:

  - `ProcessShards`: one shard per process over `torch.distributed` (NCCL on
    CUDA, gloo on the CPU; gloo also carries CUDA tensors, so two ranks can
    share one GPU). A process holds its own shard's rows.
  - `LocalShards`: n shards in one process on one device, the counterpart of
    the JAX package's virtual CPU devices. Rows of all shards lie in one
    tensor, shard k's in the k-th of n equal consecutive blocks (or as
    `shard` says); a partial carries a leading shard axis and a reduction is
    a sum over it.

Both count the collectives they run (`calls`, and `bytes`: each call's output
payload, the convention of the JAX package's comm_report), so a caller can
read the traffic of a step.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vision_slam_frontend_tpu_torch.backend.ba import _segsum


class ShardGroup:
    """A shard group's size, this process's rank and device, and the counts
    of the collectives run through it."""

    def __init__(self, size: int, rank: int, device):
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.calls = 0
        self.bytes = 0

    def _count(self, out: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        self.bytes += out.numel() * out.element_size()
        return out

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x's rows over every shard, a 0-d tensor."""
        zeros = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        return self.all_reduce(self.segsum(x[:, None], zeros, 1)).reshape(())


class LocalShards(ShardGroup):
    """`size` shards in this process (rank 0 of 1 process)."""

    def __init__(self, size: int, device="cuda"):
        super().__init__(size, 0, device)

    def segsum(self, data, ids, num: int, shard=None):
        """(size, num, ...) partial sums; row i belongs to shard[i], by
        default to the i // (rows / size)-th block."""
        if shard is None:
            rows = data.shape[0]
            if rows % self.size:
                raise ValueError(f"{rows} rows do not split into {self.size} shards")
            shard = torch.arange(rows, device=data.device) // (rows // self.size)
        out = _segsum(data, ids + shard * num, self.size * num)
        return out.view(self.size, num, *data.shape[1:])

    def all_reduce(self, partial):
        return self._count(partial.sum(0))

    def local_rows(self, n: int) -> slice:
        return slice(0, n)

    def gather_rows(self, x):
        """`x` holds every shard's rows already."""
        return self._count(x)


class ProcessShards(ShardGroup):
    """One shard per process of the initialized default process group."""

    def __init__(self, device):
        import torch.distributed as dist

        super().__init__(dist.get_world_size(), dist.get_rank(), device)

    def segsum(self, data, ids, num: int, shard=None):
        return _segsum(data, ids, num)

    def all_reduce(self, partial):
        import torch.distributed as dist

        out = partial.contiguous().clone()
        dist.all_reduce(out)
        return self._count(out)

    def local_rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"{n} rows do not split into {self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def gather_rows(self, x):
        """Every rank's rows of x (rank order), concatenated."""
        import torch.distributed as dist

        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return self._count(out)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> ShardGroup:
    """The shard group of n devices: the process group's ranks when
    `torch.distributed` is initialized (its world size must be n), else n
    shards in this process on `device` (the CPU parity tests' form)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"need {n_devices} ranks, the process group has {world}")
        return ProcessShards(device)
    if n_devices is None or n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: an in-process group needs a shard count")
    return LocalShards(n_devices, device)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join a process group when a cluster is configured.

    Reads MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK when the arguments are
    omitted; the coordinator is "host:port" of process 0. The backend is NCCL
    for a CUDA `device` (default: CUDA when a GPU is visible) and gloo for the
    CPU, unless `backend` names one. Returns True when the group was
    initialized; False when no cluster is configured (the caller runs
    locally)."""
    import torch.distributed as dist

    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    device = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", device.index if device.index is not None else 0)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id, **kwargs,
    )
    return True
