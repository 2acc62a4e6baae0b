"""The shard mesh over torch.distributed (counterpart of qadc_tpu/dist/mesh.py).

A mesh is a 1-D axis of `shards`, contiguous and process-major: process
`rank` of `world` holds shards [rank * L, (rank + 1) * L), L = shards //
world, on its one device. Several local shards in one process stand in for
several devices of one host: the CPU tests run 8 shards in one process, and
one card holds 4. The collectives first reduce over the local shards and
call torch.distributed only across processes (world > 1): NCCL for a mesh
on CUDA devices, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from qadc_tpu_torch.core.tensors import DEFAULT_DEVICE

# Name of the mesh's one axis (the JAX package's mesh axis and PartitionSpec
# name; the port's meshes are 1-D and carry no axis names).
SHARD_AXIS = "shard"

# How long a rendezvous or a collective may wait for a peer before it raises.
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D shard mesh.

    Attributes:
      shards: shards in the whole mesh.
      rank: this process's rank; world: the process count.
      device: where this process's shards live.
      group: the process group of the collectives (None without one).
    """

    shards: int
    rank: int
    world: int
    device: torch.device
    group: object = None

    @property
    def local_shards(self) -> int:
        return self.shards // self.world

    @property
    def first_shard(self) -> int:
        """Global id of this process's first shard."""
        return self.rank * self.local_shards

    def gather(self, parts: list[torch.Tensor], dim: int = 0, async_op: bool = False):
        """Concatenate every shard's part along `dim`, in shard order.

        parts: this process's local shards' tensors, in order (each shard's
        shape alike across processes). With async_op the cross-process
        gather is only issued: the result is a callable that waits for it
        and returns the tensor.
        """
        local = torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]
        if self.world == 1:
            return (lambda: local) if async_op else local
        local = local.contiguous()
        out = [torch.empty_like(local) for _ in range(self.world)]
        work = dist.all_gather(out, local, group=self.group, async_op=async_op)
        if not async_op:
            return torch.cat(out, dim=dim)

        def wait():
            work.wait()
            return torch.cat(out, dim=dim)
        return wait

    def sum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Elementwise sum of the shards' parts (this process's: `parts`)."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        if self.world > 1:
            total = total.clone()
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return total


def _local_rank(rank: int) -> int:
    """The process's index among those of its host: torchrun's LOCAL_RANK,
    else the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


def make_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """The mesh of this process group (or of this process alone).

    n_shards: shards in the whole mesh, a multiple of the process count
      (default: one a process).
    device: this process's device (default cuda:{local rank}, the card).
    """
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    shards = world if n_shards is None else n_shards
    if shards < 1 or shards % world:
        raise ValueError(f"{shards} shards do not divide over {world} processes")
    if device is None:
        device = torch.device(DEFAULT_DEVICE, _local_rank(rank))
    return Mesh(shards=shards, rank=rank, world=world, device=torch.device(device),
                group=dist.group.WORLD if initialized else None)


def maybe_init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=DEFAULT_DEVICE,
) -> bool:
    """Start the torch.distributed process group for a multi-process run;
    safe to call anywhere.

    Resolution order, as in the JAX package: explicit arguments, then the
    QADC_COORDINATOR ("host:port") / QADC_NUM_PROCESSES / QADC_PROCESS_ID
    environment variables, then, only with QADC_DISTRIBUTED=auto,
    torchrun's variables (init_method "env://"). Without any of them it
    does nothing and cannot block. The backend is NCCL when `device` is a
    CUDA device (its card is set first) and gloo on the CPU; a failed
    start raises.

    Returns True when a process group is (or already was) started with a
    coordinator, as the JAX package's does; with QADC_DISTRIBUTED=auto,
    whether the group has more than one process.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("QADC_COORDINATOR")
    if num_processes is None and "QADC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["QADC_NUM_PROCESSES"])
    if process_id is None and "QADC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["QADC_PROCESS_ID"])
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the process count and this process's id")
        _set_card(device, process_id)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
        return True
    if os.environ.get("QADC_DISTRIBUTED") == "auto" and "MASTER_ADDR" in os.environ:
        rank = int(os.environ.get("RANK", "0"))
        _set_card(device, rank)
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        return dist.get_world_size() > 1
    return False


def _set_card(device: torch.device, rank: int) -> None:
    """Make this process's card current before NCCL starts on it."""
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None
                              else torch.device("cuda", _local_rank(rank)))
