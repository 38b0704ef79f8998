"""Device mesh over torch.distributed, and the batch helpers of data parallelism
(the counterpart of novic_tpu.parallel.mesh).

One process per device, as torchrun launches them: the caller initialises the
default process group (backend nccl on CUDA, gloo on the CPU; the backend
follows the device) and sets its rank's device. `create_mesh` lays the ranks
out row-major on named axes, as novic_tpu reshapes its device list, and makes
one process group per axis line, so a rank reduces over the ranks that share
its other coordinates. By default the mesh is one 'data' axis over all ranks,
and size 1 on any other axis.

`init_from_env` joins the group torchrun describes. Data parallelism:
`shard_rows` takes a rank's slice of a batch's leading axis (its coordinate
on the axis picks the slice), `gather_rows` all-gathers the slices back in
rank order, so every rank holds the whole output.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from novic_tpu_torch.device import resolve


def backend_for(device: Union[str, torch.device]) -> str:
    """The process-group backend for a device type: nccl for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def same_device(a: Union[str, torch.device], b: Union[str, torch.device]) -> bool:
    """Whether two devices are one ('cuda' is the current CUDA device)."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return norm(a) == norm(b)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh of ranks on named axes."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int
    coords: tuple[int, ...]            # this rank's coordinate on each axis
    groups: tuple                      # this rank's process group on each axis
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, as a JAX Mesh's shape."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of ranks in the mesh."""
        return int(np.prod(self.sizes))

    def axis_size(self, name: str) -> int:
        """The size of an axis; 1 for an axis the mesh does not have."""
        return self.shape.get(name, 1)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on an axis; 0 for an axis the mesh does not have."""
        return self.coords[self.axis_names.index(name)] if name in self.axis_names else 0

    def group(self, name: str):
        """This rank's process group along an axis."""
        if name not in self.axis_names:
            raise ValueError(f"Mesh has no '{name}' axis: {self.axis_names}")
        return self.groups[self.axis_names.index(name)]


def init_from_env(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Join the process group torchrun describes in the environment
    (WORLD_SIZE > 1; env:// rendezvous at MASTER_ADDR:MASTER_PORT) unless one
    is initialised already, and return this rank's device: for CUDA without
    an index, cuda:LOCAL_RANK, made the current device. Without either, the
    device as given."""
    dev = resolve(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and world <= 1:
        return dev
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev), init_method="env://")
    return dev


def create_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
                device: Union[str, torch.device] = "cuda") -> Mesh:
    """Mesh over the initialised default process group. `shape` defaults to
    (world size, 1, ...): one 'data' axis over all ranks. `device` is this
    rank's device; its type must match the group's backend. Every rank calls
    it with the same arguments (it creates process groups collectively)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    dev = resolve(device)
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise ValueError(f"Process group backend {backend} does not serve device {dev} "
                         f"(nccl for CUDA, gloo for the CPU)")
    world, rank = dist.get_world_size(), dist.get_rank()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"Mesh shape {shape} does not match axes {axis_names}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"Mesh shape {shape} holds {int(np.prod(shape))} ranks, "
                         f"the process group {world}")
    grid = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(grid == rank)[0])
    groups = []
    for axis in range(len(shape)):
        mine = None
        # Every rank creates every line's group, in the same order (new_group is collective)
        lines = np.moveaxis(grid, axis, -1).reshape(-1, shape[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = g
        groups.append(mine)
    return Mesh(axis_names=axis_names, sizes=shape, rank=rank, coords=coords,
                groups=tuple(groups), device=dev)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data", dim: int = 0) -> torch.Tensor:
    """This rank's slice of `x` along `dim` (the batch axis), by its coordinate
    on `axis`; raises ValueError when the batch does not divide."""
    n = mesh.axis_size(axis)
    b = x.shape[dim]
    if b % n:
        raise ValueError(f"Batch size {b} not divisible by the {n}-rank '{axis}' axis")
    per = b // n
    return x.narrow(dim, mesh.axis_index(axis) * per, per)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """All-gather every rank's slice along `axis` and concatenate them on the
    leading axis in rank order (bool tensors travel as uint8)."""
    n = mesh.axis_size(axis)
    send = x.contiguous()
    as_bool = send.dtype == torch.bool
    if as_bool:
        send = send.to(torch.uint8)
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=mesh.group(axis))
    out = torch.cat(parts, dim=0)
    return out.bool() if as_bool else out
