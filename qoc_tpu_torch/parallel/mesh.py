"""The device mesh of the batch layer (port of ``qoc_tpu.parallel.mesh``).

qoc_tpu shards the seed axis over a ``jax.sharding.Mesh`` and lets a
sharded array stand for the whole batch.  PyTorch's model is one process
per device: the mesh is a 1-D ``DeviceMesh`` over the ranks of the
default process group, each rank holds its slice of the seed axis
(``local_shard``), and ``gather`` puts the slices back together on every
rank.  Seeds are independent, so the optimization loops run no
collective; statistics and the global stop test are reduced over the mesh
(``all_reduce``).

``init_distributed`` starts the process group: NCCL when torch sees a
CUDA card, gloo otherwise, with the rendezvous taken from the environment
as ``torchrun`` sets it (or from the keyword arguments).  ``make_mesh``
with no process group forms a world of one over an in-process store, so a
single process needs no ``MASTER_ADDR``.  Gloo moves CUDA tensors in
broadcast and all_reduce only, so collectives on a CPU mesh (gloo) ride
on host tensors whatever the device of the work.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

BATCH_AXIS = "batch"


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(**kwargs) -> None:
    """Multi-process entry: call once per process before building a mesh.

    A thin wrapper over ``torch.distributed.init_process_group``;
    ``backend`` defaults to NCCL on a CUDA machine and gloo otherwise, and
    an NCCL rank takes the card ``LOCAL_RANK`` names (0 without it)."""
    kwargs.setdefault("backend", _default_backend())
    if kwargs["backend"] == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(**kwargs)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = BATCH_AXIS,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """1-D mesh over the seed axis: every rank of the default process group
    (a world of one, made here, when there is none).

    One process owns one device, so ``n_devices`` must equal the world size
    and ``devices``, the ranks, must be all of them in order: qoc_tpu's
    slice of a device list has no counterpart."""
    if not dist.is_initialized():
        init_distributed(store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh(n_devices={n_devices}): the mesh spans the process "
            f"group's {world} ranks, one device each; start {n_devices} "
            "processes (torchrun --nproc-per-node) to shard over "
            f"{n_devices} devices")
    if devices is not None and list(devices) != list(range(world)):
        raise ValueError(
            f"make_mesh(devices={list(devices)}): the mesh spans every rank "
            f"of the process group, 0..{world - 1}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(axis_name,))


def batch_sharding(mesh: DeviceMesh, axis_name: str = BATCH_AXIS) -> list:
    """Placements that shard the leading (seed) axis over ``mesh``."""
    return [Shard(0)]


def replicated(mesh: DeviceMesh) -> list:
    """Placements that replicate over ``mesh``."""
    return [Replicate()]


def local_shard(x, mesh: DeviceMesh):
    """This rank's slice of the leading axis of ``x`` (numpy or torch)."""
    n, rank = mesh.size(), mesh.get_local_rank()
    S = x.shape[0]
    if S % n:
        raise ValueError(
            f"the leading axis ({S}) does not divide by the mesh size ({n})")
    k = S // n
    return x[rank * k:(rank + 1) * k]


def _on_mesh(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """A copy of ``x`` on the device the mesh's collectives take (gloo:
    the host); bool rides as uint8."""
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.to(mesh.device_type, copy=True).contiguous()


def gather(x_local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The global array on every rank: each rank's slice concatenated over
    the leading axis, on ``x_local``'s device and dtype."""
    t = _on_mesh(x_local, mesh)
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(parts, t, group=mesh.get_group())
    return torch.cat(parts).to(x_local.device, x_local.dtype)


def all_reduce(x: torch.Tensor, mesh: DeviceMesh,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced element-wise over the mesh, on ``x``'s device."""
    t = _on_mesh(x, mesh)
    dist.all_reduce(t, op=op, group=mesh.get_group())
    return t.to(x.device, x.dtype)
