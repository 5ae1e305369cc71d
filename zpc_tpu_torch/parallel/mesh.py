"""The device mesh layer on ``torch.distributed`` (counterpart of
``zpc_tpu/parallel/mesh.py``).

JAX runs one process over many devices and places arrays by sharding; the
port runs one process per rank and one device per rank, and a tensor is
always this rank's own.  So:

* :func:`initialize_distributed` wraps ``init_process_group``: NCCL for a
  CUDA device (the default), gloo for the CPU, chosen by the device the
  caller passes;
* :func:`make_mesh` and :func:`make_global_mesh` give the 1-D
  ``DeviceMesh`` of every rank, named ``"d"``;
* :func:`shard_leading` cuts this rank's rows out of a full tensor and
  :func:`replicated` keeps a tensor whole, each on the rank's device;
* :func:`local_to_global_index` and :func:`global_array` gather over the
  mesh (``all_gather``), :func:`process_info` reads the group.

A mesh's collectives run over ``mesh.get_group(axis)``, whose ranks are
the world's.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.executor import cuda_device

__all__ = ["make_mesh", "shard_leading", "replicated", "Mesh",
           "local_to_global_index", "initialize_distributed",
           "process_info", "make_global_mesh", "global_array",
           "mesh_device", "mesh_rank"]

Mesh = DeviceMesh

_DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Optional[torch.device] = None,
                           timeout: datetime.timedelta = _DEFAULT_TIMEOUT
                           ) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, meeting at ``coordinator_address`` (``tcp://host:port``
    or ``file://path``; ``host:port`` means tcp).  The backend follows
    ``device``, this rank's device: NCCL for a CUDA device (the card by
    default, made the current device), gloo for the CPU.  Every collective
    gives up after ``timeout``.

    Without arguments the standard environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets it) is
    read; with none of it set this is a single-process run and nothing is
    done.  Nothing is done either when the group exists already."""
    if dist.is_initialized():
        return
    dev = cuda_device() if device is None else torch.device(device)
    if coordinator_address is None and num_processes is None:
        if "MASTER_ADDR" not in os.environ:
            return
        init_method = "env://"
    else:
        if coordinator_address is None or num_processes is None or \
                process_id is None:
            raise ValueError("give coordinator_address, num_processes and "
                             "process_id together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def make_global_mesh(axis: str = "d") -> DeviceMesh:
    """The 1-D mesh over every rank of the process group, named ``axis``;
    its device type follows the group's backend (NCCL: cuda)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def make_mesh(n_devices: Optional[int] = None, axis: str = "d",
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """The 1-D mesh over the ranks, each holding one device.  A rank has one
    device, so ``n_devices`` (or ``len(devices)``) must equal the world
    size when given."""
    mesh = make_global_mesh(axis)
    want = len(devices) if devices is not None else n_devices
    if want is not None and want != mesh.size():
        raise ValueError(f"a mesh of {want} devices, but {mesh.size()} "
                         f"ranks of one device each")
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_rank(mesh: DeviceMesh, axis: str = "d"):
    """(this rank's index, the number of ranks) along ``axis``."""
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(
        axis))


def shard_leading(mesh: DeviceMesh, x: torch.Tensor,
                  axis: str = "d") -> torch.Tensor:
    """This rank's equal share of the leading axis of the full tensor
    ``x``, on the rank's device (the leading length must divide by the
    mesh size)."""
    r, n = mesh_rank(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"leading length {x.shape[0]} does not divide by "
                         f"the mesh's {n} ranks")
    k = x.shape[0] // n
    return x[r * k:(r + 1) * k].to(mesh_device(mesh))


def replicated(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x`` on this rank's device."""
    return x.to(mesh_device(mesh))


def global_array(mesh: DeviceMesh, local_shard: torch.Tensor,
                 axis: str = "d") -> torch.Tensor:
    """The full tensor on every rank: each rank's ``local_shard`` (equal
    shapes) gathered along the leading axis in rank order."""
    group = mesh.get_group(axis)
    parts = [torch.empty_like(local_shard)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local_shard.contiguous(), group=group)
    return torch.cat(parts)


def local_to_global_index(mesh: DeviceMesh, n_local: int,
                          axis: str = "d") -> torch.Tensor:
    """Global indices of this rank's ``n_local`` leading rows: the ranks'
    row counts are gathered, so shards may differ in length."""
    dev = mesh_device(mesh)
    counts = global_array(mesh, torch.tensor([n_local], dtype=torch.int64,
                                             device=dev), axis)
    r = mesh.get_local_rank(axis)
    start = counts[:r].sum()
    return start + torch.arange(n_local, device=dev)


def process_info():
    """(rank, number of ranks, devices of this rank): (0, 1, 1) without a
    process group."""
    if not dist.is_initialized():
        return 0, 1, 1
    return dist.get_rank(), dist.get_world_size(), 1
