"""The process mesh of the multi-GPU path (port of `parallel/mesh.py`).

The JAX package shards arrays over a 1-D `jax.sharding.Mesh` of devices
under one controller. Here every rank is its own process, as `torchrun`
starts them: each calls the same function on the same inputs, computes its
shard, and a collective stands where `shard_map` produced the global array.
`Mesh` records what that needs: the process group, this rank, the world
size, this rank's device and the group's backend. The axis name defaults
to the config's `TPUConfig.mesh_axis` ("data"); the rank is the position
on it.

Backends: NCCL for CUDA tensors, gloo for CPU tensors, or gloo for CUDA
tensors when asked (`backend="gloo"`: several ranks can then share one
card). Gloo gathers CPU tensors only, so on a gloo mesh over CUDA the
collectives below copy each tensor to the host and back explicitly.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from autopanostitch_tpu_torch import device as device_mod
from autopanostitch_tpu_torch.config import TPUConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: object  # the torch.distributed process group
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = TPUConfig.mesh_axis


def _rank_device(device) -> torch.device:
    """`device` resolved; a bare "cuda" names this rank's card,
    cuda:$LOCAL_RANK (0 when unset)."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(device="cuda", backend: str | None = None, group=None,
              axis: str = TPUConfig.mesh_axis) -> Mesh:
    """The mesh of the default process group (or `group`) on `device`.

    The group is the one the caller initialised, or, under `torchrun`
    (MASTER_ADDR and WORLD_SIZE set), one initialised here from the
    environment. `backend` defaults to "nccl" for CUDA and "gloo" for the
    CPU; "gloo" may be asked for CUDA. A group of another backend raises:
    nothing switches backend or device silently."""
    dev = _rank_device(device)
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want not in ("nccl", "gloo") or (dev.type != "cuda" and want == "nccl"):
        raise ValueError(f"make_mesh: backend {want!r} does not serve {dev}")
    if not dist.is_initialized():
        if group is not None or not {"MASTER_ADDR", "WORLD_SIZE"} <= set(os.environ):
            raise RuntimeError("make_mesh: no process group; call "
                               "torch.distributed.init_process_group or launch with torchrun")
        dist.init_process_group(want, init_method="env://")
    have = dist.get_backend(group)
    if have != want:
        raise ValueError(f"make_mesh: the process group runs {have!r}, {want!r} asked for {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group),
                device=dev, backend=have, axis=axis)


def _via_host(mesh: Mesh) -> bool:
    return mesh.backend == "gloo" and mesh.device.type == "cuda"


def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x as the collective takes it: bool as uint8 (not every backend
    reduces or gathers bool), on the host for gloo over CUDA."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.cpu() if _via_host(mesh) else x


def _unwire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def shard_bounds(n: int, mesh: Mesh):
    """(lo, hi, per): this rank's rows [lo, hi) of n, ceil(n / size) rows a
    rank (the last ranks may hold fewer, or none)."""
    per = -(-n // mesh.size)
    lo = min(n, mesh.rank * per)
    return lo, min(n, lo + per), per


def shard_leading(x: torch.Tensor, mesh: Mesh, value=0) -> torch.Tensor:
    """This rank's slice of x's leading axis, padded with `value` to a
    multiple of the mesh size (ceil(n / size) rows on every rank)."""
    lo, hi, per = shard_bounds(x.shape[0], mesh)
    part = x[lo:hi]
    if hi - lo < per:
        fill = torch.full((per - (hi - lo),) + tuple(x.shape[1:]), value, dtype=x.dtype,
                          device=x.device)
        part = torch.cat([part, fill])
    return part.contiguous()


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x as rank 0 holds it, on every rank (a broadcast; same shape and
    dtype on every rank)."""
    w = _wire(x, mesh).clone()
    dist.broadcast(w, src=dist.get_global_rank(mesh.group, 0) if mesh.group else 0,
                   group=mesh.group)
    return _unwire(w, x)


def gather_rows(x: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """The inverse of `shard_bounds`: every rank's rows (this rank's x holds
    rows [lo, hi) of n) concatenated in rank order, on every rank."""
    _, _, per = shard_bounds(n, mesh)
    if x.shape[0] < per:
        x = torch.cat([x, x.new_zeros((per - x.shape[0],) + tuple(x.shape[1:]))])
    w = _wire(x, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return _unwire(torch.cat(parts)[:n], x)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's x, on every rank."""
    w = _wire(x, mesh).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.group)
    return _unwire(w, x)
