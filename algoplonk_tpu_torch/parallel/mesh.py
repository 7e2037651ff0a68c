"""A one-axis mesh of torch devices, driven from one process, and the
collectives the sharded MSM and NTT use.

Counterpart of ``jax.sharding.Mesh`` as the reference's ``shard_map``
bodies use it (``algoplonk_tpu/parallel/``): one controller holds a list of
shards, one tensor per device, and a collective is explicit ``.to(device)``
copies and a concatenation.  Devices may repeat, so ``Mesh(["cuda:0"] * 4)``
runs the four-shard decomposition, with its kernels, on one card, as the
reference checks its mesh on virtual CPU devices.  Shard i lives on
``mesh.devices[i]``; a copy to the device a tensor is already on is free.

There is no fallback: a mesh that names a CUDA device torch does not find
raises.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with a CUDA index (``"cuda"`` is the
    current card), or RuntimeError where torch finds no such card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}: name \"cpu\" to run on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"no CUDA device {dev}: torch finds {torch.cuda.device_count()}")
    return dev


def on_device(device):
    """Context that makes ``device`` current for kernel launches (CUDA), or
    nothing (CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Mesh:
    """``devices`` along the one axis ``axis_names[0]``; ``shape[axis]`` is
    the shard count."""

    def __init__(self, devices, axis_names=("x",)):
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError(f"a mesh has one axis here, got {axis_names}")
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = axis_names
        self.shape = {axis_names[0]: len(self.devices)}

    def shard(self, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
        """x split into equal contiguous blocks along ``dim``, block i on
        devices[i] (``PartitionSpec`` with the axis at ``dim``)."""
        d = len(self.devices)
        if x.shape[dim] % d:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split {d} ways")
        return [part.to(dev).contiguous()
                for part, dev in zip(torch.chunk(x, d, dim=dim), self.devices)]


def all_gather(parts: list[torch.Tensor], dst, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` on ``dst`` (the inverse of
    ``Mesh.shard(x, dim)``)."""
    dst = torch.device(dst)
    return torch.cat([p.to(dst) for p in parts], dim=dim)


def all_to_all(parts: list[torch.Tensor], split_dim: int, concat_dim: int) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=False)``
    over the shards: every shard's ``split_dim`` has size D (the shard
    count) and is removed, and shard j receives at index i of a new
    dimension ``concat_dim`` the j-th slice of shard i:
    out[j].select(concat_dim, i) == parts[i].select(split_dim, j)."""
    d = len(parts)
    if any(p.shape[split_dim] != d for p in parts):
        raise ValueError(f"all_to_all: dimension {split_dim} must have the shard count {d}")
    return [
        torch.stack([parts[i].select(split_dim, j).to(parts[j].device) for i in range(d)],
                    dim=concat_dim)
        for j in range(d)
    ]
