# -*- coding: utf-8 -*-
"""The ("data", "model") mesh over the process group.

Counterpart of `fddm_asr_tpu/parallel/mesh.py:37-64`: `MeshSpec`,
`resolve`, `make_mesh`, and the CLIs' `parse_mesh` (the grammar of the
repository's `train.py`: "data=D,model=M", either part optional).

A process is one GPU, so the mesh is over ranks: rank d * M + m sits at
(data d, model m), the "model" ranks of one data index adjacent (within a
host, as the JAX package keeps its model axis on ICI).  `make_mesh` builds
a `torch.distributed.DeviceMesh` with those dims and keeps its two process
groups: "data" (gradients averaged, batches split) and "model" (the
sequence-parallel ring of `ops/ring_attention.py`, or tensor parallelism),
and names them for the collective ops (`distributed.name_axes`): an op
recorded over "model" runs over the last mesh's "model" group.  The world size must
equal data x model; the JAX package's pinned subset meshes, a 1x1 mesh on
a host of eight devices, have no counterpart when each process owns its
device.  Without a process group the mesh is the trivial 1x1 one with no
groups, and every collective on it is skipped.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from fddm_asr_tpu_torch.parallel.distributed import bound_axes, name_axes, process_group

__all__ = ["MeshSpec", "Mesh", "make_mesh", "parse_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1  # -1: every rank the model axis leaves
    model: int = 1

    def resolve(self, world_size: int) -> Tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, world_size // model)
        if data * model != world_size:
            raise ValueError(
                f"mesh data={data},model={model} needs {data * model} processes but the "
                f"process group has {world_size}: a process drives one GPU, so launch "
                f"torchrun --nproc_per_node {data * model} (or change --mesh)")
        return data, model


def parse_mesh(spec: str) -> MeshSpec:
    """"data=D,model=M" (either part optional; "" is every rank on data)."""
    if not spec:
        return MeshSpec()
    kv = dict(part.split("=") for part in spec.split(","))
    unknown = set(kv) - {"data", "model"}
    if unknown:
        raise ValueError(f"--mesh {spec!r}: unknown axes {sorted(unknown)} (data, model)")
    return MeshSpec(data=int(kv.get("data", -1)), model=int(kv.get("model", 1)))


class Mesh:
    """This rank's place in the ("data", "model") mesh and its groups.

    `shape` {"data": D, "model": M}; `data_rank`, `model_rank` its
    coordinates; `data_group` the ranks that share its model index,
    `model_group` those that share its data index (None on a trivial mesh);
    `device_mesh` the DeviceMesh (None without a process group)."""

    def __init__(self, data: int, model: int, rank: int = 0, device_mesh=None):
        self.shape = {"data": data, "model": model}
        self.size = data * model
        self.data_rank, self.model_rank = divmod(rank, model)
        self.device_mesh = device_mesh
        self.data_group = device_mesh.get_group("data") if device_mesh is not None else None
        self.model_group = device_mesh.get_group("model") if device_mesh is not None else None

    def axes(self):
        """A context in which the collective ops' "data" and "model" run over
        this mesh's groups (`distributed.bound_axes`)."""
        if self.device_mesh is None:
            return contextlib.nullcontext()
        return bound_axes({"data": self.data_group, "model": self.model_group})

    @property
    def distributed(self) -> bool:
        """True when a process group exists (collectives run, even over one rank)."""
        return self.device_mesh is not None


def make_mesh(spec: MeshSpec = MeshSpec(), device: Optional[torch.device] = None) -> Mesh:
    """The mesh of `spec` over the process group (`distributed.initialize`
    first); the trivial mesh when there is no group and `spec` resolves to
    one process."""
    rank, world = process_group()
    data, model = spec.resolve(world)
    if not dist.is_initialized():
        return Mesh(data, model)
    from torch.distributed.device_mesh import DeviceMesh

    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    layout = torch.arange(world).reshape(data, model)
    mesh = Mesh(data, model, rank,
                DeviceMesh(device.type, layout, mesh_dim_names=("data", "model")))
    # the names the collective ops record resolve to this mesh's groups now
    name_axes({"data": mesh.data_group, "model": mesh.model_group})
    return mesh
