# -*- coding: utf-8 -*-
"""The process group: one process per GPU, joined by torch.distributed.

Counterpart of `fddm_asr_tpu/parallel/distributed.py`, in PyTorch's idiom
rather than JAX's: a process drives one GPU (JAX runs one process a host
over all its devices), ranks meet in a `torch.distributed` process group,
and collectives run over NCCL between ranks with a card each.

  * `DistributedConfig.from_env` reads FDDM_COORDINATOR (host:port),
    FDDM_NUM_PROCESSES and FDDM_PROCESS_ID as the JAX package does, and
    torchrun's MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK
    beneath them; FDDM_BACKEND and FDDM_DEVICE choose the backend and the
    rank's device.
  * The backend is explicit: `nccl` on the card and `gloo` on the CPU by
    default, or `gloo` chosen for CUDA ranks (two ranks that share one card,
    which NCCL refuses).  Nothing switches backend after a failure.  Gloo
    takes CUDA tensors only through the host here: every collective of this
    module copies a CUDA tensor into pinned host memory for a gloo group and
    back, and counts the bytes and seconds in `STAGING`.
  * `initialize` is a no-op for one process with nothing configured; every
    single-GPU path runs unchanged.
  * A rank's device is cuda:LOCAL_RANK, or FDDM_DEVICE where set.

The collectives of a forward are `torch.ops.fddm` ops (`torch.library`,
each with a fake implementation), so that `torch.export` records them as
nodes of a program, as it records the kernels' ops:

  * `fddm::all_reduce(x, axis, op)`: the sum ("sum") or maximum ("max")
    over a group, into a new tensor;
  * `fddm::all_gather(x, axis, dim)`: every rank's `x` concatenated along
    `dim`, in group rank order;
  * `fddm::ring_shift(buf, axis)`: one hop of a ring (to the previous
    rank, from the next).

An op names its group by the mesh axis it runs over ("data" or "model",
`axis_key`), not by a process-group object: it resolves the group when it
runs, from the mesh this process joined last (`make_mesh` names its two
groups, `name_axes`) or the one a caller binds for a block (`bound_axes`:
an exported program's trace and calls bind their own mesh), so a program
traced in one set of processes runs in another, whatever order they
created their groups in.  A group outside a
mesh (a test's `new_group`, the world) is named "group:<c10d name>" and
resolves in the process that named it.  Over NCCL an op runs the c10d
collective, which orders itself against the current stream (and is
recorded by a CUDA graph's capture); over gloo it stages CUDA tensors as
above.  The live path calls the same ops; the autograd Functions that
training differentiates (`gather`, `parallel/tensor.py`'s) wrap them, and
the bucketed gradient all-reduce (`all_reduce_`) reduces through
`fddm::all_reduce` too.  The ("data", "model") mesh over the group is
`parallel/mesh.py`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["DistributedConfig", "initialize", "shutdown", "process_group", "is_primary",
           "host_shard", "all_hosts_mean", "all_hosts_weighted_mean", "barrier",
           "broadcast_object", "broadcast_", "all_reduce_", "all_gather", "gather",
           "ring_rank", "ring_shift", "name_axes", "bound_axes", "axis_key", "axis_group",
           "STAGING"]

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Where the process group meets and who this process is in it.

    All fields optional: None everywhere is one process.  `backend` None
    takes nccl for a CUDA device and gloo for the CPU; `device` (e.g.
    "cuda:0") overrides the rank's device, cuda:`local_rank`."""

    coordinator_address: Optional[str] = None  # host:port of rank 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_rank: Optional[int] = None
    backend: Optional[str] = None
    device: Optional[str] = None

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "DistributedConfig":
        """FDDM_COORDINATOR / FDDM_NUM_PROCESSES / FDDM_PROCESS_ID, else
        torchrun's MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK; LOCAL_RANK;
        FDDM_BACKEND; FDDM_DEVICE."""
        env = os.environ if env is None else env

        def pick(*names):
            for n in names:
                v = env.get(n)
                if v not in (None, ""):
                    return v
            return None

        addr = pick("FDDM_COORDINATOR")
        if addr is None and pick("MASTER_ADDR") is not None:
            addr = f"{env['MASTER_ADDR']}:{pick('MASTER_PORT') or 29500}"
        nproc = pick("FDDM_NUM_PROCESSES", "WORLD_SIZE")
        pid = pick("FDDM_PROCESS_ID", "RANK")
        local = pick("LOCAL_RANK")
        return cls(coordinator_address=addr,
                   num_processes=int(nproc) if nproc is not None else None,
                   process_id=int(pid) if pid is not None else None,
                   local_rank=int(local) if local is not None else None,
                   backend=pick("FDDM_BACKEND"), device=pick("FDDM_DEVICE"))

    def overridden(self, coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> "DistributedConfig":
        """This config with the CLI's flags in place of what they set."""
        return dataclasses.replace(
            self, coordinator_address=coordinator or self.coordinator_address,
            num_processes=num_processes if num_processes is not None else self.num_processes,
            process_id=process_id if process_id is not None else self.process_id)

    @property
    def is_multiprocess(self) -> bool:
        return (self.num_processes or 1) > 1 or self.coordinator_address is not None

    def rank_device(self, device: Optional[str] = "cuda") -> torch.device:
        """This rank's device: the CPU when `device` names it, else
        `self.device` or cuda:LOCAL_RANK (LOCAL_RANK defaults to 0)."""
        dev = torch.device(device if device is not None else "cuda")
        if dev.type == "cpu":
            return dev
        if self.device is not None:
            dev = torch.device(self.device)
        elif dev.index is None:
            dev = torch.device("cuda", self.local_rank or 0)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass device='cpu' "
                                   "(--device cpu) to run on the CPU")
            if dev.index >= torch.cuda.device_count():
                raise ValueError(
                    f"rank device {dev} does not exist ({torch.cuda.device_count()} visible): "
                    "a process drives one GPU, so launch at most one process per GPU "
                    "(torchrun --nproc_per_node <GPUs>), or set FDDM_DEVICE=cuda:0 with "
                    "FDDM_BACKEND=gloo for ranks that share one card")
        return dev

    def resolved_backend(self, device: torch.device) -> str:
        backend = self.backend or ("nccl" if device.type == "cuda" else "gloo")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the nccl backend needs CUDA ranks; the CPU takes gloo")
        return backend


@dataclasses.dataclass
class StagingStats:
    """CUDA tensors a gloo group moved through pinned host memory."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    announced: bool = False

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes, "seconds": self.seconds}


STAGING = StagingStats()


def initialize(cfg: Optional[DistributedConfig] = None,
               device: Optional[str] = "cuda") -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    A no-op for one process with no coordinator, and once the group exists.
    Otherwise the rank's device (`DistributedConfig.rank_device`) becomes the
    current CUDA device before the group forms, and the group meets at
    tcp://coordinator over the config's backend."""
    cfg = DistributedConfig.from_env() if cfg is None else cfg
    if not cfg.is_multiprocess or dist.is_initialized():
        return process_group()
    if cfg.coordinator_address is None or cfg.num_processes is None or cfg.process_id is None:
        raise ValueError("a process group needs its coordinator (host:port), its number of "
                         "processes and this process's id: --coordinator / --num-processes / "
                         "--process-id, FDDM_* or torchrun's environment")
    dev = cfg.rank_device(device)
    backend = cfg.resolved_backend(dev)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{cfg.coordinator_address}",
                            world_size=cfg.num_processes, rank=cfg.process_id)
    logging.info(f"process group: rank {cfg.process_id} of {cfg.num_processes} over {backend} "
                 f"on {dev}")
    return process_group()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_group() -> Tuple[int, int]:
    """(rank, world size) of the group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the process that owns the side effects: the run lock,
    metrics, checkpoints, result files."""
    return process_group()[0] == 0


def host_shard(mesh) -> Optional[Tuple[int, int]]:
    """`shard=` of data.dataset.make_batches: (rank in "data", data ways),
    None on a one-way data axis."""
    if mesh is None or mesh.shape["data"] == 1:
        return None
    return mesh.data_rank, mesh.shape["data"]


def _device_of(group) -> torch.device:
    """Where a scalar collective's tensor lives for `group`'s backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_hosts_mean(value: Any, group=None) -> float:
    """The mean of a per-rank scalar over `group` (the world by default);
    the value itself without a process group."""
    if not dist.is_initialized():
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=_device_of(group))
    dist.all_reduce(t, group=group)
    return float(t.item()) / dist.get_world_size(group)


def all_hosts_weighted_mean(value: Any, weight: float, group=None) -> float:
    """sum(v_i w_i) / sum(w_i) over `group`: a rank of weight 0 (an empty
    eval shard) adds nothing, and 0.0 when every weight is 0.  The value
    itself without a process group."""
    if not dist.is_initialized():
        return float(value)
    t = torch.tensor([float(value) * float(weight), float(weight)], dtype=torch.float64,
                     device=_device_of(group))
    dist.all_reduce(t, group=group)
    num, den = t.tolist()
    return num / den if den > 0 else 0.0


def barrier(group=None) -> None:
    if not dist.is_initialized():
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """`obj` of rank `src`, on every rank (picklable objects)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


# ------------------------------------------------------------ tensor collectives
def _stages(t: torch.Tensor, group) -> bool:
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    if staged and not STAGING.announced:
        STAGING.announced = True
        logging.info("gloo group: CUDA tensors are staged through pinned host memory")
    return staged


def _to_host(t: torch.Tensor) -> torch.Tensor:
    t0 = time.perf_counter()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    STAGING.calls += 1
    STAGING.bytes += t.numel() * t.element_size()
    STAGING.seconds += time.perf_counter() - t0
    return host


def _from_host(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    t0 = time.perf_counter()
    out = host.to(device, non_blocking=True)
    STAGING.bytes += host.numel() * host.element_size()
    STAGING.seconds += time.perf_counter() - t0
    return out


# ------------------------------------------------------------- the mesh's axes
# "data" and "model": the groups of the mesh this process joined last; other
# keys: groups named by `axis_key` outside a mesh
_AXES: dict = {}


def name_axes(groups: dict) -> None:
    """Name the groups of the mesh this process joined ({"data": group,
    "model": group}): the collective ops resolve these names when they run."""
    _AXES.update(groups)


@contextlib.contextmanager
def bound_axes(groups: dict):
    """The axis names bound to `groups` ({"data": group, "model": group})
    inside the block, and the earlier binding back after it: a loaded
    program's collectives run over its own mesh, whatever mesh this process
    made since."""
    saved = {name: _AXES.get(name) for name in groups}
    _AXES.update(groups)
    try:
        yield
    finally:
        for name, group in saved.items():
            if group is None:
                _AXES.pop(name, None)
            else:
                _AXES[name] = group


def axis_key(group) -> str:
    """The name a collective op records for `group` (None: the world): its
    mesh axis, "data" or "model", when it is one of the joined mesh's
    groups, else "group:<its c10d name>", kept for this process."""
    group = dist.group.WORLD if group is None else group
    for name in ("model", "data"):
        if _AXES.get(name) is group:
            return name
    key = f"group:{group.group_name}"
    _AXES[key] = group
    return key


def axis_group(key: str):
    """The process group a collective op's axis name stands for here."""
    group = _AXES.get(key)
    if group is None:
        raise RuntimeError(f"no process group for the mesh axis {key!r} in this process: join "
                           "the mesh first (parallel.make_mesh; an artifact's loader does)")
    return group


# ------------------------------------------------------------ the collective ops
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _op_all_reduce(x: torch.Tensor, axis: str, op: str) -> torch.Tensor:
    group = axis_group(axis)
    if _stages(x, group):
        host = _to_host(x)
        dist.all_reduce(host, op=_REDUCE_OPS[op], group=group)
        return _from_host(host, x.device)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=group)
    return out


def _op_all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    group = axis_group(axis)
    n = dist.get_world_size(group)
    x = x.contiguous()
    if _stages(x, group):
        host = _to_host(x)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return _from_host(torch.cat(parts, dim=dim), x.device)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _gathered_like(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = shape[dim] * dist.get_world_size(axis_group(axis))
    return x.new_empty(shape)


def _op_ring_shift(buf: torch.Tensor, axis: str) -> torch.Tensor:
    group = axis_group(axis)
    me, n = ring_rank(group)
    to = dist.get_global_rank(group, (me - 1) % n)
    frm = dist.get_global_rank(group, (me + 1) % n)
    staged = _stages(buf, group)
    send = _to_host(buf) if staged else buf.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group),
                                   dist.P2POp(dist.irecv, recv, frm, group)])
    for r in reqs:
        r.wait()
    return _from_host(recv, buf.device) if staged else recv


torch.library.custom_op("fddm::all_reduce", _op_all_reduce, mutates_args=()).register_fake(
    lambda x, axis, op: torch.empty_like(x, memory_format=torch.contiguous_format))
torch.library.custom_op("fddm::all_gather", _op_all_gather, mutates_args=()).register_fake(
    _gathered_like)
torch.library.custom_op("fddm::ring_shift", _op_ring_shift, mutates_args=()).register_fake(
    lambda buf, axis: torch.empty_like(buf, memory_format=torch.contiguous_format))


def _all_reduce_flat(flat: torch.Tensor, group, op) -> torch.Tensor:
    """`flat` reduced over `group` (`op` SUM or MAX) into a new tensor:
    `fddm::all_reduce`."""
    name = "sum" if op == dist.ReduceOp.SUM else "max"
    if op != _REDUCE_OPS[name]:
        raise ValueError(f"reduce op {op}: the collective op takes SUM or MAX")
    return torch.ops.fddm.all_reduce(flat, axis_key(group), name)


BUCKET_BYTES = 64 * 1024 * 1024


def all_reduce_(tensors: Sequence[torch.Tensor], group, op=dist.ReduceOp.SUM,
                scale: Optional[float] = None) -> None:
    """All-reduce `tensors` in place over `group`, packed into flat buckets
    of at most BUCKET_BYTES per dtype (one collective a bucket), each result
    multiplied by `scale` when given."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        buckets: List[List[torch.Tensor]] = [[]]
        size = 0
        for t in same:
            nbytes = t.numel() * t.element_size()
            if buckets[-1] and size + nbytes > BUCKET_BYTES:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += nbytes
        for bucket in buckets:
            flat = _all_reduce_flat(torch.cat([b.reshape(-1) for b in bucket]), group, op)
            if scale is not None:
                flat.mul_(scale)
            torch._foreach_copy_(bucket, [piece.view_as(b) for piece, b in zip(
                flat.split([b.numel() for b in bucket]), bucket)])


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank `src`'s `t` written into `t` on every rank of `group` (the world
    by default; `src` a global rank); returns `t`."""
    if _stages(t, group):
        host = _to_host(t)
        dist.broadcast(host, src=src, group=group)
        t.copy_(_from_host(host, t.device))
        return t
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along `dim`, in group
    rank order: `fddm::all_gather` (`t` itself on a group of one)."""
    if dist.get_world_size(group) == 1:
        return t
    return torch.ops.fddm.all_gather(t, axis_key(group), dim % t.dim())


class _Gather(torch.autograd.Function):
    """all_gather along `dim` whose backward hands each rank the rows of its
    own input: summed over the group first (`sum_grads`, for a loss that
    every rank computes and whose gradients are then averaged), or as they
    are (a consumer replicated over the group whose gradients are then
    summed)."""

    @staticmethod
    def forward(ctx, x, group, dim, sum_grads):
        ctx.group, ctx.dim, ctx.sum_grads = group, dim, sum_grads
        ctx.rows = x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        if ctx.sum_grads:
            grad = _all_reduce_flat(grad, ctx.group, dist.ReduceOp.SUM)
        rank = ring_rank(ctx.group)[0]
        return grad.narrow(ctx.dim, rank * ctx.rows, ctx.rows), None, None, None


def gather(x: torch.Tensor, group, dim: int = 0, sum_grads: bool = True) -> torch.Tensor:
    """`all_gather` that autograd differentiates (see `_Gather`); `x`
    itself on a group of one."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_gather(x, group, dim)
    return _Gather.apply(x, group, dim, sum_grads)


def ring_rank(group) -> Tuple[int, int]:
    """(this process's rank in `group`, the group's size)."""
    return dist.get_group_rank(group, dist.get_rank()), dist.get_world_size(group)


def ring_shift(buf: torch.Tensor, group) -> torch.Tensor:
    """One hop of a ring over `group`: `buf` (a flat byte tensor) goes to the
    previous rank and the next rank's comes back, as the JAX ring's
    ppermute (i -> i - 1): `fddm::ring_shift`, one send and one receive of
    one buffer a hop (`batch_isend_irecv`); point-to-point over gloo goes
    through pinned host memory."""
    return torch.ops.fddm.ring_shift(buf, axis_key(group))
