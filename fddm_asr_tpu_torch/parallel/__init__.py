"""Multi-GPU execution: the process group (`distributed`), the ("data",
"model") mesh over it (`mesh`), tensor parallelism over its "model" ranks
(`tensor`, the JAX package's `_DECODER_RULES`), and the gradient reduction
and norm of a data-, sequence- or tensor-parallel train step
(`gradient_reducer`, `gradient_norm`).

Counterpart of `fddm_asr_tpu/parallel/`."""
from typing import Callable, List, Optional, Sequence

import torch

from fddm_asr_tpu_torch.parallel.distributed import (  # noqa: F401
    STAGING,
    DistributedConfig,
    all_hosts_mean,
    all_hosts_weighted_mean,
    barrier,
    broadcast_object,
    gather,
    host_shard,
    initialize,
    is_primary,
    process_group,
    shutdown,
)
from fddm_asr_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh, parse_mesh  # noqa: F401


def gradient_reducer(mesh: Mesh, summed: Sequence[int]):
    """reduce(grads) -> grads of a train step on `mesh`, or None where no
    collective runs (no process group).

    grads[i] for i in `summed` hold this rank's part of a tensor's gradient
    and are summed over "model" first: under sequence parallelism the
    encoder's (or its LoRA adapters'), whose forward covers the rank's
    frames only; under tensor parallelism the whole tensors a rank uses in
    part (`tensor.parameter_kinds`: "partial", and the adapters of sliced
    layers).  The rest are either a rank's slice, complete, or the same on
    every "model" rank.  Then every gradient is averaged over "data", in
    buckets (`distributed.all_reduce_`)."""
    if not mesh.distributed:
        return None
    from fddm_asr_tpu_torch.parallel.distributed import all_reduce_

    data = mesh.shape["data"]
    summed = list(summed)

    def reduce(grads):
        if mesh.shape["model"] > 1 and summed:
            all_reduce_([grads[i] for i in summed], mesh.model_group)
        all_reduce_(grads, mesh.data_group, scale=1.0 / data)
        return grads

    return reduce


def gradient_norm(mesh: Mesh, sharded: Sequence[int]
                  ) -> Optional[Callable[[List[torch.Tensor]], torch.Tensor]]:
    """norm(grads) -> the global norm of the whole model's gradients under
    tensor parallelism: the squares of the sliced gradients (`sharded`
    indices) summed over "model", every other gradient (the same on each
    "model" rank) counted once.  None where no slice exists."""
    sharded = set(sharded)
    if not mesh.distributed or mesh.shape["model"] <= 1 or not sharded:
        return None
    from fddm_asr_tpu_torch.parallel.distributed import _all_reduce_flat

    def norm(grads):
        squares = torch.stack(torch._foreach_norm(grads)).float().square()
        mine = torch.zeros_like(squares, dtype=torch.bool)
        mine[sorted(sharded)] = True
        part = _all_reduce_flat(squares[mine].sum().reshape(1), mesh.model_group,
                                torch.distributed.ReduceOp.SUM)
        return (part[0] + squares[~mine].sum()).sqrt()

    return norm
