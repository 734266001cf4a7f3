"""Multi-GPU execution: the process group (`distributed`), the ("data",
"model") mesh over it (`mesh`), and the gradient reduction of a data- and
sequence-parallel train step (`reduce_gradients`).

Counterpart of `fddm_asr_tpu/parallel/`.  Tensor parallelism of the decoder
(the JAX package's `_DECODER_RULES`) is not ported (ROADMAP A7 part 2)."""
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

TENSOR_PARALLEL_NOT_PORTED = (
    "a model axis > 1 without sequence parallelism is tensor parallelism of the decoder, "
    "which is not ported yet (ROADMAP A7 part 2); use --mesh data=N, or add --seq-parallel "
    "(model.encoder.seq_parallel: true) for the ring over the model axis")


def gradient_reducer(mesh: Mesh, n_replicated: int):
    """reduce(grads) -> grads of a train step on `mesh`, or None where no
    collective runs (no process group).

    grads[:n_replicated] belong to modules every rank of a "model" ring runs
    whole (the decoder and the heads); the rest to the encoder (or its LoRA
    adapters), whose sequence-parallel forward covers only the rank's frames.
    The encoder's are summed over "model" (each rank holds its frames' part),
    the others left (identical over the ring); then every gradient is
    averaged over "data", in buckets (`distributed.all_reduce_`)."""
    if not mesh.distributed:
        return None
    from fddm_asr_tpu_torch.parallel.distributed import all_reduce_

    data = mesh.shape["data"]

    def reduce(grads):
        if mesh.shape["model"] > 1:
            all_reduce_(grads[n_replicated:], mesh.model_group)
        all_reduce_(grads, mesh.data_group, scale=1.0 / data)
        return grads

    return reduce
