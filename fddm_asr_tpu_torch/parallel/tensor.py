# -*- coding: utf-8 -*-
"""Tensor parallelism: the weights of `_DECODER_RULES`, sliced over the
mesh's "model" ranks, and the collectives that stitch their outputs.

Counterpart of `fddm_asr_tpu/parallel/mesh.py:67-155` (`_DECODER_RULES`,
`decoder_param_spec`, `shard_pytree`).  JAX places a sharded leaf and GSPMD
inserts the collectives; here a process drives one GPU, so a rank holds
its slice of each sharded weight and the layers call the collectives
themselves (Megatron's column- and row-parallel layers):

  * column-parallel (output features): q/k/v of the decoder's self- and
    cross-attention (the rows of its packed `in_proj_weight` that belong to
    the rank's heads) and of WavLM's attention, the FFNs' first dense
    (`ff.0`, `intermediate_dense`) and the decoder's `head` (the vocabulary
    columns of the logits, gathered whole before anything reads them);
  * row-parallel (input features): the attention's `out_proj` and the FFNs'
    second dense (`ff.3`, `output_dense`): the rank's partial product is
    summed over "model", the bias added once after the sum;
  * vocabulary-parallel rows: `tok_emb`, each rank looking up its id range
    (zeros elsewhere) before the sum, which is exact.

Everything else stays whole on every rank.  A weight whose sharded axis
does not divide by the model axis stays whole, as `shard_pytree` leaves
it; an attention layer shards only when its head count divides, and then
its q/k/v, out_proj and gate together, an FFN only when its width does.

Gradients (`parameter_kinds`): a sharded weight's gradient is complete on
its rank; a whole one that every rank uses whole gets the same gradient
on each (the input of a column-parallel group passes `copy_to_model`,
whose backward sums the partial input gradients); a whole tensor that a
rank uses only in part -- WavLM's `rel_attn_embed` and `gru_rel_pos_*` of
a sharded attention (the rank's heads) and the LoRA adapters of a sharded
layer (`lora_slices`) -- holds the rank's part and is summed over "model"
(`parallel.gradient_reducer`).

`shard_module` slices a built module's parameters in place, keeping their
names, so loaders, checkpoints and LoRA find them; `gather_state` rebuilds
the full tensors on every rank and `local_state` cuts a full state_dict
to a rank's slices.  Collectives go through
`parallel/distributed.py`, so a gloo group stages CUDA tensors through
pinned host memory (`STAGING`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from fddm_asr_tpu_torch.parallel.distributed import _all_reduce_flat, all_gather, gather

__all__ = ["COLUMN", "ROW", "HEADS", "VOCAB", "RULES", "Shard", "param_axis", "shard_plan",
           "shard_module", "gather_state", "gather_tensor", "local_tensor", "local_state",
           "parameter_kinds", "sharded_axes", "copy_to_model", "reduce_from_model",
           "gather_from_model", "lora_slices", "is_sharded", "full_shape",
           "sync_default_generators"]

COLUMN = "column"  # dim 0 of a [dout, din] weight and its bias: output features
ROW = "row"        # dim 1 of a [dout, din] weight: input features
HEADS = "heads"    # dim 0 of a packed [3 d, d] in_proj, in each of its q, k, v thirds
VOCAB = "vocab"    # dim 0 of an embedding table: its rows (token ids)

# The port's `_DECODER_RULES`, over parameter names of the decoder
# (`DenoisingTransformerDecoder`) and the encoder (`AcousticEncoder`); first
# hit wins, no hit: whole.
RULES = (
    (re.compile(r"(.*\.)?(self_attn|cross_attn)\.in_proj_(weight|bias)$"), HEADS),
    (re.compile(r"(.*\.)?attention\.(q_proj|k_proj|v_proj)\.(weight|bias)$"), COLUMN),
    (re.compile(r"(.*\.)?(self_attn|cross_attn|attention)\.out_proj\.weight$"), ROW),
    (re.compile(r"(.*\.)?(ff\.0|intermediate_dense)\.(weight|bias)$"), COLUMN),
    (re.compile(r"(.*\.)?(ff\.3|output_dense)\.weight$"), ROW),
    (re.compile(r"(.*\.)?head\.(weight|bias)$"), COLUMN),
    (re.compile(r"(.*\.)?tok_emb\.weight$"), VOCAB),
)
# whole tensors of a sharded attention that a rank uses for its heads only
_PARTIAL = re.compile(
    r"(.*\.)?attention\.(gru_rel_pos_linear\.(weight|bias)|gru_rel_pos_const|"
    r"rel_attn_embed\.weight)$")
# the module whose width decides whether a parameter shards: (pattern, the
# unit's name within the parameter's name)
_UNITS = (
    re.compile(r"^((.*\.)?(self_attn|cross_attn|attention))\."),
    re.compile(r"^((.*\.)?(ff|feed_forward))\."),
    re.compile(r"^((.*\.)?)(head|tok_emb)\."),
)
_DIM = {COLUMN: 0, ROW: 1, HEADS: 0, VOCAB: 0}


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a module is split: `axis` (COLUMN, ROW, HEADS or VOCAB), and this
    rank's place in the "model" group.  A sliced layer keeps its Shard in
    `__dict__["_tp"]`; an attention or FFN whose layers are sliced keeps one
    in `__dict__["_tp_unit"]` (the group its input is copied to)."""

    axis: str
    group: Any
    rank: int
    size: int


def param_axis(name: str) -> Optional[str]:
    """The axis the rules shard parameter `name` on, None (whole)."""
    for pattern, axis in RULES:
        if pattern.match(name):
            return axis
    return None


def _unit(name: str) -> Optional[str]:
    """The name of the attention, FFN or vocabulary unit a parameter of the
    rules (or a partial one) belongs to; "" is the root module."""
    for i, pattern in enumerate(_UNITS):
        m = pattern.match(name)
        if m:
            return m.group(1).rstrip(".") if i < 2 else "vocab:" + m.group(1).rstrip(".")
    return None


def _unit_width(root: nn.Module, unit: str) -> int:
    """What must divide by the model axis for `unit` to shard: heads, FFN
    width or vocabulary size."""
    if unit.startswith("vocab:"):
        prefix = unit[len("vocab:"):]
        module = root.get_submodule(prefix) if prefix else root
        return module.tok_emb.num_embeddings
    module = root.get_submodule(unit)
    if hasattr(module, "nhead"):  # the decoder's MultiheadAttention
        return module.nhead
    if hasattr(module, "cfg") and hasattr(module, "q_proj"):  # WavLM's attention
        return module.cfg.num_attention_heads
    first = module[0] if isinstance(module, nn.Sequential) else module.intermediate_dense
    return first.out_features


def shard_plan(module: nn.Module, size: int) -> Dict[str, str]:
    """{parameter name: axis} of what `shard_module` slices over `size`
    model ranks: the rules' parameters whose unit's width divides."""
    if size <= 1:
        return {}
    widths: Dict[str, int] = {}
    plan = {}
    for name, _ in module.named_parameters():
        axis = param_axis(name)
        if axis is None:
            continue
        unit = _unit(name)
        if unit not in widths:
            widths[unit] = _unit_width(module, unit)
        if widths[unit] % size == 0:
            plan[name] = axis
    return plan


def local_tensor(full: torch.Tensor, axis: str, rank: int, size: int) -> torch.Tensor:
    """This rank's slice of a full tensor of `axis` (a contiguous copy)."""
    if axis == HEADS:
        parts = full.reshape(3, full.shape[0] // 3, *full.shape[1:])
        n = parts.shape[1] // size
        return parts[:, rank * n:(rank + 1) * n].reshape(-1, *full.shape[1:]).contiguous()
    dim = _DIM[axis] if full.dim() > 1 else 0
    n = full.shape[dim] // size
    return full.narrow(dim, rank * n, n).contiguous()


def gather_tensor(t: torch.Tensor, axis: str, group) -> torch.Tensor:
    """The full tensor of the ranks' slices `t` of `axis` (every rank)."""
    if axis == HEADS:
        parts = t.reshape(3, t.shape[0] // 3, *t.shape[1:])
        return all_gather(parts, group, dim=1).reshape(-1, *t.shape[1:])
    return all_gather(t, group, dim=_DIM[axis] if t.dim() > 1 else 0)


def _mark(root: nn.Module, name: str, shard: Shard, key: str = "_tp") -> None:
    # in __dict__: read without nn.Module's attribute fallback on every call
    root.get_submodule(name).__dict__[key] = shard


def shard_module(module: nn.Module, mesh) -> bool:
    """Slice `module`'s parameters of `shard_plan` to this rank's part in
    place (the same Parameter objects, same names) and mark the layers that
    call collectives.  False (nothing changed) on a one-wide model axis;
    raises without a process group, or on a module sharded already."""
    size = mesh.shape["model"]
    if size <= 1:
        return False
    if not mesh.distributed:
        raise ValueError("tensor parallelism needs a process group: join one "
                         "(parallel.initialize) and build the mesh over it (make_mesh)")
    if is_sharded(module):
        raise ValueError("the module is tensor-parallel already")
    group, rank = mesh.model_group, mesh.model_rank
    plan = shard_plan(module, size)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, axis in plan.items():
            p = params[name]
            p.data = local_tensor(p.data, axis, rank, size)
    units = {_unit(name) for name in plan}
    for name, axis in plan.items():
        owner = name.rsplit(".", 1)[0]
        _mark(module, owner, Shard(axis, group, rank, size))
    for unit in units:
        if not unit.startswith("vocab:"):  # the attention or FFN: its input's copy
            _mark(module, unit, Shard(COLUMN, group, rank, size), "_tp_unit")
    module.__dict__["_tp_root"] = Shard("", group, rank, size)
    return True


def is_sharded(module: nn.Module) -> bool:
    """True once `shard_module` has sliced `module`."""
    return "_tp_root" in module.__dict__


def sharded_axes(module: nn.Module) -> Dict[str, Tuple[str, Shard]]:
    """{parameter name: (axis, its Shard)} of the sliced parameters."""
    out = {}
    for name, _ in module.named_parameters():
        axis = param_axis(name)
        if axis is None:
            continue
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        shard = owner.__dict__.get("_tp")
        if shard is not None and shard.axis == axis:
            out[name] = (axis, shard)
    return out


def parameter_kinds(module: nn.Module) -> Dict[str, str]:
    """{parameter name: "sharded" | "partial"} (module docstring); a name
    not in it is whole and used whole on every rank."""
    out = {name: "sharded" for name in sharded_axes(module)}
    for name, _ in module.named_parameters():
        if _PARTIAL.match(name):
            unit = module.get_submodule(_unit(name))
            if "_tp_unit" in unit.__dict__:
                out[name] = "partial"
    return out


def gather_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every sliced tensor gathered whole (a
    collective over "model": every rank of the group calls it); the
    state_dict itself for a module that is not sharded."""
    axes = sharded_axes(module)
    out = {}
    for name, t in module.state_dict().items():
        if name in axes:
            axis, shard = axes[name]
            t = gather_tensor(t.detach(), axis, shard.group)
        out[name] = t
    return out


def local_state(module, full: Dict[str, torch.Tensor], rank: Optional[int] = None,
                size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A full state_dict (one process's, a checkpoint's, an artifact's) cut
    to what this rank holds, for `load_state_dict` or a program's inputs.
    `module`: the sharded module, or {name: axis} of the sliced tensors
    (an artifact records it) with this rank's `rank` of `size` in "model"."""
    if isinstance(module, nn.Module):
        axes = {name: (axis, shard.rank, shard.size)
                for name, (axis, shard) in sharded_axes(module).items()}
    else:
        axes = {name: (axis, rank, size) for name, axis in module.items()}
    out = dict(full)
    for name, (axis, r, n) in axes.items():
        if name in out:
            out[name] = local_tensor(out[name], axis, r, n)
    return out


# ------------------------------------------------------------- the collectives
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_flat(grad, ctx.group, dist.ReduceOp.SUM), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the group forward; the gradient as it is backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_flat(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _records(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The input of a column-parallel group (whole on every rank): itself,
    its gradient summed over "model" in the backward."""
    if shard is None or not _records(x):
        return x
    return _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The sum over "model" of the ranks' partial outputs `x`
    (`fddm::all_reduce`, in a new tensor)."""
    if shard is None:
        return x
    if _records(x):
        return _ReduceFromModel.apply(x, shard.group)
    return _all_reduce_flat(x, shard.group, dist.ReduceOp.SUM)


def gather_from_model(x: torch.Tensor, shard: Optional[Shard], dim: int = -1) -> torch.Tensor:
    """The ranks' column slices `x` gathered whole along `dim`; the backward
    hands each rank its own columns of the (identical) whole gradient."""
    if shard is None:
        return x
    return gather(x.contiguous(), shard.group, dim=dim % x.dim(), sum_grads=False)


def lora_slices(layer: nn.Module, a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parts of a whole adapter pair (A [din, r], B [r, dout]) whose
    product (A B)^T is this rank's slice of a sharded layer's weight: B's
    columns of a column-parallel layer, A's rows of a row-parallel one."""
    shard = layer.__dict__.get("_tp")
    if shard is None:
        return a, b
    if shard.axis == COLUMN:
        n = layer.weight.shape[0]
        return a, b[:, shard.rank * n:(shard.rank + 1) * n]
    n = layer.weight.shape[1]
    return a[shard.rank * n:(shard.rank + 1) * n], b


def full_shape(layer: nn.Module) -> Tuple[int, ...]:
    """The shape of `layer.weight` whole, as one process holds it."""
    shape = list(layer.weight.shape)
    shard = layer.__dict__.get("_tp")
    if shard is not None:
        shape[_DIM[shard.axis]] *= shard.size
    return tuple(shape)


def sync_default_generators(mesh) -> None:
    """Every "model" rank takes its group's first rank's default generator
    states (CPU, and the current CUDA device's), so dropout of whole
    activations draws the same masks on each and the replicas stay equal."""
    if mesh.shape["model"] <= 1 or not mesh.distributed:
        return
    from fddm_asr_tpu_torch.parallel.distributed import broadcast_object

    src = dist.get_global_rank(mesh.model_group, 0)
    states = {"cpu": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states["cuda"] = torch.cuda.get_rng_state()
    states = broadcast_object(states, src=src, group=mesh.model_group)
    torch.set_rng_state(states["cpu"])
    if "cuda" in states:
        torch.cuda.set_rng_state(states["cuda"])
