# -*- coding: utf-8 -*-
"""LoRA adapters for parameter-efficient encoder fine-tuning (encoder.lora_rank).

Counterpart of `fddm_asr_tpu/models/lora.py`.  Each targeted `nn.Linear`
of the encoder gets a rank-r pair, merged as

    W_eff = W + scale * (A @ B)^T      (A: [d_in, r], B: [r, d_out];
                                        torch's W is [d_out, d_in])

A and B keep the JAX package's orientation, so its adapters cross over
as they are (`convert.lora_adapters_from_jax`).  The adapter dict is flat,
{"<module name>": {"a": A, "b": B}}, keyed by the port's module names
(`backbone.encoder.layers.3.attention.q_proj`).  `scale` is alpha / rank
(`resolve_scale`, the one place the formula lives).

Targets are the JAX package's regular expressions over its flax parameter
paths: a module is matched through the path its kernel has in the JAX
package's unrolled tree (`jax_path`: `params/backbone/encoder/layers_3/
attention/q_proj/kernel`).  Only `nn.Linear` layers take adapters; a
pattern that matches a convolution's kernel raises.

Three ways to use a merge:
  * `merge_lora(state_dict, adapters, scale)`: a new state_dict, for
    loading a tuned encoder (`pipeline.FDDMPipeline.from_config`);
  * `installed(module, adapters, scale)`: the training step's merge, once
    per step and differentiable in A and B, held across its forward and
    backward: inside the block each targeted layer carries its W_eff
    (`LORA_WEIGHT` in its `__dict__`, which `models/wavlm._linear` reads in
    place of `weight`), so a layer recomputed in the backward (remat) reads
    the same W_eff and no merge is redone; on leaving the block, by an
    error too, every W_eff is dropped;
  * `merged_into(module, adapters, scale)`: W_eff written into the
    parameters in place, the base put back on exit (evaluation).
Neither may run inside an `installed` block (`check_not_installed`): a
W_eff left in place would shadow the weights they write.  Under tensor
parallelism the adapters stay whole on every rank and both merges take
the rank's slice of (A B)^T (`parallel.tensor.lora_slices`): the rows of a
column-parallel layer, the columns of a row-parallel one.

Init follows the LoRA paper, as in the JAX package: A ~ N(0, 1/r), B = 0,
so the merged model is exactly the base at step 0.  `init_lora` draws A
from a `torch.Generator`, whose numbers differ from jax.random's; tests
carry adapters across instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from fddm_asr_tpu_torch.parallel.tensor import full_shape, lora_slices

__all__ = ["DEFAULT_TARGETS", "LORA_WEIGHT", "EncoderAdapters", "resolve_scale", "jax_path",
           "targeted_linears", "init_lora", "merge_lora", "lora_param_count", "adapter_rank",
           "is_adapter_dict", "merged_weight", "is_installed", "check_not_installed",
           "installed", "merged_into"]

Adapters = Dict[str, Dict[str, torch.Tensor]]

# attention projections + FFN of the transformer layers (the conv front-end
# stays frozen), as the JAX package's default
DEFAULT_TARGETS = (
    r".*(q_proj|k_proj|v_proj|out_proj|intermediate_dense|output_dense)/kernel$"
)

# the key in a Linear's __dict__ under which `installed` puts its W_eff
LORA_WEIGHT = "lora_weight"


@dataclasses.dataclass
class EncoderAdapters:
    """An adapter-only encoder checkpoint as read from disk: the adapters and
    the training run's lora_alpha from its sidecar (None when it has none;
    the config's model.encoder.lora_alpha then, else the rank)."""

    adapters: Adapters
    alpha: Optional[float] = None


def resolve_scale(rank: int, alpha=None) -> float:
    """LoRA merge scale alpha / rank (alpha defaults to rank -> 1.0)."""
    return float(rank if alpha is None else alpha) / rank


def jax_path(module_name: str, leaf: str = "kernel") -> str:
    """The JAX package's flax path of a module's `leaf`: "." joins become
    "/", a list index joins its list's name with "_" (`layers.3` ->
    `layers_3`), under the `params` collection."""
    parts: List[str] = []
    for part in module_name.split("."):
        if part.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{part}"
        else:
            parts.append(part)
    return "/".join(["params", *parts, leaf])


def targeted_linears(module: nn.Module, targets: str = DEFAULT_TARGETS
                     ) -> List[Tuple[str, nn.Linear]]:
    """[(name, layer)] of the `nn.Linear` layers whose kernel path matches
    `targets`, in module order; raises when none does, or when a
    convolution's kernel does (the port adapts Linear layers only)."""
    pattern = re.compile(targets)
    out = []
    for name, m in module.named_modules():
        if isinstance(m, nn.Linear) and pattern.match(jax_path(name)):
            out.append((name, m))
        elif isinstance(m, nn.Conv1d) and pattern.match(jax_path(name)):
            raise ValueError(f"lora targets {targets!r} match the convolution {name!r}: the port "
                             "adapts nn.Linear layers only")
    if not out:
        raise ValueError(f"no params matched lora targets {targets!r}")
    return out


def init_lora(module: nn.Module, rank: int, targets: str = DEFAULT_TARGETS,
              generator: Optional[torch.Generator] = None) -> Adapters:
    """{name: {"a": [d_in, r], "b": [r, d_out]}} for every targeted layer,
    float32 on the layer's device: A ~ N(0, 1/r) from `generator`, B = 0."""
    if rank <= 0:
        raise ValueError(f"lora rank must be positive, got {rank}")
    adapters: Adapters = {}
    for name, layer in targeted_linears(module, targets):
        d_out, d_in = full_shape(layer)  # whole on every rank of a tensor-parallel layer
        dev = layer.weight.device
        a = torch.randn(d_in, rank, generator=generator, device=dev) / math.sqrt(rank)
        adapters[name] = {"a": a, "b": torch.zeros(rank, d_out, device=dev)}
    return adapters


def lora_param_count(adapters: Adapters) -> int:
    return sum(t.numel() for ad in adapters.values() for t in ad.values())


def adapter_rank(adapters: Adapters) -> int:
    """The rank r encoded in the adapter shapes (A: [d_in, r])."""
    return int(next(iter(adapters.values()))["a"].shape[-1])


def is_adapter_dict(obj) -> bool:
    """True iff `obj` is a LoRA adapter dict ({"name": {"a", "b"}, ...}):
    what tells an adapter checkpoint from an encoder state_dict."""
    return (isinstance(obj, dict) and len(obj) > 0
            and all(isinstance(v, dict) and set(v) == {"a", "b"} for v in obj.values()))


def merged_weight(weight: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """W + scale * (A @ B)^T, in W's dtype."""
    return weight + scale * (a @ b).t().to(weight.dtype)


def merge_lora(state_dict: Dict[str, torch.Tensor], adapters: Adapters,
               scale: float) -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` whose `{name}.weight` of every adapted layer is
    W + scale * (A @ B)^T; raises when a name is not in it."""
    missing = [n for n in adapters if f"{n}.weight" not in state_dict]
    if missing:
        raise ValueError(f"{len(missing)} adapter paths not found in params (base model "
                         f"mismatch?): {missing[:3]}")
    out = dict(state_dict)
    for name, ad in adapters.items():
        w = state_dict[f"{name}.weight"]
        out[f"{name}.weight"] = merged_weight(w, ad["a"].to(w.device), ad["b"].to(w.device),
                                              scale)
    return out


def _layers(module: nn.Module, adapters: Adapters) -> Iterator[Tuple[nn.Linear, dict]]:
    modules = dict(module.named_modules())
    missing = [n for n in adapters if not isinstance(modules.get(n), nn.Linear)]
    if missing:
        raise ValueError(f"{len(missing)} adapter paths not found in params (base model "
                         f"mismatch?): {missing[:3]}")
    for name, ad in adapters.items():
        yield modules[name], ad


def is_installed(module: nn.Module) -> bool:
    """True iff a layer of `module` carries a W_eff (inside `installed`)."""
    return any(LORA_WEIGHT in m.__dict__ for m in module.modules())


def check_not_installed(module: nn.Module, what: str) -> None:
    """Raise when a layer of `module` carries a W_eff: `what` would run on
    the merged weights of a training step instead of its own."""
    if is_installed(module):
        raise RuntimeError(f"{what} inside lora.installed: the step's merged weights "
                           "W + s (A B)^T would stand in for the layers' own")


@contextlib.contextmanager
def installed(module: nn.Module, adapters: Adapters, scale: float):
    """Every adapted layer of `module` carries its W_eff (differentiable in A
    and B) for the block, read by its forward in place of `weight`; hold it
    across the forward and the backward.  Every W_eff is dropped on exit,
    by an error too.  Blocks do not nest."""
    check_not_installed(module, "lora.installed")
    try:
        for layer, ad in _layers(module, adapters):
            layer.__dict__[LORA_WEIGHT] = merged_weight(layer.weight,
                                                        *lora_slices(layer, ad["a"], ad["b"]),
                                                        scale)
        yield
    finally:
        for m in module.modules():
            m.__dict__.pop(LORA_WEIGHT, None)


@contextlib.contextmanager
def merged_into(module: nn.Module, adapters: Adapters, scale: float):
    """W_eff written into the adapted layers' weights in place for the block
    (so their version counters move, and caches keyed on them, such as the
    int8 weights of `ops/quant.py`, are rebuilt), the base weights copied
    back, bit for bit, on exit.  Raises inside `installed`."""
    check_not_installed(module, "lora.merged_into")
    saved = []
    try:
        with torch.no_grad():
            for layer, ad in _layers(module, adapters):
                base = layer.weight.detach().clone()
                saved.append((layer, base))
                layer.weight.copy_(merged_weight(base, *lora_slices(layer, ad["a"], ad["b"]),
                                                 scale))
        yield
    finally:
        with torch.no_grad():
            for layer, base in saved:
                layer.weight.copy_(base)
