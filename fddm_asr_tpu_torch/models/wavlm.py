# -*- coding: utf-8 -*-
"""WavLM in PyTorch — the acoustic backbone c = c_psi(s), frozen or fine-tuned.

Counterpart of `fddm_asr_tpu/models/wavlm.py`.  Parameter names are those of
HuggingFace `transformers.WavLMModel`'s state_dict (with the positional
conv's weight norm folded into a plain `weight`), so converted JAX trees and
HF checkpoints load with `strict=True`.

wavlm-large: hidden 1024, 24 pre-LN layers, 16 heads, ff 4096, conv
front-end of 7 temporal convs (kernels 10,3,3,3,3,2,2, strides 5,2,...,2:
hop 320 samples) with a channel LayerNorm after each.  The relative
position bias is T5-style log-bucketed, embedded per head by layer 0 and
reused by every layer, each gating it with sigmoid gates computed from its
own pre-projection hidden states.

Compute dtype: parameters stay float32; each module casts its weights and
input to `dtype` at call time (the JAX package's flax `dtype=` semantics).
The gate stays float32 and the position bias takes `dtype`, the operand
types of the gated-attention kernels (`ops/flash_attention.py`), through
which every layer's attention goes: the CUDA kernels on a GPU, their plain
version on the CPU.  Where autograd records (training), attention takes the
trainable route (forward with logsumexp, kernel backward); under no_grad or
inference_mode, the inference kernel.

Training mode (`train()`), as the JAX package's `deterministic=False`:
  * dropout at HF's places: feat_proj_dropout after the feature projection,
    hidden_dropout after the positional conv and after each attention and
    FFN output, activation_dropout inside the FFN.  Attention-weight
    dropout (attention_dropout > 0) takes the plain path
    (`ops/flash_attention.wavlm_gated_attention_dropout`), as the JAX
    package takes its XLA path there: the kernels compute exact-softmax
    gradients only.  Its masks come from one seed a layer, drawn from the
    caller's generator (or the device's default one) before the layers
    run, so a layer recomputed in the backward draws the same mask;
  * SpecAugment: `mask_time_indices` [B, S] replaces frames by the learned
    `masked_spec_embed`, `mask_feature_indices` [B, H] zeroes hidden dims
    (`sample_time_mask` draws either);
  * `freeze_feature_extractor` runs the conv front-end under no_grad;
  * `remat_layers` recomputes layers 1..N-1 in the backward
    (torch.utils.checkpoint); layer 0, which owns `rel_attn_embed`, is kept.
    `remat_policy` "full" keeps nothing of a layer; "dots" keeps the outputs
    of its unbatched matmuls (the dense projections: `aten.mm` and
    `aten.addmm`, what JAX's `dots_with_no_batch_dims_saveable` keeps) and
    recomputes the rest, the attention forward (B3 on the card) included;
  * LoRA (`models/lora.py`): inside a `lora.installed` block an adapted
    layer uses its merged weight in place of its own (`_linear`).

Sequence parallelism (`WavLMModel.set_ring`, the JAX package's
`gated_attention_fn` with `ops/ring_attention`): the layers run on one
rank's block of frames, each attention a ring over the group (`Encoder`);
in training it raises on attention dropout, as in the JAX package.

Tensor parallelism (`parallel/tensor.shard_module`): an attention holds its
rank's H / M heads (their q/k/v columns and `out_proj` rows, whose sum over
"model" takes the bias once); its gate applies `gru_rel_pos_linear` to
those heads' slices of x with their `gru_rel_pos_const`, layer 0 embeds
the position bias for them alone, and the kernels run at H / M heads; the
FFN holds its columns of `intermediate_dense` and rows of `output_dense`.
The front-end, the positional conv, the feature projection and the norms
stay whole.

Inference options, as in the JAX package (both raise where autograd records):
  * `quant_dense` "int8" | "int8_fused" runs the q/k/v/out projections and
    the two FFN denses of every layer through dynamic int8 (`ops/quant.py`:
    the library path, or the fused Hopper kernel); the gate's
    `gru_rel_pos_linear`, the feature projection and the encoder's `proj`
    stay full precision.  Parameters and checkpoints are unchanged;
  * `fused_frontend` runs conv layers 1-6 of the "layer"-norm front-end
    through the fused conv+LayerNorm+GELU kernel (`ops/conv_frontend.py`),
    channels-last from layer 0's output on.  The waveform layer (Cin = 1)
    stays on `F.conv1d` + LayerNorm + GELU, as on the TPU it stays on XLA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from fddm_asr_tpu_torch.models.lora import LORA_WEIGHT
from fddm_asr_tpu_torch.ops.conv_frontend import (conv_ln_gelu, kernel_weight,
                                                 kernel_weight_tf32)
from fddm_asr_tpu_torch.ops.flash_attention import (
    wavlm_gated_attention_dropout,
    wavlm_gated_attention_heads_packed,
    wavlm_gated_attention_heads_packed_trainable,
)
from fddm_asr_tpu_torch.ops.quant import quantized_linear, quantized_linear_row_parallel
from fddm_asr_tpu_torch.parallel.tensor import ROW, copy_to_model, reduce_from_model

QUANT_MODES = ("none", "int8", "int8_fused")


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """The fields of HF WavLMConfig the forward pass needs."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Sequence[int] = (512,) * 7
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (large) | "group" (base)
    do_stable_layer_norm: bool = True
    num_buckets: int = 320
    max_bucket_distance: int = 800
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    feat_proj_dropout: float = 0.0
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1  # in training > 0 takes the plain attention (no kernel)
    activation_dropout: float = 0.1
    # recompute layers 1..N-1 in the backward: "full", or "dots" (keep the
    # dense projections' outputs)
    remat_layers: bool = False
    remat_policy: str = "full"
    # fine-tuning: the conv front-end stays frozen (HF freeze_feature_encoder)
    freeze_feature_extractor: bool = False
    # tanh approximation of GELU everywhere (front-end, pos-conv, FFN);
    # off = exact erf, as HF WavLM
    gelu_approx_tanh: bool = False
    # conv layers 1-6 through the fused conv+LayerNorm+GELU kernel ("layer"
    # norm only; inference, or training with freeze_feature_extractor)
    fused_frontend: bool = False
    # q/k/v/out projections and FFN denses through dynamic int8: "none" |
    # "int8" (library product) | "int8_fused" (the fused kernel); inference
    quant_dense: str = "none"
    # pad the frame axis to a multiple of this at encoder entry (zero frames
    # + key mask); real-frame numerics are unchanged
    seq_pad_multiple: int = 1

    def __post_init__(self):
        if self.quant_dense not in QUANT_MODES:
            raise ValueError(f"quant_dense={self.quant_dense!r}: expected 'none', 'int8', or "
                             "'int8_fused'")

    @classmethod
    def large(cls) -> "WavLMConfig":
        return cls()

    @classmethod
    def base(cls) -> "WavLMConfig":
        return cls(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, conv_bias=False, feat_extract_norm="group",
            do_stable_layer_norm=False,
        )

    @classmethod
    def tiny_for_tests(cls) -> "WavLMConfig":
        """Geometry-preserving toy config for fast tests."""
        return cls(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, conv_dim=(16,) * 7,
            num_buckets=32, max_bucket_distance=80,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        )

    @classmethod
    def from_hf(cls, hf_config: dict) -> "WavLMConfig":
        """The fields of an HF WavLM `config.json` (read as a dict) that
        define the network; every one must be present."""
        scalars = ("hidden_size", "num_hidden_layers", "num_attention_heads",
                   "intermediate_size", "conv_bias", "feat_extract_norm",
                   "do_stable_layer_norm", "num_buckets", "max_bucket_distance",
                   "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
                   "layer_norm_eps", "feat_proj_dropout", "hidden_dropout",
                   "attention_dropout", "activation_dropout")
        missing = [k for k in (*scalars, "conv_dim", "conv_kernel", "conv_stride")
                   if k not in hf_config]
        if missing:
            raise KeyError(f"WavLM config.json lacks {missing}")
        return cls(**{k: hf_config[k] for k in scalars},
                   **{k: tuple(hf_config[k]) for k in ("conv_dim", "conv_kernel",
                                                       "conv_stride")})

    def feat_extract_output_length(self, input_length):
        """Conv-stack output length: floor((len - k) / s) + 1 per layer."""
        length = input_length
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length


def _gelu(x: torch.Tensor, tanh: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if tanh else "none")


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
            quant: str = "none") -> torch.Tensor:
    """`layer(x)` in `dtype`; with `quant` "int8" or "int8_fused" through
    dynamic int8 (`ops/quant.py`), the quantized weight kept on the layer.
    Inside a `lora.installed` block its merged LoRA weight stands in for
    `weight`.  A row-parallel layer (`parallel/tensor.py`) takes this rank's
    input features and sums its partial product over "model", then adds the
    bias once."""
    weight = layer.__dict__.get(LORA_WEIGHT, layer.weight)
    row = layer.__dict__.get("_tp")
    if row is not None and row.axis != ROW:
        row = None
    if quant != "none":
        if weight is not layer.weight:
            raise ValueError("quant_dense is for inference: a layer training LoRA adapters "
                             "runs full precision")
        cache = layer.__dict__.setdefault("_int8_cache", {})
        if row is not None:
            return quantized_linear_row_parallel(cache, "weight", x.to(dtype), layer.weight,
                                                 layer.bias, dtype, row.group)
        return quantized_linear(quant, cache, "weight", x.to(dtype), layer.weight, layer.bias,
                                dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if row is not None:
        y = reduce_from_model(F.linear(x.to(dtype), weight.to(dtype)), row)
        return y if bias is None else y + bias
    return F.linear(x.to(dtype), weight.to(dtype), bias)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.to(dtype), ln.normalized_shape, ln.weight.to(dtype),
                        ln.bias.to(dtype), ln.eps)


def _conv(conv: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv1d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class ConvLayer(nn.Module):
    """One temporal conv of the feature encoder with "layer"/"group"/"none" norm."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int,
                 bias: bool, norm: str, eps: float, gelu_tanh: bool, fused: bool = False):
        super().__init__()
        self.conv = nn.Conv1d(in_dim, out_dim, kernel, stride=stride, bias=bias)
        self.norm = norm
        self.gelu_tanh = gelu_tanh
        # the fused kernel's layer: "layer" norm and not the waveform layer
        self.fused = fused and norm == "layer" and in_dim != 1
        if norm == "layer":
            self.layer_norm = nn.LayerNorm(out_dim, eps=eps)
        elif norm == "group":
            # GroupNorm(C, C) == per-channel normalisation over time
            self.layer_norm = nn.GroupNorm(out_dim, out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                channels_last: bool = False) -> torch.Tensor:
        """[B, C, T] -> [B, C', T'], or with `channels_last` (the fused
        front-end's layout) [B, T, C] -> [B, T', C']."""
        if self.fused:
            ln = self.layer_norm
            cache = self.__dict__.setdefault("_kernel_weight", {})
            w = kernel_weight(cache, self.conv.weight, dtype)
            # the float32 kernel's operand (3xTF32), made once per weight like w
            w_tf32 = (kernel_weight_tf32(cache, self.conv.weight)
                      if dtype == torch.float32 and x.is_cuda else None)
            return conv_ln_gelu(x.to(dtype), w, self.conv.bias, ln.weight, ln.bias,
                                self.conv.stride[0], ln.eps, self.gelu_tanh, w_tf32)
        if channels_last:
            x = x.transpose(1, 2)
        x = _conv(self.conv, x, dtype)
        if self.norm == "layer":
            x = _layer_norm(self.layer_norm, x.transpose(1, 2), dtype)
            if not channels_last:
                x = x.transpose(1, 2)
        elif self.norm == "group":
            gn = self.layer_norm
            x = F.group_norm(x, gn.num_groups, gn.weight.to(dtype), gn.bias.to(dtype), gn.eps)
        return _gelu(x, self.gelu_tanh)


class FeatureEncoder(nn.Module):
    """Raw waveform [B, T] -> conv features [B, S, conv_dim[-1]]."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        layers = []
        in_dim = 1
        # the fused front-end runs channels-last throughout ("layer" norm only)
        self.channels_last = cfg.fused_frontend and cfg.feat_extract_norm == "layer"
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            if cfg.feat_extract_norm == "layer":
                norm = "layer"
            else:
                norm = "group" if i == 0 else "none"
            layers.append(ConvLayer(in_dim, dim, k, s, cfg.conv_bias, norm,
                                    cfg.layer_norm_eps, cfg.gelu_approx_tanh,
                                    fused=cfg.fused_frontend))
            in_dim = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wave: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.channels_last:  # [B, T, 1]; layer 0 transposes once, after its conv
            x = wave[:, :, None].to(dtype)
            for layer in self.conv_layers:
                x = layer(x, dtype, channels_last=True)
            return x
        x = wave[:, None, :].to(dtype)  # [B, 1, T]
        for layer in self.conv_layers:
            x = layer(x, dtype)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, dropout: float = 0.0) -> torch.Tensor:
        x = _linear(self.projection, _layer_norm(self.layer_norm, x, dtype), dtype)
        return F.dropout(x, dropout, self.training)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding (weight norm folded into `conv.weight`)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.gelu_tanh = cfg.gelu_approx_tanh

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:  # [B, S, H]
        h = _conv(self.conv, x.transpose(1, 2), dtype)
        if self.conv.kernel_size[0] % 2 == 0:  # SamePad: drop the trailing frame
            h = h[:, :, :-1]
        return _gelu(h, self.gelu_tanh).transpose(1, 2)


def relative_position_buckets(query_len: int, key_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5-style bidirectional log-bucketing of relative positions (HF WavLM's
    `_relative_positions_bucket`), [Lq, Lk] int64."""
    context = np.arange(query_len, dtype=np.int64)[:, None]
    memory = np.arange(key_len, dtype=np.int64)[None, :]
    return _bucket_of(memory - context, num_buckets, max_distance)


def _bucket_of(rel: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """The bucket of each relative position (key - query) in `rel`, int64."""
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    # rel floored at 1 in the log; rows below max_exact take `is_small`
    large = np.log(np.maximum(rel, 1).astype(np.float32) / max_exact) / math.log(
        max_distance / max_exact)
    large = (max_exact + large * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


class GatedRelPosAttention(nn.Module):
    """Self-attention with WavLM's gated relative position bias.

    The layer that owns `rel_attn_embed` (layer 0) computes the [H, L, L]
    bias; later layers receive it and apply their own gates."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        H, D = cfg.num_attention_heads, cfg.hidden_size
        self.cfg = cfg
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.gru_rel_pos_linear = nn.Linear(D // H, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, H)
        # (L, device) -> the buckets of relative positions -(L-1) .. L-1
        # [2L - 1] on the device, built on the host once per length (the JAX
        # package builds them once per traced shape) and kept: a program
        # traced at L holds its length's table as a constant, and a CUDA
        # graph captured at L reads it for as long as the graph lives
        self._relative_buckets = {}
        # fn(q, k, v, position_bias, gate, key_mask) -> [B, L, H, dh] in place
        # of the kernels, q/k/v [B, L, H, dh]: the sequence-parallel ring
        # (`WavLMModel.set_ring`), as the JAX package's `gated_attention_fn`
        self.gated_attention_fn = None

    def relative_buckets(self, L: int, device: torch.device) -> torch.Tensor:
        """The bucket of each relative position -(L-1) .. L-1, [2L - 1] int64
        on `device`.  Built outside a trace: a trace finds it made (see
        `WavLMModel.prepare_position_bias`)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:  # one key for "cuda" and "cuda:0"
            device = torch.device("cuda", torch.cuda.current_device())
        key = (L, device)
        table = self._relative_buckets.get(key)
        if table is None:
            if torch.compiler.is_compiling():
                raise RuntimeError(f"no position-bucket table for L={L} on {device}: build "
                                   "it before tracing (WavLMModel.prepare_position_bias)")
            table = torch.from_numpy(_bucket_of(np.arange(1 - L, L), self.cfg.num_buckets,
                                                self.cfg.max_bucket_distance))
            if device.type == "cuda":  # pinned: the copy does not wait for the stream
                table = table.pin_memory()
            table = table.to(device, non_blocking=True)
            self._relative_buckets[key] = table
        return table

    def position_bias(self, L: int, dtype: torch.dtype,
                      rows: Optional[Tuple[int, int]] = None,
                      heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """[H, L, L]: head h's embedding of bucket(k - q) at (q, k), gathered
        on the device from the [2L - 1] table, (k - q) + L - 1 its index.
        `rows` (first, count): only those query rows, [H, count, L];
        `heads` (first, count): only those heads."""
        weight = self.rel_attn_embed.weight
        if heads is not None:
            weight = weight[:, heads[0]:heads[0] + heads[1]]
        values = F.embedding(self.relative_buckets(L, weight.device), weight.to(dtype))
        pos = torch.arange(L, device=weight.device)
        qpos = pos if rows is None else pos[rows[0]:rows[0] + rows[1]]
        return values.t()[:, pos[None, :] - qpos[:, None] + (L - 1)]  # [H, rows, L]

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor],
                position_bias: Optional[torch.Tensor], dtype: torch.dtype,
                dropout_seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """`dropout_seed`: the seed of this layer's attention-dropout mask
        (training with attention_dropout > 0)."""
        cfg = self.cfg
        B, L, _ = x.shape
        H = cfg.num_attention_heads
        # tensor parallel (`parallel/tensor.py`): this rank's H / M heads
        # [h0, h0 + H): their q/k/v columns, gates and position bias
        unit = self.__dict__.get("_tp_unit")
        h0 = 0
        if unit is not None:
            x = copy_to_model(x, unit)
            H //= unit.size
            h0 = unit.rank * H
        if position_bias is None:
            if not hasattr(self, "rel_attn_embed"):
                raise ValueError("first layer must own rel_attn_embed")
            position_bias = self.position_bias(L, dtype,
                                               heads=None if unit is None else (h0, H))

        # gate from the pre-projection hidden states, in the [B, L, H, dh] view
        xh = x.reshape(B, L, cfg.num_attention_heads, -1)
        if unit is not None:
            xh = xh[:, :, h0:h0 + H]
        rel = _linear(self.gru_rel_pos_linear, xh, dtype)
        gates = torch.sigmoid(rel.reshape(B, L, H, 2, 4).sum(-1))  # [B, L, H, 2]
        const = self.gru_rel_pos_const[0, h0:h0 + H, 0, 0]
        gate = gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0  # f32 [B, L, H]
        gate = gate.float().transpose(1, 2).contiguous()             # [B, H, L]

        q = _linear(self.q_proj, x, dtype, cfg.quant_dense)
        k = _linear(self.k_proj, x, dtype, cfg.quant_dense)
        v = _linear(self.v_proj, x, dtype, cfg.quant_dense)
        if self.gated_attention_fn is not None:
            # exact softmax only: skipping attention dropout would make a
            # sequence-parallel fine-tune train with other regularization than
            # the single-device run it must reproduce
            if self.training and cfg.attention_dropout > 0.0:
                raise ValueError(
                    "sequence-parallel attention (gated_attention_fn) does not implement "
                    "attention dropout; set attention_dropout: 0.0 (regularize with "
                    "SpecAugment, the recommended fine-tune recipe) or disable seq_parallel "
                    "for this run")
            view = (B, L, H, -1)
            out = self.gated_attention_fn(q.reshape(view), k.reshape(view), v.reshape(view),
                                          position_bias, gate, key_mask).reshape(B, L, -1)
        elif self.training and cfg.attention_dropout > 0.0:
            generator = torch.Generator(device=q.device)
            if dropout_seed is None:
                generator.seed()
            else:
                generator.manual_seed(dropout_seed)
            out = wavlm_gated_attention_dropout(q, k, v, position_bias, gate, key_mask, H,
                                                cfg.attention_dropout, generator)
        elif torch.is_grad_enabled():
            out = wavlm_gated_attention_heads_packed_trainable(
                q, k, v, position_bias, gate, key_mask, num_heads=H)
        else:
            out = wavlm_gated_attention_heads_packed(q, k, v, position_bias, gate,
                                                     key_mask, num_heads=H)
        return _linear(self.out_proj, out, dtype, cfg.quant_dense), position_bias


class FeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        x = copy_to_model(x, self.__dict__.get("_tp_unit"))  # tensor parallel: its columns
        h = _gelu(_linear(self.intermediate_dense, x, dtype, cfg.quant_dense),
                  cfg.gelu_approx_tanh)
        h = F.dropout(h, cfg.activation_dropout, self.training)
        h = _linear(self.output_dense, h, dtype, cfg.quant_dense)
        return F.dropout(h, cfg.hidden_dropout, self.training)


class EncoderLayer(nn.Module):
    """Pre-LN (stable, wavlm-large) or post-LN (wavlm-base) transformer layer."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.hidden_dropout = cfg.hidden_dropout
        self.attention = GatedRelPosAttention(cfg, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, key_mask, position_bias, dtype, dropout_seed=None):
        if self.stable:
            h, position_bias = self.attention(
                _layer_norm(self.layer_norm, x, dtype), key_mask, position_bias, dtype,
                dropout_seed)
            x = x + F.dropout(h, self.hidden_dropout, self.training)
            x = x + self.feed_forward(_layer_norm(self.final_layer_norm, x, dtype), dtype)
            return x, position_bias
        h, position_bias = self.attention(x, key_mask, position_bias, dtype, dropout_seed)
        x = _layer_norm(self.layer_norm, x + F.dropout(h, self.hidden_dropout, self.training),
                        dtype)
        x = x + self.feed_forward(x, dtype)
        return _layer_norm(self.final_layer_norm, x, dtype), position_bias


class Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, has_relative_position_bias=(i == 0))
            for i in range(cfg.num_hidden_layers))
        # the sequence-parallel ring's process group (`WavLMModel.set_ring`)
        self.ring = None

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor],
                dtype: torch.dtype, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """`generator`: where training with attention dropout draws each
        layer's mask seed (default: the device's default generator).

        On a ring of n ranks (`self.ring`) the frames pad to a multiple of
        lcm(seq_pad_multiple, n), and after the positional conv (which runs
        whole on every rank) rank r keeps frames [r l, (r + 1) l): its layers
        run on those, their attention over the ring, and the rank's block of
        the padded output is returned (`models/encoder.py` gathers it after
        its projection)."""
        cfg = self.cfg
        B, S0, _ = x.shape
        multiple = max(cfg.seq_pad_multiple, 1)
        if self.ring is not None:
            from fddm_asr_tpu_torch.parallel.distributed import ring_rank

            me, n = ring_rank(self.ring)
            multiple = math.lcm(multiple, n)
        pad = (-S0) % multiple
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            if key_mask is None:
                key_mask = (torch.arange(S0 + pad, device=x.device) < S0).expand(B, -1)
            else:
                key_mask = F.pad(key_mask, (0, pad))
            key_mask = key_mask.contiguous()
        if key_mask is not None:
            x = x.masked_fill(~key_mask[..., None], 0.0)
        x = x + self.pos_conv_embed(x, dtype)
        if not cfg.do_stable_layer_norm:
            x = _layer_norm(self.layer_norm, x, dtype)
        x = F.dropout(x, cfg.hidden_dropout, self.training)
        remat = cfg.remat_layers and self.training and torch.is_grad_enabled()
        if remat and cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be 'full' or 'dots', got {cfg.remat_policy!r}")
        seeds = [None] * len(self.layers)
        if self.training and cfg.attention_dropout > 0.0:
            seeds = torch.randint(0, 2 ** 62, (len(self.layers),), generator=generator,
                                  device=x.device if generator is None else generator.device
                                  ).tolist()
        position_bias = None
        if self.ring is not None:
            L = x.shape[1]
            l = L // n
            x = x[:, me * l:(me + 1) * l]
            if key_mask is not None:
                key_mask = key_mask[:, me * l:(me + 1) * l].contiguous()
            position_bias = self.layers[0].attention.position_bias(L, dtype, rows=(me * l, l))
        for i, layer in enumerate(self.layers):
            if remat and i > 0:  # layer 0 owns rel_attn_embed and is kept
                x, position_bias = checkpoint(layer, x, key_mask, position_bias, dtype, seeds[i],
                                              use_reentrant=False,
                                              context_fn=REMAT_POLICIES[cfg.remat_policy])
            else:
                x, position_bias = layer(x, key_mask, position_bias, dtype, seeds[i])
        if cfg.do_stable_layer_norm:
            x = _layer_norm(self.layer_norm, x, dtype)
        if self.ring is not None:
            return x
        return x[:, :S0] if pad else x


# unbatched matmuls: the outputs `remat_policy: dots` keeps (F.linear on a
# [B, L, d] input runs one of these on the [B*L, d] view)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _keep_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_keep_dots)


# remat_policy -> torch.utils.checkpoint's context_fn
REMAT_POLICIES = {"full": noop_context_fn, "dots": _dots_contexts}


def sample_time_mask(batch: int, seq_len: int, mask_prob: float, mask_length: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """SpecAugment span masks [B, seq_len] bool (True = masked).

    round(mask_prob * seq_len / mask_length) spans per row (at least one),
    each of `mask_length` positions from a uniform start in
    [0, seq_len - mask_length]; spans may overlap.  The JAX package's
    static-shape equivalent of HF's `_compute_mask_indices`; the draws come
    from `generator` (they cannot match jax.random's)."""
    n_spans = max(1, round(mask_prob * seq_len / mask_length))
    starts = torch.randint(0, max(1, seq_len - mask_length + 1), (batch, n_spans),
                           generator=generator, device=device)
    idx = (starts[..., None] + torch.arange(mask_length, device=device)).reshape(batch, -1)
    # spans run past the end only when seq_len < mask_length; those positions
    # land in the margin and are cut off, as JAX's scatter drops them
    mask = torch.zeros(batch, seq_len + mask_length, dtype=torch.bool, device=device)
    return mask.scatter_(1, idx, True)[:, :seq_len].contiguous()


class WavLMModel(nn.Module):
    """Waveform [B, T] (+ optional sample-level mask) -> hidden states [B, S, H].

    HF WavLMModel.forward; in `train()` mode with dropout and the SpecAugment
    masks (`mask_time_indices` frames take `masked_spec_embed`,
    `mask_feature_indices` hidden dims are zeroed)."""

    def __init__(self, cfg: WavLMConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.masked_spec_embed = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.encoder = Encoder(cfg)

    def set_ring(self, group) -> None:
        """Run the encoder's layers sequence-parallel over the ranks of
        `group` (`ops/ring_attention.py`), or on the whole sequence again
        (None).  On a ring `forward` returns this rank's block of the frames
        padded to the ring (`Encoder.forward`)."""
        from fddm_asr_tpu_torch.ops.ring_attention import ring_gated_attention

        self.encoder.ring = group
        fn = None if group is None else functools.partial(ring_gated_attention, group=group)
        for layer in self.encoder.layers:
            layer.attention.gated_attention_fn = fn

    def prepare_position_bias(self, num_samples: int, device) -> None:
        """Build the position-bucket table of `num_samples`-sample inputs (the
        front-end's frames padded to `seq_pad_multiple`, on a ring to its
        lcm with the ring's size) on `device` ahead of a trace, which records
        it as a constant."""
        m = max(self.cfg.seq_pad_multiple, 1)
        if self.encoder.ring is not None:
            from fddm_asr_tpu_torch.parallel.distributed import ring_rank

            m = math.lcm(m, ring_rank(self.encoder.ring)[1])
        L = -(-self.cfg.feat_extract_output_length(num_samples) // m) * m
        self.encoder.layers[0].attention.relative_buckets(L, device)

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                mask_time_indices: Optional[torch.Tensor] = None,
                mask_feature_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        with torch.no_grad() if cfg.freeze_feature_extractor else contextlib.nullcontext():
            feats = self.feature_extractor(input_values, self.dtype)
        S = feats.shape[1]
        feat_mask = None
        if attention_mask is not None:
            lengths = attention_mask.long().sum(-1)
            out_lengths = self.cfg.feat_extract_output_length(lengths)
            feat_mask = torch.arange(S, device=feats.device)[None, :] < out_lengths[:, None]
        x = self.feature_projection(feats, self.dtype, cfg.feat_proj_dropout)
        if mask_time_indices is not None:
            x = torch.where(mask_time_indices[..., None], self.masked_spec_embed.to(x.dtype), x)
        if mask_feature_indices is not None:
            x = x.masked_fill(mask_feature_indices[:, None, :], 0.0)
        return self.encoder(x, feat_mask, self.dtype, generator)
