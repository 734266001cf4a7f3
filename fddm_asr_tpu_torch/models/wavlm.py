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
    dropout (attention_dropout > 0) is not ported: the kernels compute
    exact-softmax gradients only, and it raises;
  * SpecAugment: `mask_time_indices` [B, S] replaces frames by the learned
    `masked_spec_embed`, `mask_feature_indices` [B, H] zeroes hidden dims
    (`sample_time_mask` draws either);
  * `freeze_feature_extractor` runs the conv front-end under no_grad;
  * `remat_layers` recomputes layers 1..N-1 in the backward
    (torch.utils.checkpoint); layer 0, which owns `rel_attn_embed`, is kept.

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
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from fddm_asr_tpu_torch.ops.conv_frontend import conv_ln_gelu, kernel_weight
from fddm_asr_tpu_torch.ops.flash_attention import (
    wavlm_gated_attention_heads_packed,
    wavlm_gated_attention_heads_packed_trainable,
)
from fddm_asr_tpu_torch.ops.quant import quantized_linear

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
    attention_dropout: float = 0.1  # training with it > 0 raises (not ported)
    activation_dropout: float = 0.1
    # recompute layers 1..N-1 in the backward ("full"; "dots", which keeps
    # the projections' outputs, is not ported and raises)
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
    dynamic int8 (`ops/quant.py`), the quantized weight kept on the layer."""
    if quant != "none":
        cache = layer.__dict__.setdefault("_int8_cache", {})
        return quantized_linear(quant, cache, "weight", x.to(dtype), layer.weight, layer.bias,
                                dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


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
            w = kernel_weight(self.__dict__.setdefault("_kernel_weight", {}), self.conv.weight,
                              dtype)
            return conv_ln_gelu(x.to(dtype), w, self.conv.bias, ln.weight, ln.bias,
                                self.conv.stride[0], ln.eps, self.gelu_tanh)
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
    rel = memory - context
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
        # ((L, device), [L, L] bucket ids): the table depends on L alone and
        # costs tens of ms on the host at L=1024, so it is built once per
        # length (the JAX package builds it once per traced shape)
        self._buckets = None

    def position_bias(self, L: int, dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        weight = self.rel_attn_embed.weight
        if self._buckets is None or self._buckets[0] != (L, weight.device):
            buckets = torch.from_numpy(relative_position_buckets(
                L, L, cfg.num_buckets, cfg.max_bucket_distance))
            if weight.device.type == "cuda":  # pinned: the copy does not wait for the stream
                buckets = buckets.pin_memory()
            self._buckets = ((L, weight.device), buckets.to(weight.device, non_blocking=True))
        values = F.embedding(self._buckets[1], weight.to(dtype))  # [L, L, H]
        return values.permute(2, 0, 1).contiguous()  # [H, L, L]

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor],
                position_bias: Optional[torch.Tensor], dtype: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, L, _ = x.shape
        H = cfg.num_attention_heads
        if position_bias is None:
            if not hasattr(self, "rel_attn_embed"):
                raise ValueError("first layer must own rel_attn_embed")
            position_bias = self.position_bias(L, dtype)

        # gate from the pre-projection hidden states, in the [B, L, H, dh] view
        rel = _linear(self.gru_rel_pos_linear, x.reshape(B, L, H, -1), dtype)
        gates = torch.sigmoid(rel.reshape(B, L, H, 2, 4).sum(-1))  # [B, L, H, 2]
        const = self.gru_rel_pos_const[0, :, 0, 0]
        gate = gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0  # f32 [B, L, H]
        gate = gate.float().transpose(1, 2).contiguous()             # [B, H, L]

        q = _linear(self.q_proj, x, dtype, cfg.quant_dense)
        k = _linear(self.k_proj, x, dtype, cfg.quant_dense)
        v = _linear(self.v_proj, x, dtype, cfg.quant_dense)
        if self.training and cfg.attention_dropout > 0.0:
            raise NotImplementedError(
                "attention dropout is not ported (the gated-attention kernels compute "
                "exact-softmax gradients); set attention_dropout: 0.0 and regularise "
                "with SpecAugment, as configs/fddm_zhTW_finetune.yaml does")
        if torch.is_grad_enabled():
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

    def forward(self, x, key_mask, position_bias, dtype):
        if self.stable:
            h, position_bias = self.attention(
                _layer_norm(self.layer_norm, x, dtype), key_mask, position_bias, dtype)
            x = x + F.dropout(h, self.hidden_dropout, self.training)
            x = x + self.feed_forward(_layer_norm(self.final_layer_norm, x, dtype), dtype)
            return x, position_bias
        h, position_bias = self.attention(x, key_mask, position_bias, dtype)
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

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
        cfg = self.cfg
        B, S0, _ = x.shape
        pad = (-S0) % max(cfg.seq_pad_multiple, 1)
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
        if remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported (only 'full')")
        position_bias = None
        for i, layer in enumerate(self.layers):
            if remat and i > 0:  # layer 0 owns rel_attn_embed and is kept
                x, position_bias = checkpoint(layer, x, key_mask, position_bias, dtype,
                                              use_reentrant=False)
            else:
                x, position_bias = layer(x, key_mask, position_bias, dtype)
        if cfg.do_stable_layer_norm:
            x = _layer_norm(self.layer_norm, x, dtype)
        return x[:, :S0] if pad else x


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

    def forward(self, input_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                mask_time_indices: Optional[torch.Tensor] = None,
                mask_feature_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        return self.encoder(x, feat_mask, self.dtype)
