# -*- coding: utf-8 -*-
"""Non-autoregressive denoising transformer decoder f_theta(x_t, t, c).

Counterpart of `fddm_asr_tpu/models/decoder.py`; parameter names are the
reference `.pt` state_dict's (packed `in_proj_weight` attention,
`ff.0`/`ff.3`, `time_emb.mlp.0`/`.2`, `pos_emb.inv_freq`), so a reference
checkpoint loads with `strict=True`.  Reference quirks kept on purpose:

  * RoPE rotates the FULL d_model embedding BEFORE the q/k projections,
    with the interleaved split
      concat(x_even cos_e - x_odd sin_o, x_even sin_e + x_odd cos_o);
  * post-LayerNorm blocks, no causal mask;
  * FiLM on the masked-mean-pooled raw condition;
  * time embedding freqs = exp(-linspace(log 1, log 10000, d/2)) added to
    every position through a Linear;
  * the pad row of the token embedding is zeroed on the OUTPUT side;
  * a row whose tokens are all pad attends to every position (not NaN).

Parameters stay float32; matmuls run in `dtype`, the head in float32.
LayerNorm eps is 1e-6, the JAX package's.  Dropout (rate `dropout`, the
config's model.dropout) acts in `train()` mode only, at the JAX decoder's
places: the attention weights, each sublayer's output before its residual
add, and the FFN's hidden activation.  The module records no autograd
graph only where its caller says so (the pipeline samples under
`torch.inference_mode`).

`quant_dense="int8"` (model.quant_dense; inference only, raises where
autograd records) runs the denses the JAX decoder quantizes through dynamic
int8 (`ops/quant.int8_matmul`): self- and cross-attention q/k/v/out, `ff.0`,
`ff.3` and the float32 `head`.  Each of q, k and v is its own slice of the
packed `in_proj_weight`, quantized per output channel on its own, as three
separate denses would be.  The time MLP, `time_proj` and FiLM stay full
precision; "int8_fused" raises, as in the JAX decoder.  Parameters and
checkpoints are unchanged.

Tensor parallel (`parallel/tensor.shard_module`): each attention holds its
rank's heads (their q, k and v rows of `in_proj_weight`, their columns of
`out_proj`, whose sum over "model" takes the bias once), the FFN its
columns of `ff.0` and rows of `ff.3`, `tok_emb` its id range and `head` its
vocabulary columns, whose logits are gathered whole before they leave the
module.  FiLM, the time MLP, `time_proj`, the norms and positions stay
whole.

`remat_blocks` (model.remat_blocks) recomputes each block in the backward
of a training forward (torch.utils.checkpoint; dropout draws the same
masks again).  As in the JAX decoder it needs `scan_blocks`, the JAX
package's stacked-parameter layout, which the port reads for that check
only: its blocks are separate modules either way (`convert` unstacks a
`blocks_scan` tree).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fddm_asr_tpu_torch.models.wavlm import _layer_norm, _linear
from fddm_asr_tpu_torch.ops.attention import dot_product_attention
from fddm_asr_tpu_torch.ops.quant import quantized_linear
from fddm_asr_tpu_torch.parallel.tensor import (copy_to_model, gather_from_model,
                                                reduce_from_model)

_LN_EPS = 1e-6


def rope_tables(seq_len: int, inv_freq: torch.Tensor):
    """cos/sin [seq_len, d_model] with emb = concat(f, f), f[l, i] = l * inv_freq[i]."""
    t = torch.arange(seq_len, dtype=torch.float32, device=inv_freq.device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The reference's interleaved rotation; x [..., L, d], cos/sin [L, d]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.cat([x1 * cos[..., 0::2] - x2 * sin[..., 1::2],
                      x1 * sin[..., 0::2] + x2 * cos[..., 1::2]], dim=-1)


def sinusoidal_position_embedding(seq_len: int, d_model: int, max_len: int = 10000,
                                  device=None) -> torch.Tensor:
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * -(math.log(max_len) / d_model))
    pe = torch.zeros(seq_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(pos * div_term)
    pe[:, 1::2] = torch.cos(pos * div_term)
    return pe


def masked_mean_pool(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over time honouring a True=keep mask; a row with no valid frame
    pools to 0 (clamped denominator) instead of NaN."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)


class RoPEEmbedding(nn.Module):
    """Holds the reference's persistent `inv_freq` buffer."""

    def __init__(self, d_model: int, base: float = 10000.0):
        super().__init__()
        self.register_buffer(
            "inv_freq",
            1.0 / (base ** (torch.arange(0, d_model, 2, dtype=torch.float32) / d_model)))


class SinusoidalTimeEmbedding(nn.Module):
    """DDPM-style timestep embedding + 4x MLP with SiLU."""

    def __init__(self, d_model: int, max_steps: int = 10000):
        super().__init__()
        self.d_model = d_model
        self.max_steps = max_steps
        self.mlp = nn.Sequential(nn.Linear(d_model, 4 * d_model), nn.SiLU(),
                                 nn.Linear(4 * d_model, d_model))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if t.dim() == 0:
            t = t[None]
        half = self.d_model // 2
        freqs = torch.exp(-torch.linspace(math.log(1.0), math.log(self.max_steps), half,
                                          dtype=torch.float32, device=t.device))
        args = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([args.sin(), args.cos()], dim=1)
        if self.d_model % 2 == 1:
            emb = F.pad(emb, (0, 1))
        h = F.silu(_linear(self.mlp[0], emb, dtype))
        return _linear(self.mlp[2], h, dtype)


class FiLMLayer(nn.Module):
    """x * (1 + scale(cond)) + shift(cond)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.scale_proj = nn.Linear(d_model, d_model)
        self.shift_proj = nn.Linear(d_model, d_model)

    def forward(self, x, cond, dtype):
        scale = _linear(self.scale_proj, cond, dtype)[:, None, :]
        shift = _linear(self.shift_proj, cond, dtype)[:, None, :]
        return x * (1.0 + scale) + shift


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj) with the
    port's attention: `mask` True=KEEP, masked keys score f32-min."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 quant_dense: str = "none"):
        super().__init__()
        self.nhead = nhead
        self.dropout = dropout
        self.quant_dense = quant_dense
        self._int8_cache = {}  # quantized slices of in_proj_weight, by projection
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, key_mask, dtype):
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        # tensor parallel (`parallel/tensor.py`): this rank's heads, the rows
        # of their q, k and v in the packed in_proj, summed by out_proj
        unit = self.__dict__.get("_tp_unit")
        nhead = self.nhead // unit.size if unit is not None else self.nhead
        if unit is not None:  # each distinct input once
            copies = {}
            for x in (query, key, value):
                if id(x) not in copies:
                    copies[id(x)] = copy_to_model(x, unit)
            query, key, value = (copies[id(x)] for x in (query, key, value))
        d = self.in_proj_weight.shape[0] // 3
        if self.quant_dense != "none":
            q, k, v = (quantized_linear(
                self.quant_dense, self._int8_cache, name, x.to(dtype), self.in_proj_weight,
                self.in_proj_bias, dtype, rows=slice(i * d, (i + 1) * d))
                for i, (name, x) in enumerate((("q", query), ("k", key), ("v", value))))
        else:
            w = self.in_proj_weight.to(dtype)
            b = self.in_proj_bias.to(dtype)
            q = F.linear(query.to(dtype), w[:d], b[:d])
            k = F.linear(key.to(dtype), w[d:2 * d], b[d:2 * d])
            v = F.linear(value.to(dtype), w[2 * d:], b[2 * d:])
        q = q.reshape(B, Lq, nhead, -1)
        k = k.reshape(B, Lk, nhead, -1)
        v = v.reshape(B, Lk, nhead, -1)
        out = dot_product_attention(q, k, v, key_mask=key_mask,
                                    dropout_p=self.dropout if self.training else 0.0)
        out = out.reshape(B, Lq, d)
        return _linear(self.out_proj, out, dtype, self.quant_dense)


class DecoderBlock(nn.Module):
    """Post-LN block: self-attn -> cross-attn -> FiLM -> FFN."""

    def __init__(self, d_model: int, nhead: int, dim_ff: int, use_film: bool,
                 dropout: float = 0.0, quant_dense: str = "none"):
        super().__init__()
        self.dropout = dropout
        self.quant_dense = quant_dense
        self.self_attn = MultiheadAttention(d_model, nhead, dropout, quant_dense)
        self.cross_attn = MultiheadAttention(d_model, nhead, dropout, quant_dense)
        if use_film:
            self.film_layer = FiLMLayer(d_model)
        self.ff = nn.Sequential(nn.Linear(d_model, dim_ff), nn.GELU(), nn.Dropout(dropout),
                                nn.Linear(dim_ff, d_model))
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, x, cond, x_mask, c_mask, rope_cos, rope_sin, dtype):
        if rope_cos is not None:
            q_in = k_in = apply_rotary_pos_emb(x, rope_cos, rope_sin).to(x.dtype)
        else:
            q_in = k_in = x
        def drop(h):
            return F.dropout(h, self.dropout, self.training)

        x = _layer_norm(self.norm1, x + drop(self.self_attn(q_in, k_in, x, x_mask, dtype)),
                        dtype)
        x = _layer_norm(self.norm2, x + drop(self.cross_attn(x, cond, cond, c_mask, dtype)),
                        dtype)
        if hasattr(self, "film_layer"):
            x = self.film_layer(x, masked_mean_pool(cond, c_mask), dtype)
        h = copy_to_model(x, self.ff.__dict__.get("_tp_unit"))
        h = drop(F.gelu(_linear(self.ff[0], h, dtype, self.quant_dense)))
        h = _linear(self.ff[3], h, dtype, self.quant_dense)
        return _layer_norm(self.norm3, x + drop(h), dtype)


class DenoisingTransformerDecoder(nn.Module):
    """f_theta(x_t, t, c) -> logits over x_0 (float32).

    Defaults match the reference constructor: d_model 768, 12 heads, 6
    layers, ff 2048, dropout 0.1, rope positions, FiLM on."""

    def __init__(self, vocab_size: int, d_model: int = 768, nhead: int = 12,
                 num_layers: int = 6, dim_ff: int = 2048, dropout: float = 0.1,
                 max_len: int = 2048,
                 pad_id: int = 0, pos_emb_type: str = "rope", use_film: bool = True,
                 rope_base: float = 10000.0, dtype: torch.dtype = torch.float32,
                 quant_dense: str = "none", scan_blocks: bool = False,
                 remat_blocks: bool = False):
        super().__init__()
        if pos_emb_type not in ("rope", "sinusoidal", "learned"):
            raise ValueError(f"unsupported pos_emb_type: {pos_emb_type}")
        if remat_blocks and not scan_blocks:
            raise ValueError("remat_blocks requires scan_blocks")
        self.remat_blocks = remat_blocks
        if quant_dense not in ("none", "int8"):
            raise ValueError(f"decoder quant_dense={quant_dense!r}: expected 'none' or 'int8'")
        self.quant_dense = quant_dense
        self.d_model = d_model
        self.max_len = max_len
        self.pad_id = pad_id
        self.pos_emb_type = pos_emb_type
        self.dtype = dtype
        self.tok_emb = nn.Embedding(vocab_size, d_model)
        if pos_emb_type == "rope":
            self.pos_emb = RoPEEmbedding(d_model, rope_base)
        elif pos_emb_type == "learned":
            self.pos_emb = nn.Embedding(max_len, d_model)
        self.time_emb = SinusoidalTimeEmbedding(d_model)
        self.time_proj = nn.Linear(d_model, d_model)
        self.blocks = nn.ModuleList(
            DecoderBlock(d_model, nhead, dim_ff, use_film, dropout, quant_dense)
            for _ in range(num_layers))
        self.head = nn.Linear(d_model, vocab_size)
        with torch.no_grad():
            self.tok_emb.weight[pad_id].zero_()

    def forward(self, xt: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                x_mask: Optional[torch.Tensor] = None,
                c_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.dtype
        B, L = xt.shape
        cond = cond.to(dtype)
        vocab = self.tok_emb.__dict__.get("_tp")
        if vocab is None:
            x = F.embedding(xt, self.tok_emb.weight.to(dtype))
        else:  # this rank's id range, zeros elsewhere, summed over "model"
            n = self.tok_emb.weight.shape[0]
            local = xt - vocab.rank * n
            mine = (local >= 0) & (local < n)
            x = F.embedding(local.clamp(0, n - 1), self.tok_emb.weight.to(dtype))
            x = reduce_from_model(x * mine[..., None].to(dtype), vocab)
        # the pad row reads as zero whatever the table holds
        x = x * (xt != self.pad_id)[..., None].to(dtype)

        rope_cos = rope_sin = None
        if self.pos_emb_type == "rope":
            rope_cos, rope_sin = rope_tables(L, self.pos_emb.inv_freq)
        elif self.pos_emb_type == "sinusoidal":
            x = x + sinusoidal_position_embedding(L, self.d_model, self.max_len,
                                                  x.device).to(dtype)[None]
        else:
            x = x + self.pos_emb.weight[:L].to(dtype)[None]

        t_emb = self.time_emb(t, dtype)
        x = x + _linear(self.time_proj, t_emb, dtype)[:, None, :]

        if x_mask is None:
            x_mask = xt != self.pad_id
        # an all-pad row would softmax over nothing: let it see every position
        x_mask = x_mask | ~x_mask.any(dim=-1, keepdim=True)

        remat = self.remat_blocks and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint(block, x, cond, x_mask, c_mask, rope_cos, rope_sin, dtype,
                               use_reentrant=False)
            else:
                x = block(x, cond, x_mask, c_mask, rope_cos, rope_sin, dtype)
        head = self.head.__dict__.get("_tp")
        x = copy_to_model(x.float(), head)
        # vocabulary-parallel head: the logits gathered whole for the loss and
        # the sampler's posterior
        return gather_from_model(_linear(self.head, x, torch.float32, self.quant_dense), head)
