# -*- coding: utf-8 -*-
"""Scaled dot-product attention with a key mask (the decoder's attention).

Counterpart of `fddm_asr_tpu/ops/attention.py`.  Masked keys score float32
min rather than -inf: exp(min - max) underflows to exactly 0 for any row with
a valid key, while a row with no valid key becomes a uniform average instead
of NaN (audio shorter than 400 samples has zero conv frames, and a NaN there
would spread through the batch by LayerNorm).

Attention-weight dropout (rate `dropout_p`, after the softmax, as torch's
MultiheadAttention places it) runs only when the caller passes a rate above 0.

Shapes: q [B, Lq, H, dh]; k, v [B, Lk, H, dh] -> out [B, Lq, H, dh].
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = torch.finfo(torch.float32).min


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,  # [B, Lk] True=keep
    dropout_p: float = 0.0,
) -> torch.Tensor:
    dh = q.shape[-1]
    # [B, H, Lq, Lk] scores in f32 for a stable softmax
    scores = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float())
    scores = scores * (1.0 / dh ** 0.5)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, None, :], _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0:
        weights = torch.nn.functional.dropout(weights, dropout_p)
    weights = weights.to(v.dtype)
    return torch.matmul(weights, v.transpose(1, 2)).transpose(1, 2)
