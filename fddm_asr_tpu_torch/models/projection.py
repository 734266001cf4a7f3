# -*- coding: utf-8 -*-
"""Projection heads of the L_fd cross-modal decorrelation loss.

Counterpart of `fddm_asr_tpu/models/projection.py`, with the reference
`.pt` parameter names (`proj.net.0.weight`, ...): `SpeechProjector` h_a
[B, S, d_in] -> [B, S, d_proj], `TextEmbedding` g (a bias-free Linear over
softmax(logits), a soft embedding of the predicted x_0 distribution) and
`TextProjector` h_b.  Parameters stay float32; the Linears run in `dtype`."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fddm_asr_tpu_torch.models.wavlm import _linear


class MLP(nn.Module):
    """A Linear, or Linear -> GELU (exact) / ReLU -> Linear with `hidden` > 0."""

    def __init__(self, dim_in: int, dim_out: int, hidden: int = 0, act: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if hidden > 0:
            self.net = nn.Sequential(nn.Linear(dim_in, hidden),
                                     nn.GELU() if act == "gelu" else nn.ReLU(),
                                     nn.Linear(hidden, dim_out))
        else:
            self.net = nn.Sequential(nn.Linear(dim_in, dim_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _linear(self.net[0], x, self.dtype)
        if len(self.net) == 1:
            return x
        x = F.gelu(x) if isinstance(self.net[1], nn.GELU) else F.relu(x)
        return _linear(self.net[2], x, self.dtype)


class SpeechProjector(nn.Module):
    """h_phi_a: [B, S, d_in] -> [B, S, d_proj]."""

    def __init__(self, d_in: int, d_proj: int, hidden: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = MLP(d_in, d_proj, hidden, dtype=dtype)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.proj(c)


class TextEmbedding(nn.Module):
    """g_omega: bias-free Linear over softmax(logits) (the JAX module's mode
    "logits", the only one the training step uses)."""

    def __init__(self, vocab_size: int, d_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(vocab_size, d_out, bias=False)

    def forward(self, logits: torch.Tensor) -> torch.Tensor:
        return _linear(self.proj, torch.softmax(logits, dim=-1), self.dtype)


class TextProjector(nn.Module):
    """h_phi_b: [B, L, d_in] -> [B, L, d_proj]."""

    def __init__(self, d_in: int, d_proj: int, hidden: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = MLP(d_in, d_proj, hidden, dtype=dtype)

    def forward(self, z_text: torch.Tensor) -> torch.Tensor:
        return self.proj(z_text)
