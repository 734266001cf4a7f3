# -*- coding: utf-8 -*-
"""Training losses besides the diffusion KL (which is in `diffusion.py`).

Counterpart of `fddm_asr_tpu/losses.py`: `lfd_loss`, the Barlow-Twins-style
cross-modal feature decorrelation L_fd (paper section 3.2), and
`align_speech_to_text`, which cuts or edge-pads the speech axis to the text
length before it."""
from __future__ import annotations

import torch


def _standardize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Standardise along the batch axis (per position, per channel), biased var."""
    mean = x.mean(dim=0, keepdim=True)
    var = x.var(dim=0, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def lfd_loss(z_a: torch.Tensor, z_b: torch.Tensor, lambda_offdiag: float = 5.0e-3,
             eps: float = 1e-5) -> torch.Tensor:
    """L_fd = sum_j (1 - C_jj)^2 + lambda sum_{j != k} C_jk^2, with
    C = Za~^T Zb~ / (B T) over batch-standardised, token-flattened features
    z_a (speech) and z_b (text), each [B, T, D]; float32."""
    B, T, D = z_a.shape
    za = _standardize(z_a.float(), eps).reshape(B * T, D)
    zb = _standardize(z_b.float(), eps).reshape(B * T, D)
    C = (za.T @ zb) / (B * T)
    diag = torch.diagonal(C)
    loss_diag = ((1.0 - diag) ** 2).sum()
    loss_off = (C ** 2).sum() - (diag ** 2).sum()
    return loss_diag + lambda_offdiag * loss_off


def align_speech_to_text(z_speech: torch.Tensor, L: int) -> torch.Tensor:
    """Truncate or edge-pad the speech axis of [B, S, D] to length L."""
    S = z_speech.shape[1]
    if S >= L:
        return z_speech[:, :L, :]
    return torch.cat([z_speech, z_speech[:, -1:, :].expand(-1, L - S, -1)], dim=1)
