# -*- coding: utf-8 -*-
"""AcousticEncoder: WavLM backbone (frozen or fine-tuned) + projection to d_model.

Counterpart of `fddm_asr_tpu/models/encoder.py`:
  * `freeze` (model.encoder.freeze, default True) stops the gradient: a
    frozen encoder runs under no_grad, a fine-tuned one records autograd
    and takes the SpecAugment masks through to the backbone;
  * a `proj` Linear applied only when hidden_size != d_model;
  * `feat_mask` from ceil(samples / 320) clamped to the frame count (the
    reference's estimate; WavLM's own key mask uses the exact conv formula);
  * optional masked mean pooling;
  * on a sequence-parallel ring (`WavLMModel.set_ring`) the backbone and the
    projection run on this rank's frames, gathered whole at the end: every
    encoder parameter's gradient then covers this rank's frames only, and
    the train step sums them over the ring.
"""
from __future__ import annotations

from typing import Optional, Tuple

import contextlib

import torch
from torch import nn

from fddm_asr_tpu_torch.models.wavlm import WavLMConfig, WavLMModel, _linear

WAVLM_HOP = 320  # samples per output frame


def frame_length_estimate(sample_lengths: torch.Tensor) -> torch.Tensor:
    """ceil(samples / 320) — the reference's conservative frame count."""
    return (sample_lengths + WAVLM_HOP - 1) // WAVLM_HOP


class AcousticEncoder(nn.Module):
    """Waveform [B, T] -> (feats [B, S, d_model], feat_mask [B, S] | None, pooled | None)."""

    def __init__(self, config: WavLMConfig, d_model: int = 768, proj: str = "linear",
                 pooling: str = "none", freeze: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.pooling = pooling
        self.freeze = freeze
        self.backbone = WavLMModel(config, dtype)
        if proj == "linear" and config.hidden_size != d_model:
            self.proj = nn.Linear(config.hidden_size, d_model)

    def forward(self, waveforms: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                mask_time_indices: Optional[torch.Tensor] = None,
                mask_feature_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """`generator`: where attention dropout in training draws (WavLMModel)."""
        B, T = waveforms.shape
        attention_mask = None
        if lengths is not None:
            attention_mask = torch.arange(T, device=waveforms.device)[None, :] < lengths[:, None]
        # frozen: nothing upstream of the condition trains, so the whole
        # encoder (the projection too) runs without recording autograd (a
        # no-op switch is left out: `torch.export` splits its program there)
        frozen = self.freeze and torch.is_grad_enabled()
        with torch.no_grad() if frozen else contextlib.nullcontext():
            feats = self.backbone(waveforms, attention_mask=attention_mask,
                                  mask_time_indices=mask_time_indices,
                                  mask_feature_indices=mask_feature_indices,
                                  generator=generator)
            if hasattr(self, "proj"):
                feats = _linear(self.proj, feats, self.dtype)
            ring = self.backbone.encoder.ring
            if ring is not None:
                # sequence parallel: this rank's frames, gathered whole for the
                # consumer, which runs replicated on the ring, so the backward
                # hands each rank its own frames' gradient, unsummed
                from fddm_asr_tpu_torch.parallel.distributed import gather

                feats = gather(feats.contiguous(), ring, dim=1, sum_grads=False)
                feats = feats[:, :self.config.feat_extract_output_length(T)]

        S = feats.shape[1]
        feat_mask = None
        if lengths is not None:
            feat_lengths = frame_length_estimate(lengths).clamp(max=S)
            feat_mask = torch.arange(S, device=feats.device)[None, :] < feat_lengths[:, None]

        pooled = None
        if self.pooling == "mean":
            if feat_mask is None:
                pooled = feats.mean(dim=1)
            else:
                denom = feat_mask.sum(dim=1).clamp(min=1)[:, None]
                pooled = (feats * feat_mask[..., None]).sum(dim=1) / denom
        return feats, feat_mask, pooled
