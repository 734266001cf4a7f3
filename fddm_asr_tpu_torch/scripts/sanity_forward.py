# -*- coding: utf-8 -*-
"""Minimal end-to-end forward sanity check.

    python -m fddm_asr_tpu_torch.scripts.sanity_forward [--tiny] [--cpu]

Counterpart of `scripts/sanity_forward.py`, with its hyperparameters: a
random waveform (B = 2, 2 s) and random noisy tokens (L = 64, V = 4000)
through the acoustic encoder, the denoising decoder (d768, four layers)
and the projection heads to L_fd, one forward in float32.  The full
WavLM-large architecture with random weights by default (on the card,
the gated attention kernel); --tiny the test-sized encoder.  Runs on CUDA
unless given --cpu.
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

__all__ = ["build", "forward", "inputs", "main"]

B = 2              # batch size
T_WAV = 16000 * 2  # 2 s at 16 kHz
L_TOK = 64         # token length after padding
V = 4000           # vocab size
D = 768            # model dim


def build(tiny: bool, device, seed: int = 0) -> Dict[str, torch.nn.Module]:
    """The encoder, decoder and heads, drawn from a generator seeded `seed`."""
    from fddm_asr_tpu_torch.models.decoder import DenoisingTransformerDecoder
    from fddm_asr_tpu_torch.models.encoder import AcousticEncoder
    from fddm_asr_tpu_torch.models.projection import (SpeechProjector, TextEmbedding,
                                                      TextProjector)
    from fddm_asr_tpu_torch.models.wavlm import WavLMConfig
    from fddm_asr_tpu_torch.pipeline import random_init_

    wavlm = WavLMConfig.tiny_for_tests() if tiny else WavLMConfig.large()
    with torch.device(device):
        mods = {"enc": AcousticEncoder(wavlm, d_model=D),
                "dec": DenoisingTransformerDecoder(V, d_model=D, nhead=12, num_layers=4,
                                                   dim_ff=2048, dropout=0.1, max_len=L_TOK,
                                                   pad_id=0),
                "s_proj": SpeechProjector(D, 256), "te": TextEmbedding(V, 256),
                "t_proj": TextProjector(256, 256)}
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in mods.values():
        random_init_(m, gen)
        m.eval()
    return mods


def inputs(device, seed: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(wave [B, T_WAV], xt [B, L_TOK] in [0, V), t [B] in [1, 200))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    wave = torch.randn(B, T_WAV, generator=gen, device=device)
    xt = torch.randint(0, V, (B, L_TOK), generator=gen, device=device)
    t = torch.randint(1, 200, (B,), generator=gen, device=device)
    return wave, xt, t


@torch.no_grad()
def forward(mods, wave, xt, t) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, L, V], L_fd) as the JAX script's jitted forward."""
    from fddm_asr_tpu_torch.losses import align_speech_to_text, lfd_loss

    c, _, _ = mods["enc"](wave, None)
    logits = mods["dec"](xt, t, c, None, None)
    z_text = mods["t_proj"](mods["te"](logits))
    z_speech = align_speech_to_text(mods["s_proj"](c), xt.shape[1])
    return logits, lfd_loss(z_speech, z_text, lambda_offdiag=1.0)


def main(argv=None) -> Tuple[torch.Tensor, torch.Tensor]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true", help="test-sized encoder")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.config import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    mods = build(args.tiny, dev)
    logits, loss_fd = forward(mods, *inputs(dev))
    print("logits:", tuple(logits.shape))
    print("L_fd:", float(loss_fd))
    assert tuple(logits.shape) == (B, L_TOK, V)
    assert torch.isfinite(logits).all() and torch.isfinite(loss_fd)
    print("Sanity check passed.")
    return logits, loss_fd


if __name__ == "__main__":
    main()
