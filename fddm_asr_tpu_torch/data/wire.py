# -*- coding: utf-8 -*-
"""Wire dtypes of batch audio, decoded on the device as the encoder's first step.

Counterpart of the decode side of `fddm_asr_tpu/data/wire.py` (the port keeps
its own copy of the formulas):

  int16  pcm16, x = code / 32768;
  uint8  mu-law, mu = 255, with the byte layout
         u8 = round(127.5 + 127.5 * sign(x) * ln(1 + 255|x|) / ln(256)),
         decoded by its exact inverse x = sign(y) * expm1(|y| ln 256) / 255,
         y = (u8 - 127.5) / 127.5;

any other dtype is cast to float32.
"""
from __future__ import annotations

import math

import torch

MU = 255.0
_LN = math.log(1.0 + MU)


def mulaw_decode(u: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law codes -> float32 samples in [-1, 1]."""
    y = (u.float() - 127.5) / 127.5
    return torch.sign(y) * torch.expm1(y.abs() * _LN) / MU


def decode_wire(wave: torch.Tensor) -> torch.Tensor:
    """int16 (pcm16) or uint8 (mu-law) codes, or float samples -> float32."""
    if wave.dtype == torch.int16:
        return wave.float() / 32768.0
    if wave.dtype == torch.uint8:
        return mulaw_decode(wave)
    return wave.float()
