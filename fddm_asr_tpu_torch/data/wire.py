# -*- coding: utf-8 -*-
"""Wire dtypes of batch audio: encoded on the host as requests arrive,
decoded on the device as the encoder's first step.

Counterpart of `fddm_asr_tpu/data/wire.py` (the port keeps its own copy of
the formulas; the encode side in numpy, the decode side in torch):

  int16  pcm16, x = code / 32768;
  uint8  mu-law, mu = 255, with the byte layout
         u8 = round(127.5 + 127.5 * sign(x) * ln(1 + 255|x|) / ln(256)),
         decoded by its exact inverse x = sign(y) * expm1(|y| ln 256) / 255,
         y = (u8 - 127.5) / 127.5;

any other dtype is cast to float32.  The host encodes mu-law through a
64 Ki table over the int16 grid (no transcendental a sample), which gives
the exact formula's byte everywhere except at exact half-way ties.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

MU = 255.0
_LN = math.log(1.0 + MU)
_DTYPES = {"f32": np.float32, "pcm16": np.int16, "mulaw8": np.uint8}
_LUT16: Optional[np.ndarray] = None  # int16 code -> mu-law byte, built on first use


def _mulaw_encode_exact(x: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(MU * np.abs(x)) / np.log(1.0 + MU)
    return np.clip(np.round(127.5 + 127.5 * y), 0, 255).astype(np.uint8)


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float samples -> uint8 mu-law codes (values outside [-1, 1] clip)."""
    global _LUT16
    if _LUT16 is None:
        _LUT16 = _mulaw_encode_exact(np.arange(-32768, 32768, dtype=np.float32) / 32768.0)
    i = np.clip(np.round(np.asarray(x, np.float32) * 32768.0), -32768, 32767)
    return _LUT16[i.astype(np.int32) + 32768]


def encode_wire(wave: np.ndarray, encoding: str) -> np.ndarray:
    """float samples -> the wire dtype `encoding` (f32, pcm16 or mulaw8)."""
    if encoding == "f32":
        return np.asarray(wave, np.float32)
    if encoding == "pcm16":
        return np.clip(np.round(np.asarray(wave, np.float32) * 32768.0),
                       -32768, 32767).astype(np.int16)
    if encoding == "mulaw8":
        return mulaw_encode(wave)
    raise ValueError(f"unknown wire encoding {encoding!r}")


def wire_dtype(encoding: str) -> np.dtype:
    return np.dtype(_DTYPES[encoding])


def silence_value(encoding: str) -> int:
    """The fill that decodes to silence, or nearly: a zero mu-law byte is
    -1.0, full-scale DC, so mulaw8 pads with the code of 0.0 (128)."""
    if encoding == "mulaw8":
        return int(mulaw_encode(np.zeros(1))[0])
    return 0


def mulaw_decode_np(u: np.ndarray) -> np.ndarray:
    """uint8 mu-law codes -> float32 samples on the host, as the JAX
    package's host decode computes them (through float64)."""
    y = (np.asarray(u, np.float32) - 127.5) / 127.5
    return (np.sign(y) * np.expm1(np.abs(y) * np.log(1.0 + MU)) / MU).astype(np.float32)


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
