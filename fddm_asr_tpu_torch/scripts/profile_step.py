# -*- coding: utf-8 -*-
"""Profile the flagship transcribe step on the device and print the top
ops by device time.

    python -m fddm_asr_tpu_torch.scripts.profile_step [--batch 16] [--top 25] \\
        [--iters 3] [--quant none|int8|int8_fused] [--out DIR] [--device cpu]

Counterpart of `scripts/profile_step.py`: builds the flagship program
(WavLM-large with `gelu_approx_tanh` from --gelu-tanh, `seq_pad_multiple`
from --seq-pad and `quant_dense` from --quant; the d768x6 decoder, bf16,
K = 8000, T = 200; greedy jumpy sampling, T_infer = 20, r = 5, posterior
"average", sampling "exact") with random weights from a seed, runs one
transcribe outside the trace (the kernels' build and the libraries'
set-up), then --iters transcribes under torch.profiler: the Chrome trace
goes under --out, the top --top event names of each track are printed
(`profiling.print_listing`), then one JSON line with each kernel wrapper's
launches a transcribe, the profiler's count of the port's kernels, busy
time and idle share.  On the card the encoder's attention is the gated
attention kernel (24 launches a transcribe) and --quant int8_fused adds
the fused int8 matmul (144); --quant does not turn on the fused front-end.
Runs on CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Callable, Tuple

import torch

__all__ = ["build_transcribe", "main"]

K = 8000
DTYPE = torch.bfloat16  # the modules' compute type


def build_transcribe(batch: int, seconds: float, seq_len: int, gelu_tanh: bool, seq_pad: int,
                     quant: str = "none", *, wavlm_config=None, device=None,
                     seed: int = 0) -> Tuple[Callable, tuple]:
    """(transcribe(wave, generator, x_init=None) -> ids [B, seq_len],
    (encoder, decoder, wave)): the flagship program's modules in `DTYPE`,
    drawn from a generator seeded `seed`, and a [batch, seconds * 16000]
    waveform of 0.1 N(0, 1).  `wavlm_config` (default WavLM-large) takes the
    --gelu-tanh, --seq-pad and --quant overrides."""
    from fddm_asr_tpu_torch import diffusion as D
    from fddm_asr_tpu_torch.config import resolve_device
    from fddm_asr_tpu_torch.models.decoder import DenoisingTransformerDecoder
    from fddm_asr_tpu_torch.models.encoder import AcousticEncoder
    from fddm_asr_tpu_torch.models.wavlm import WavLMConfig
    from fddm_asr_tpu_torch.pipeline import random_init_
    from fddm_asr_tpu_torch.sampler import SamplerConfig, make_sample_fn

    dev = resolve_device(device)
    wavlm_cfg = dataclasses.replace(wavlm_config or WavLMConfig.large(),
                                    gelu_approx_tanh=gelu_tanh, seq_pad_multiple=seq_pad,
                                    quant_dense=quant)
    with dev:
        encoder = AcousticEncoder(wavlm_cfg, d_model=768, dtype=DTYPE)
        decoder = DenoisingTransformerDecoder(K, d_model=768, nhead=12, num_layers=6,
                                              dim_ff=2048, max_len=1024, pad_id=0, dtype=DTYPE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for m in (encoder, decoder):
        random_init_(m, gen)
        m.eval()
    sched = D.make_schedule(K, 200, 0.2, device=dev)
    scfg = SamplerConfig(K=K, T_train=200, T_infer=20, r=5, greedy=True,
                         posterior_mode="average", sampling_mode="exact")
    wave = torch.randn(batch, int(seconds * 16000), generator=gen, device=dev) * 0.1
    sample_fn = make_sample_fn(lambda xt, t, c, cm: decoder(xt, t, c, None, cm), sched, scfg)

    @torch.inference_mode()
    def transcribe(wave: torch.Tensor, generator: torch.Generator, x_init=None):
        c, _, _ = encoder(wave, None)
        ids, _ = sample_fn(c, seq_len, None, x_init=x_init, generator=generator)
        return ids

    return transcribe, (encoder, decoder, wave)


def main(argv=None) -> dict:
    from fddm_asr_tpu_torch.profiling import profile_iters

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--gelu-tanh", type=int, default=1)
    ap.add_argument("--seq-pad", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "torchtrace"))
    ap.add_argument("--quant", default="none", help="none|int8|int8_fused")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    transcribe, (encoder, _, wave) = build_transcribe(
        args.batch, args.seconds, args.seq_len, bool(args.gelu_tanh), args.seq_pad,
        quant=args.quant, device=args.device)
    dev = wave.device

    def run(seed):
        transcribe(wave, torch.Generator(device=dev).manual_seed(seed))

    run(1)  # the kernels' build and the libraries' set-up, outside the trace
    seeds = iter(range(2, 2 + args.iters))
    result = profile_iters(lambda: run(next(seeds)), args.iters, args.out, args.top)
    result.update(batch=args.batch, seconds=args.seconds, quant=args.quant,
                  attention_layers=encoder.config.num_hidden_layers)
    print(json.dumps({"profile_step": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
