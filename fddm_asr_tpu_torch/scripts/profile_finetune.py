# -*- coding: utf-8 -*-
"""Profile the encoder fine-tune step (freeze: false) on the device.

    python -m fddm_asr_tpu_torch.scripts.profile_finetune [--batch 16] [--iters 2] \\
        [--top 30] [--no-remat] [--remat-policy full|dots] [--no-dropout] \\
        [--out DIR] [--device cpu]

Counterpart of `scripts/profile_finetune.py`: the program of `bench_train
--finetune` (WavLM-large trained with remat, the d768x6 decoder, AdamW,
bf16 compute over f32 parameters; random weights from a seed) on a
synthetic batch of --batch x --seconds of audio and --max-len tokens.  One
step outside the timing, --iters timed steps (their `loss` and the least
`step_s` printed), then --iters steps under torch.profiler: the Chrome
trace goes under --out, the top --top event names of each track are
printed, then one JSON line with each kernel wrapper's launches a step, the
profiler's count of the port's kernels, busy time and idle share.  On the
card a step launches the gated attention forward with its logsumexp 47
times (23 layers recomputed in the backward), and its two backward
kernels 24 times each.  Runs on CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

__all__ = ["make_config", "main"]

K, D_PROJ, D_MODEL = 8000, 256, 768


def make_config(args):
    """The fine-tune Config of these flags (the JAX script's)."""
    from fddm_asr_tpu_torch.config import Config

    wavlm_over = {}
    if args.no_remat:
        wavlm_over["remat_layers"] = False
    if args.remat_policy != "full":
        wavlm_over["remat_policy"] = args.remat_policy
    if args.no_dropout:
        wavlm_over.update(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                          feat_proj_dropout=0.0)
    return Config({
        "seed": 0,
        "data": {"vocab_size": K, "pad_id": 3, "max_len": args.max_len},
        "model": {
            "d_model": D_MODEL, "nhead": 12, "num_layers": 6, "dim_ff": 2048,
            "dropout": 0.0 if args.no_dropout else 0.1,
            "encoder": {"wavlm_name": "microsoft/wavlm-large", "freeze": False,
                        "proj": "linear", "pooling": "none", "wavlm_config": wavlm_over},
            "projector": {"d_proj": D_PROJ},
        },
        "diffusion": {"T": 200, "beta_max": 0.2},
        "optim": {"batch_size": args.batch, "lr": 2e-4, "weight_decay": 0.01,
                  "dtype": "bfloat16"},
        "lfd": {"lambda_offdiag": 5e-3, "n_step_fd": 4, "tau": 1.0},
        "log": {"log_every": 50, "ckpt_dir": "/tmp/bench_train"},
    })


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "torchtrace_ft"))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--no-dropout", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.profiling import profile_iters
    from fddm_asr_tpu_torch.scripts import StepTokenizer

    args = parse_args(argv)
    cfg = make_config(args)
    pipeline = FDDMPipeline.from_config(cfg, tokenizer=StepTokenizer(), device=args.device,
                                        dtype=torch.bfloat16)
    dev = pipeline.device
    state = TL.init_train_state(pipeline, cfg, train_encoder=True,
                                generator=torch.Generator(device=dev).manual_seed(0))
    step = TL.make_train_step(pipeline, cfg, train_encoder=True)
    B, T_wav = args.batch, int(args.seconds * 16000)
    wave = np.random.default_rng(0).standard_normal((B, T_wav)).astype(np.float32)
    x0 = np.random.default_rng(1).integers(4, K, (B, args.max_len))

    def run(seed):
        m = step(state, wave, x0, False, generator=torch.Generator(device=dev).manual_seed(seed))
        return float(m["total_loss"])  # waits for the step

    run(1)
    ts = []
    for i in range(args.iters):
        t0 = time.perf_counter()
        print("loss", run(10 + i))
        ts.append(time.perf_counter() - t0)
    print("step_s", min(ts))
    seeds = iter(range(2, 2 + args.iters))
    result = profile_iters(lambda: run(next(seeds)), args.iters, args.out, args.top)
    result.update(batch=B, seconds=args.seconds, step_s=min(ts),
                  attention_layers=pipeline.encoder.config.num_hidden_layers,
                  peak_mem_gb=(torch.cuda.max_memory_allocated() / 2 ** 30
                               if dev.type == "cuda" else None))
    print(json.dumps({"profile_finetune": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
