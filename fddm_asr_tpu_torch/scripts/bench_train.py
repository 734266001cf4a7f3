# -*- coding: utf-8 -*-
"""Training-step throughput benchmark (flagship config, synthetic batch).

    python -m fddm_asr_tpu_torch.scripts.bench_train [--batch 8] [--seconds 20] [--lfd] \\
        [--model base|paper] [--cached | --finetune [--lora RANK]] [--quant int8_fused] \\
        [--decoder-remat] [--ema DECAY] [--device cpu]

Counterpart of `scripts/bench_train.py`: one train step of
`train_lib.make_train_step` (the frozen WavLM-large forward, the diffusion
KL, L_fd with --lfd, AdamW over the decoder and heads; --finetune trains
the encoder too, --cached feeds precomputed features) over random
weights from a seed, on a synthetic batch.  --model paper is the 253 M
decoder (d1024 x 12, its blocks scanned; --decoder-remat recomputes them in
the backward).  One step outside the timing (the kernels' build), --iters
timed steps; prints one JSON line in the JAX script's keys: examples/s, the
least step seconds, TFLOP/s and MFU.

FLOPs are one step's executed FLOPs, remat's recompute included: torch's
ops as `torch.utils.flop_counter.FlopCounterMode` counts them, plus the
hand-written kernels', which no dispatch mode sees: each kernel launch of
the step (the wrappers' counts) at its shapes (`profiling.gated_attention_flops`
for the gated attention, 2 M din dout for the int8 matmul).  MFU is over the
card's dense bf16 peak (`PEAK_TFLOPS`, by `torch.cuda.get_device_name`, or
BENCH_PEAK_TFLOPS), null on a device the table lacks.  The line also has the
step's peak memory and kernel launches.  Runs on CUDA unless given
--device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

__all__ = ["PEAK_TFLOPS", "make_config", "step_flops", "main"]

K, D_PROJ = 8000, 256
# dense bf16 tensor-core peak by device name: the NVIDIA H100 SXM, 989 TFLOP/s
# (NVIDIA H100 Tensor Core GPU datasheet, "BF16 Tensor Core", without sparsity)
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--lfd", action="store_true", help="include the L_fd step variant")
    ap.add_argument("--quant", default="none",
                    help="encoder quant_dense for the frozen forward: none|int8|int8_fused")
    ap.add_argument("--model", default="base", choices=["base", "paper"],
                    help="decoder geometry: base=d768x6, paper=d1024x12 (253M, scanned)")
    ap.add_argument("--cached", action="store_true",
                    help="feature-cache step: precomputed encoder output c fed straight to "
                         "the decoder step (skips the WavLM forward: the frozen-encoder "
                         "training fast path)")
    ap.add_argument("--finetune", action="store_true",
                    help="fine-tune the encoder: freeze=false, WavLM fwd+bwd inside the "
                         "step, remat'd layers, encoder params in the optimizer")
    ap.add_argument("--no-dropout", action="store_true",
                    help="zero all encoder dropouts (attention dropout takes the plain "
                         "attention; SpecAugment is the cheap WavLM regularizer)")
    ap.add_argument("--specaugment", type=float, default=0.0, metavar="PROB",
                    help="SpecAugment mask_time_prob for --finetune (e.g. 0.065; spans of "
                         "10 frames)")
    ap.add_argument("--lora", type=int, default=0, metavar="RANK",
                    help="with --finetune: LoRA adapters of this rank instead of full "
                         "encoder fine-tuning (the base stays frozen)")
    ap.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                    help="EMA of the trained params inside the step (optim.ema_decay)")
    ap.add_argument("--decoder-remat", action="store_true",
                    help="recompute the scanned decoder blocks in the backward (the paper "
                         "scale's memory lever; sets scan_blocks too)")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"],
                    help="--finetune remat: full=save nothing (default), dots=save the "
                         "projection/FFN matmul outputs and recompute only attention and "
                         "elementwise work in the backward")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)
    if args.finetune and (args.cached or args.quant != "none"):
        ap.error("--finetune excludes --cached and --quant (grads flow through the encoder)")
    if args.lora and not args.finetune:
        ap.error("--lora requires --finetune")
    return args


def make_config(args):
    """The training Config of these flags (the JAX script's)."""
    from fddm_asr_tpu_torch.config import Config

    if args.model == "paper":
        d_model, nhead, n_layers, dim_ff, scan_blocks = 1024, 16, 12, 4096, True
    else:
        d_model, nhead, n_layers, dim_ff, scan_blocks = 768, 12, 6, 2048, False
    no_dropout = ({"hidden_dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0,
                   "feat_proj_dropout": 0.0} if args.no_dropout else {})
    return Config({
        "seed": 0,
        "data": {"vocab_size": K, "pad_id": 3, "max_len": args.max_len},
        "model": {
            "d_model": d_model, "nhead": nhead, "num_layers": n_layers, "dim_ff": dim_ff,
            "scan_blocks": scan_blocks or args.decoder_remat,
            "remat_blocks": args.decoder_remat,
            "dropout": 0.1,
            "encoder": {"wavlm_name": "microsoft/wavlm-large", "freeze": not args.finetune,
                        "lora_rank": args.lora, "proj": "linear", "pooling": "none",
                        "mask_time_prob": args.specaugment,
                        # int8 on the frozen encoder trains: no gradient crosses it
                        "wavlm_config": dict({"quant_dense": args.quant,
                                              "remat_policy": args.remat_policy},
                                             **no_dropout)},
            "projector": {"d_proj": D_PROJ},
        },
        "diffusion": {"T": 200, "beta_max": 0.2},
        "optim": {"batch_size": args.batch, "lr": 2e-4, "weight_decay": 0.01,
                  "ema_decay": args.ema, "dtype": "bfloat16"},
        "lfd": {"lambda_offdiag": 5e-3, "n_step_fd": 4, "tau": 1.0},
        "log": {"log_every": 50, "ckpt_dir": "/tmp/bench_train"},
    })


def config_label(args, d_model: int, n_layers: int) -> str:
    return ((("FINE-TUNED" if args.finetune else "frozen")
             + f" wavlm-large + d{d_model}x{n_layers} decoder, KL, AdamW, bf16")
            + (f" enc-quant-{args.quant}" if args.quant != "none" else "")
            + (" feature-cache" if args.cached else "")
            + (" remat" if args.finetune else "")
            + (f" lora-r{args.lora}" if args.lora else "")
            + (" decoder-remat" if args.decoder_remat else "")
            + (f" ema={args.ema}" if args.ema else "")
            + (" no-dropout" if args.no_dropout else "")
            + (f" specaug={args.specaugment}" if args.specaugment else "")
            + (f" remat={args.remat_policy}" if args.remat_policy != "full" else ""))


def step_flops(run, wavlm_config, batch: int, samples: int) -> dict:
    """One call of `run()` (one step) counted: {"torch": FlopCounterMode's
    FLOPs, "kernels": the hand-written kernels' FLOPs, "launches": each
    kernel wrapper's launches}.  The kernels are counted at the step's
    shapes: every row of the batch holds `samples` samples, so each keeps
    the encoder's frames of that length, padded to seq_pad_multiple."""
    from torch.utils.flop_counter import FlopCounterMode

    from fddm_asr_tpu_torch.ops import kernel_wrappers
    from fddm_asr_tpu_torch.profiling import gated_attention_flops

    wrappers = kernel_wrappers()
    for f in wrappers.values():
        f.launches = 0
    counter = FlopCounterMode(display=False)
    with counter:
        run()
    launches = {k: f.launches for k, f in wrappers.items() if f.launches}
    c = wavlm_config
    frames = c.feat_extract_output_length(samples)
    L = -(-frames // c.seq_pad_multiple) * c.seq_pad_multiple
    H, dh = c.num_attention_heads, c.hidden_size // c.num_attention_heads
    kernel_flops = 0.0
    for kind in ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv"):
        kernel_flops += launches.get(kind, 0) * gated_attention_flops(kind, [frames] * batch,
                                                                      L, H, dh)
    # the six denses of a layer, in order: q, k, v, out (d x d), then the FFN's two
    d, f = c.hidden_size, c.intermediate_size
    per_layer = 2.0 * batch * L * (4 * d * d + 2 * d * f)
    kernel_flops += launches.get("int8_matmul_fused", 0) / 6 * per_layer
    unknown = set(launches) - {"fwd", "fwd_lse", "bwd_dq", "bwd_dkv", "int8_matmul_fused"}
    if unknown:
        raise RuntimeError(f"no FLOP count for the launches of {sorted(unknown)}")
    return {"torch": float(counter.get_total_flops()), "kernels": kernel_flops,
            "launches": launches}


def peak_tflops(device: torch.device):
    if "BENCH_PEAK_TFLOPS" in os.environ:
        return float(os.environ["BENCH_PEAK_TFLOPS"]) or None
    if device.type != "cuda":
        return None
    return PEAK_TFLOPS.get(torch.cuda.get_device_name(device))


def main(argv=None) -> dict:
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.scripts import StepTokenizer

    args = parse_args(argv)
    cfg = make_config(args)
    d_model, n_layers = cfg.model.d_model, cfg.model.num_layers
    pipeline = FDDMPipeline.from_config(cfg, tokenizer=StepTokenizer(), device=args.device,
                                        dtype=torch.bfloat16)
    dev = pipeline.device
    state = TL.init_train_state(pipeline, cfg, train_encoder=args.finetune,
                                generator=torch.Generator(device=dev).manual_seed(0))
    train_step = TL.make_train_step(pipeline, cfg, cached_features=args.cached,
                                    train_encoder=args.finetune)
    B, T_wav = args.batch, int(args.seconds * 16000)
    wave = np.random.default_rng(0).standard_normal((B, T_wav)).astype(np.float32)
    x0 = np.random.default_rng(1).integers(4, K, (B, args.max_len))
    if args.cached:
        c, c_mask = pipeline.encode_waveform(wave)
        c = c.clone()  # out of inference mode: the step differentiates past it

        def step(seed):
            return train_step(state, c, x0, args.lfd, c_mask=c_mask,
                              generator=torch.Generator(device=dev).manual_seed(seed))
    else:
        def step(seed):
            return train_step(state, wave, x0, args.lfd,
                              generator=torch.Generator(device=dev).manual_seed(seed))

    def run(seed):
        float(step(seed)["total_loss"])  # waits for the step

    t0 = time.perf_counter()
    run(1)
    compile_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(args.iters):
        t0 = time.perf_counter()
        run(2 + i)
        times.append(time.perf_counter() - t0)
    step_s = min(times)
    peak_mem_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None

    # MFU: one more step's executed FLOPs over the least step time and the peak
    flops = step_flops(lambda: run(0), pipeline.encoder.config, B, T_wav)
    total = flops["torch"] + flops["kernels"]
    tflops_per_s = total / step_s / 1e12
    peak = peak_tflops(dev)
    mfu_pct = round(100.0 * tflops_per_s / peak, 2) if peak else None
    result = {
        "metric": "train_step_examples_per_s",
        "value": round(B / step_s, 2),
        "unit": "examples_per_second",
        "batch": B,
        "audio_seconds": args.seconds,
        "step_seconds": round(step_s, 4),
        "tflops_per_s": round(tflops_per_s, 2),
        "mfu_pct": mfu_pct,
        "compile_seconds": round(compile_s, 1),
        "lfd": args.lfd,
        "cached_features": args.cached,
        "platform": dev.type,
        "finetune": args.finetune,
        "config": config_label(args, d_model, n_layers),
        "step_flops": {"torch": flops["torch"], "kernels": flops["kernels"]},
        "kernel_launches_per_step": flops["launches"],
        "peak_mem_gb": peak_mem_gb,
        "decoder_params": sum(p.numel() for p in pipeline.decoder.parameters()),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
