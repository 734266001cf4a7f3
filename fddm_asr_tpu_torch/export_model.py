# -*- coding: utf-8 -*-
"""Export an AOT deployment artifact (`torch.export` programs + weights +
tokenizer) from a checkpoint.  See `fddm_asr_tpu_torch/aot.py` for the
artifact contract.

    python -m fddm_asr_tpu_torch.export_model \
        --ckpt ckpts/best_model.pt \
        --main-config configs/fddm_zhTW_base.yaml \
        --diffusion-config configs/diffusion.yaml \
        --tokenizer data/tokenizer/zh-TW_A/spm_zhTW_A.model \
        --out artifacts/fddm_v1 \
        --batch-sizes 1,8 --seconds 20 --seq-len 64 \
        --T-infer 20 --r 5 --greedy [--wavlm-ckpt DIR] [--device cpu]

Counterpart of `scripts/export_model.py`: the same flags and the same
one-line JSON summary.  The programs are traced on the device they will run
on (CUDA unless `--device cpu`).  Where the JAX flags name TPU machinery:

  * `--fused-attention` is accepted and changes nothing: every program
    records the gated-attention kernel's op (`torch.ops.fddm`), the Hopper
    kernel on CUDA and its plain version on the CPU;
  * `--native on` and `--native-batch-sizes` change nothing but the
    buckets: every bucket is captured as a CUDA graph when a CUDA host
    loads the artifact, so the extra batch sizes become ordinary buckets;
  * `--platforms` may name only the device the programs are traced on
    (cuda or cpu); anything else raises;
  * `--mesh` and `--seq-parallel` raise: multi-device serving is not
    ported (ROADMAP A7).

Prints one JSON summary line on success; the seconds each program took to
trace are in the artifact's meta.json (`export_seconds`).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from fddm_asr_tpu_torch.convert import add_encoder_weight_args


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FDDM-ASR AOT export on PyTorch")
    p.add_argument("--ckpt", type=str, required=True, help="reference-format .pt checkpoint")
    add_encoder_weight_args(p)
    p.add_argument("--main-config", type=str, required=True)
    p.add_argument("--diffusion-config", type=str, required=True)
    p.add_argument("--tokenizer", type=str, required=True)
    p.add_argument("--out", type=str, required=True, help="artifact directory")
    p.add_argument("--batch-sizes", type=str, default="1,8",
                   help="comma-separated batch buckets")
    p.add_argument("--seconds", type=str, default="20",
                   help="audio bucket length(s) in seconds at 16 kHz, comma-separated "
                        "(e.g. '5,10,20')")
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--T-infer", type=int, default=20)
    p.add_argument("--r", type=int, default=5)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--posterior-mode", type=str, default="average",
                   choices=["average", "max", "map"])
    p.add_argument("--sampling-mode", type=str, default="exact", choices=["exact", "fast"])
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--corrected-posterior", action="store_true")
    p.add_argument("--repeat-penalty", type=float, default=0.0)
    p.add_argument("--condition-mask", choices=["on", "off"], default="off",
                   help="on: mask padded audio frames in cross-attention so bucket padding "
                        "cannot alter transcripts (what serving uses); off (default): "
                        "reference parity, no masks at inference")
    p.add_argument("--platforms", type=str, default="",
                   help="the device type the programs run on (cuda or cpu); default: "
                        "--device's")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--dtype", choices=["config", "bfloat16", "float32"], default="config",
                   help="compute dtype baked into the programs; config honours the YAML's "
                        "model.dtype")
    p.add_argument("--fused-attention", choices=["auto", "on", "off"], default="auto",
                   help="accepted for the JAX CLI's sake: every program records the "
                        "gated-attention kernel")
    p.add_argument("--input-encoding", choices=["f32", "pcm16", "mulaw8"], default="f32",
                   help="wire dtype of the wave input baked into the programs (data/wire.py): "
                        "pcm16 halves the host-to-device bytes and is lossless for 16-bit "
                        "PCM sources, mulaw8 quarters them at telephone-grade companding")
    p.add_argument("--native", choices=["on", "off"], default="off",
                   help="accepted for the JAX CLI's sake: a CUDA host captures every bucket "
                        "as a CUDA graph at load")
    p.add_argument("--native-batch-sizes", type=str, default="",
                   help="extra batch buckets (e.g. '32'), exported like the others")
    p.add_argument("--mesh", type=str, default="",
                   help="sharded programs: not ported (raises, ROADMAP A7)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="ring-attention sequence parallelism: not ported (raises, ROADMAP A7)")
    return p.parse_args(argv)


def parse_buckets(batch_sizes: str, seconds: str):
    """'1,8' x '5,20' -> [(1, 80000), (1, 320000), (8, 80000), ...]"""
    batches = [int(b) for b in batch_sizes.split(",") if b]
    secs = [float(s) for s in seconds.split(",") if s]
    if not batches or not secs:
        raise ValueError("need at least one batch size and one duration")
    return [(b, int(round(sec * 16000))) for b in batches for sec in secs]


def main(argv=None):
    args = parse_args(argv)
    if args.mesh or args.seq_parallel:
        raise SystemExit("--mesh / --seq-parallel: sharded export is not ported yet "
                         "(ROADMAP A7)")
    platforms = [s for s in args.platforms.split(",") if s]
    if any(p not in ("cuda", "cpu") for p in platforms):
        raise SystemExit(f"--platforms {args.platforms}: the programs run on cuda or cpu, "
                         "the device they are traced on")

    from fddm_asr_tpu_torch import aot
    from fddm_asr_tpu_torch import inference as infer_cli

    buckets = parse_buckets(args.batch_sizes, args.seconds)
    if args.native_batch_sizes:
        buckets = sorted(set(buckets) | set(parse_buckets(args.native_batch_sizes,
                                                          args.seconds)))
    device = args.device or "cuda"
    if platforms and platforms != [device.split(":")[0]]:
        raise SystemExit(f"--platforms {args.platforms}: the programs are traced on "
                         f"--device {device} and run only there")
    args.device = device
    pipeline = infer_cli.build_pipeline(args)
    pipeline.use_condition_mask = args.condition_mask == "on"
    sampling = infer_cli.sampling_kwargs(args)
    sampling["temperature"] = args.temperature

    meta = aot.save_artifact(
        pipeline, args.out, buckets, seq_len=args.seq_len, sampling=sampling,
        tokenizer_path=args.tokenizer, input_encoding=args.input_encoding)
    size = sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(args.out) for f in files)
    print(json.dumps({"out": args.out, "buckets": meta["buckets"],
                      # the buckets a CUDA host replays as graphs
                      "native_buckets": meta["buckets"] if meta["platforms"] == ["cuda"]
                      else None,
                      "seq_len": meta["seq_len"],
                      "platforms": meta["platforms"],
                      "fused_attention": True,
                      "artifact_bytes": size}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
