# -*- coding: utf-8 -*-
"""FDDM-ASR inference CLI on PyTorch (jumpy sampling + greedy decoding).

    python -m fddm_asr_tpu_torch.inference --wav path.wav --ckpt ckpts/ep001.pt \
        --main-config configs/fddm_zhTW_base.yaml \
        --diffusion-config configs/diffusion.yaml \
        --tokenizer data/tokenizer/zh-TW_A/spm_zhTW_A.model \
        --T-infer 20 --r 5 --greedy

    python -m fddm_asr_tpu_torch.inference --csv test.csv ... --out-json out.json

Counterpart of the repository's `inference.py` (the same flags for this
path and the same result JSON: {wav, text, ids, T_infer, r, greedy,
posterior_mode[, confidence]}).  Runs on CUDA; without a GPU it raises
unless `--device cpu` is given.  A CSV needs a `path` column; its rows go
through the pipeline `--batch-size` at a time, padded to the longest.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FDDM-ASR inference on PyTorch (jumpy sampling)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--wav", type=str, help="single WAV file")
    src.add_argument("--csv", type=str, help="batch CSV with a `path` column")
    p.add_argument("--ckpt", type=str, required=True,
                   help="reference-format .pt decoder checkpoint")
    p.add_argument("--encoder-ckpt", type=str, default=None,
                   help=".pt of the port's AcousticEncoder state_dict (backbone and proj), "
                        "e.g. from scripts/export_torch_encoder.py; default: random from "
                        "the config's seed")
    p.add_argument("--main-config", type=str, required=True)
    p.add_argument("--diffusion-config", type=str, required=True)
    p.add_argument("--tokenizer", type=str, required=True,
                   help="SentencePiece .model/.vocab path")
    p.add_argument("--T-infer", type=int, default=20)
    p.add_argument("--r", type=int, default=5)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--posterior-mode", type=str, default="average", choices=["average", "max"])
    p.add_argument("--sampling-mode", type=str, default="exact", choices=["exact", "fast"])
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) | cpu")
    p.add_argument("--batch-size", type=int, default=8, help="CSV mode: utterances per batch")
    p.add_argument("--dtype", choices=["config", "bfloat16", "float32"], default="config",
                   help="compute dtype; config honours the YAML's model.dtype")
    p.add_argument("--condition-mask", type=str, default="auto", choices=["auto", "on", "off"],
                   help="mask padded audio frames in cross-attention; auto = on for a "
                        "batched CSV, off for one WAV (reference parity)")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--confidence", action="store_true",
                   help="add each utterance's confidence to its result")
    p.add_argument("--out-json", type=str, default=None)
    return p.parse_args(argv)


def build_pipeline(args):
    from fddm_asr_tpu_torch.config import load_config, load_yaml
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    main_cfg = load_config(args.main_config)
    diff = load_yaml(args.diffusion_config).get("diffusion", {})
    cfg = main_cfg.updated({"diffusion": {
        "T": diff.get("T", main_cfg.diffusion["T"]),
        "beta_max": diff.get("beta_max", main_cfg.diffusion.get("beta_max", 0.2)),
    }})
    encoder_sd = None
    if args.encoder_ckpt:
        encoder_sd = torch.load(args.encoder_ckpt, map_location="cpu", weights_only=True)
    return FDDMPipeline.from_config(
        cfg, ckpt_path=args.ckpt, encoder_state_dict=encoder_sd,
        tokenizer=load_tokenizer(args.tokenizer), device=args.device,
        dtype=None if args.dtype == "config" else args.dtype)


def infer_batch(pipeline, wav_paths: List[str], args, generator) -> List[Dict[str, Any]]:
    """Transcribe WAVs as one batch padded to the longest; a file that cannot
    be read gets an error record."""
    from fddm_asr_tpu_torch.data.audio_io import load_audio

    out: List[Optional[Dict[str, Any]]] = [None] * len(wav_paths)
    waves, ok = [], []
    for i, path in enumerate(wav_paths):
        try:
            waves.append(load_audio(path, target_sr=16000, mono=True)[0])
            ok.append(i)
        except (OSError, ValueError, RuntimeError) as e:
            out[i] = {"wav": path, "error": str(e)}
    if waves:
        lengths = [max(len(w), CONV_RECEPTIVE_FIELD) for w in waves]
        batch = np.zeros((len(waves), max(lengths)), np.float32)
        for j, w in enumerate(waves):
            batch[j, :len(w)] = w
        rows = pipeline.transcribe_with_ids(
            batch, np.asarray(lengths), seq_len=args.seq_len, generator=generator,
            with_confidence=args.confidence, T_infer=args.T_infer, r=args.r,
            greedy=args.greedy, posterior_mode=args.posterior_mode,
            sampling_mode=args.sampling_mode)
        for i, row in zip(ok, rows):
            res = {"wav": wav_paths[i], "text": row[0], "ids": row[1],
                   "T_infer": args.T_infer, "r": args.r, "greedy": args.greedy,
                   "posterior_mode": args.posterior_mode}
            if len(row) > 2:
                res["confidence"] = round(row[2], 6)
            out[i] = res
    return out  # type: ignore[return-value]


def main(argv=None):
    args = parse_args(argv)
    pipeline = build_pipeline(args)
    if args.condition_mask == "auto":
        pipeline.use_condition_mask = (pipeline.use_condition_mask
                                       or (bool(args.csv) and args.batch_size > 1))
    else:
        pipeline.use_condition_mask = args.condition_mask == "on"
    generator = torch.Generator(device=pipeline.device).manual_seed(args.seed)
    results: List[Dict[str, Any]] = []
    if args.wav:
        res = infer_batch(pipeline, [args.wav], args, generator)[0]
        results.append(res)
        print(json.dumps(res, ensure_ascii=False, indent=2))
    else:
        with open(args.csv, newline="", encoding="utf-8") as f:
            paths = [row["path"] for row in csv.DictReader(f)]
        bs = max(1, args.batch_size)
        for start in range(0, len(paths), bs):
            for res in infer_batch(pipeline, paths[start:start + bs], args, generator):
                results.append(res)
                print(json.dumps(res, ensure_ascii=False))
    if args.out_json:
        os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
        with open(args.out_json, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)


if __name__ == "__main__":
    main()
