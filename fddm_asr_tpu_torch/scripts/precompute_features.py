# -*- coding: utf-8 -*-
"""Frozen-encoder feature precompute (`data/feature_cache.py`).

    python -m fddm_asr_tpu_torch.scripts.precompute_features --config cfg.yaml \\
        --cache-dir feats/ [--splits train,validation,test] [--wavlm-ckpt DIR] \\
        [--encoder-ckpt E.pt] [--device cpu]

Counterpart of `scripts/precompute_features.py`: writes
<cache-dir>/<split>/feats.npy + meta.json for each split's manifest
(data.train_json, data.val_json, data.test_json).  The encoder is the one
`train_lib.run_training` builds (`train_lib.training_pipeline`: the
config's seed, the training compute dtype, --wavlm-ckpt and --encoder-ckpt
as the other CLIs take them), and the cache is written by the function the
run itself calls (`train_lib._ensure_feature_cache`), in batches of
optim.batch_size (default 4, as the run) unless --batch-size says
otherwise: so a run with ``data.cache_features: <cache-dir>`` and the same
weights opens the train split's cache without rebuilding it.  An existing
cache is rebuilt.  Runs on CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Dict, List, Optional

__all__ = ["SPLIT_KEYS", "precompute", "main"]

# split -> (config key, default manifest)
SPLIT_KEYS = {"train": ("train_json", "data/processed/train.json"),
              "validation": ("val_json", "data/processed/validation.json"),
              "test": ("test_json", "data/processed/test.json")}


def precompute(cfg, cache_dir: str, splits: List[str], batch_size: Optional[int] = None,
               wavlm_state_dict=None, encoder_state_dict=None,
               device: Optional[str] = None) -> Dict[str, Dict]:
    """Build each split's cache; returns {split: {shape, dtype, bytes,
    seconds}}."""
    from fddm_asr_tpu_torch import train_lib as TL

    pipeline = TL.training_pipeline(cfg, wavlm_state_dict, encoder_state_dict, device=device)
    batch_size = batch_size or int(cfg.optim.get("batch_size", 4))
    checksum = TL._encoder_checksum(pipeline)
    out = {}
    for split in splits:
        key, default = SPLIT_KEYS[split]
        manifest = cfg.data.get(key, default)
        ds = TL.training_dataset(cfg, manifest, pipeline.tokenizer)
        t0 = time.time()
        cache, _ = TL._ensure_feature_cache(pipeline, ds, cache_dir, split, batch_size,
                                            manifest, checksum, rebuild=True)
        out[split] = {"shape": list(cache.shape), "dtype": cache.dtype_token,
                      "bytes": cache.nbytes, "seconds": time.time() - t0}
        logging.info(f"{split}: cached feats {cache.shape} dtype={cache.dtype_token} "
                     f"under {cache_dir}")
    return out


def main(argv=None) -> Dict[str, Dict]:
    from fddm_asr_tpu_torch.convert import add_encoder_weight_args, load_encoder_weights

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--splits", default="train",
                    help="comma-separated: train,validation,test")
    ap.add_argument("--batch-size", type=int, default=None)
    add_encoder_weight_args(ap)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.config import load_config

    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    wavlm_sd, encoder_sd = load_encoder_weights(args.wavlm_ckpt, args.encoder_ckpt)
    return precompute(load_config(args.config), args.cache_dir,
                      [s.strip() for s in args.splits.split(",") if s.strip()],
                      args.batch_size, wavlm_sd, encoder_sd, args.device)


if __name__ == "__main__":
    main()
