#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Write the JAX pipeline's acoustic encoder (and decoder) as state_dicts for the PyTorch port.

    python scripts/export_torch_encoder.py --main-config configs/fddm_zhTW_base.yaml \
        --out ckpts/encoder_torch.pt
    python scripts/export_torch_encoder.py --main-config configs/fddm_zhTW_finetune.yaml \
        --ckpt ckpts/run/best_model.orbax --wavlm-ckpt path/to/wavlm-large \
        --out ckpts/encoder_torch.pt --decoder-out ckpts/decoder_torch.pt

Runs where JAX is (it imports both packages).  It builds the JAX
`FDDMPipeline.from_config` from the config and its seed (or `--seed`), with
`--ckpt` (a JAX training checkpoint: an orbax directory, or a reference
`.pt`) and `--wavlm-ckpt` (what the JAX CLIs take: a Hugging Face WavLM
directory or an orbax tree) passed as its `ckpt_path` and `wavlm_params`.
That call takes the EMA weights when the checkpoint's sidecar says
`ema_eval` and merges a LoRA run's adapters into the base encoder at the
sidecar's alpha, so what is written is the encoder the JAX pipeline
transcribes with.  `--out` gets `pipeline.encoder_params` (the WavLM
backbone and, when hidden_size != d_model, the frozen `proj` the JAX
pipeline draws from the seed) through `fddm_asr_tpu_torch.convert.
acoustic_encoder_state_dict_from_jax_params` with `torch.save`; the port
loads it with `FDDMPipeline.from_config(encoder_state_dict=...)` or the
CLIs' `--encoder-ckpt`.  `--decoder-out` writes the checkpoint's decoder and
projection heads (the EMA's under `ema_eval`, else the raw weights) as a
reference-format `.pt` through the JAX package's `export_reference_ckpt`,
for the port's `--ckpt` (a run saved with `--no-pt-export` has none).
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--main-config", required=True, help="the model's YAML config")
    p.add_argument("--seed", type=int, default=None, help="default: the config's seed")
    p.add_argument("--ckpt", default=None,
                   help="a JAX training checkpoint (orbax directory) or reference .pt")
    p.add_argument("--wavlm-ckpt", default=None,
                   help="the base WavLM: a Hugging Face directory or an orbax tree "
                        "(default: random from the seed)")
    p.add_argument("--out", required=True, help="the encoder .pt to write")
    p.add_argument("--decoder-out", default=None,
                   help="also write the checkpoint's decoder and heads as a reference .pt "
                        "(needs --ckpt)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    if args.decoder_out and not args.ckpt:
        raise SystemExit("--decoder-out needs --ckpt")
    import jax
    import numpy as np
    import torch

    from fddm_asr_tpu.config import load_config
    from fddm_asr_tpu.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.convert import acoustic_encoder_state_dict_from_jax_params

    cfg = load_config(args.main_config)
    wavlm_params = None
    if args.wavlm_ckpt:
        from train import _load_wavlm

        wavlm_params = _load_wavlm(args.wavlm_ckpt, cfg)
    # the encoder needs no tokenizer: any non-None value keeps from_config from loading one
    pipeline = FDDMPipeline.from_config(cfg, ckpt_path=args.ckpt, wavlm_params=wavlm_params,
                                        tokenizer=False, seed=args.seed)
    params = jax.tree.map(np.asarray, pipeline.encoder_params)
    sd = acoustic_encoder_state_dict_from_jax_params(params)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.save(sd, args.out)
    print(f"wrote {len(sd)} tensors ({'with' if 'proj.weight' in sd else 'without'} proj) "
          f"to {args.out}")
    if args.decoder_out:
        from fddm_asr_tpu.checkpoint import export_reference_ckpt, load_checkpoint_any

        loaded = load_checkpoint_any(args.ckpt,
                                     scan_blocks=bool(cfg.model.get("scan_blocks", False)))
        meta = {k: loaded.get(k) for k in ("epoch", "step", "best_val_cer")
                if loaded.get(k) is not None}
        meta = {k: (float(v) if k == "best_val_cer" else int(np.asarray(v)))
                for k, v in meta.items()}
        os.makedirs(os.path.dirname(args.decoder_out) or ".", exist_ok=True)
        export_reference_ckpt(args.decoder_out, loaded["decoder"], loaded.get("s_proj"),
                              loaded.get("t_embed"), loaded.get("t_proj"), **meta)
        print(f"wrote the decoder to {args.decoder_out}")
    return args.out


if __name__ == "__main__":
    main()
