#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Write the JAX pipeline's acoustic encoder as a state_dict for the PyTorch port.

    python scripts/export_torch_encoder.py --main-config configs/fddm_zhTW_base.yaml \
        --out ckpts/encoder_torch.pt

Runs where JAX is (it imports both packages).  It builds the JAX
`FDDMPipeline.from_config` from the config and its seed (or `--seed`) and
writes `pipeline.encoder_params` (the WavLM backbone and, when hidden_size !=
d_model, the frozen `proj` the JAX pipeline draws from that seed and no
checkpoint carries) through `fddm_asr_tpu_torch.convert.
acoustic_encoder_state_dict_from_jax_params` with `torch.save`.  The port
loads it with `FDDMPipeline.from_config(encoder_state_dict=...)` or the CLI's
`--encoder-ckpt`, so a decoder trained by the JAX package meets the same
condition in the port.
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
    p.add_argument("--out", required=True, help="the .pt to write")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    import jax
    import numpy as np
    import torch

    from fddm_asr_tpu.config import load_config
    from fddm_asr_tpu.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.convert import acoustic_encoder_state_dict_from_jax_params

    cfg = load_config(args.main_config)
    # the encoder needs no tokenizer: any non-None value keeps from_config from loading one
    pipeline = FDDMPipeline.from_config(cfg, tokenizer=False, seed=args.seed)
    params = jax.tree.map(np.asarray, pipeline.encoder_params)
    sd = acoustic_encoder_state_dict_from_jax_params(params)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.save(sd, args.out)
    print(f"wrote {len(sd)} tensors ({'with' if 'proj.weight' in sd else 'without'} proj) "
          f"to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
