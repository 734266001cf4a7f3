# -*- coding: utf-8 -*-
"""FDDM-ASR training CLI on PyTorch.

    python -m fddm_asr_tpu_torch.train --config configs/fddm_zhTW_base.yaml
    python -m fddm_asr_tpu_torch.train --config ... --resume ckpts/run/ep003.state.pt
    python -m fddm_asr_tpu_torch.train --config ... --wavlm-ckpt path/to/wavlm-large

Counterpart of the repository's `train.py`, over `train_lib.run_training`.
Runs on CUDA; without a GPU it raises unless `--device cpu` is given.
`--resume` takes the port's `{prefix}.state.pt`; `--wavlm-ckpt` a local
Hugging Face WavLM directory.  Multi-process training (`--mesh`,
`--coordinator`, `--num-processes`, `--process-id`) is not ported and raises.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FDDM-ASR training on PyTorch")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) | cpu")
    p.add_argument("--resume", type=str, default=None,
                   help="{prefix}.state.pt of an earlier run to resume from")
    p.add_argument("--wavlm-ckpt", type=str, default=None,
                   help="local Hugging Face WavLM directory (config.json with "
                        "model.safetensors or pytorch_model.bin)")
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=None,
                   help="evaluate val/test CER every k-th epoch (and at the last); "
                        "default: the config's log.eval_every, else 1")
    p.add_argument("--no-pt-export", action="store_true",
                   help="skip the reference-format .pt of each checkpoint")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run here")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly mode, and raise at a step whose loss is not finite")
    p.add_argument("--mesh", type=str, default="",
                   help="multi-device training: not ported (raises when set)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host training: not ported (raises when set)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host training: not ported (raises when set)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host training: not ported (raises when set)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if (args.mesh or args.coordinator or args.num_processes is not None
            or args.process_id is not None):
        raise NotImplementedError("--mesh / --coordinator / --num-processes / --process-id: "
                                  "multi-device training is not ported yet (ROADMAP A7)")
    from fddm_asr_tpu_torch.config import load_config, load_yaml
    from fddm_asr_tpu_torch.inference import load_wavlm
    from fddm_asr_tpu_torch.train_lib import run_training, setup_logging

    setup_logging()
    cfg = load_config(args.config)
    wavlm_sd = load_wavlm(args.wavlm_ckpt) if args.wavlm_ckpt else None
    return run_training(cfg, raw_cfg=load_yaml(args.config), resume=args.resume,
                        wavlm_state_dict=wavlm_sd,
                        max_steps_per_epoch=args.max_steps_per_epoch,
                        export_pt=not args.no_pt_export, profile_dir=args.profile_dir,
                        debug_nans=args.debug_nans, eval_every=args.eval_every,
                        device=args.device)


if __name__ == "__main__":
    main()
