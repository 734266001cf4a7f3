# -*- coding: utf-8 -*-
"""FDDM-ASR training CLI on PyTorch.

    python -m fddm_asr_tpu_torch.train --config configs/fddm_zhTW_base.yaml
    python -m fddm_asr_tpu_torch.train --config ... --resume ckpts/run/ep003.state.pt
    python -m fddm_asr_tpu_torch.train --config ... --wavlm-ckpt path/to/wavlm-large

    torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.train --config ... --mesh data=2
    torchrun --nproc_per_node 4 -m fddm_asr_tpu_torch.train --config ... --mesh data=2,model=2

Counterpart of the repository's `train.py`, over `train_lib.run_training`.
Runs on CUDA; without a GPU it raises unless `--device cpu` is given.
`--resume` takes the port's `{prefix}.state.pt`; `--wavlm-ckpt` a local
Hugging Face WavLM directory.

Several GPUs: one process a GPU, joined from torchrun's environment
(MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) or FDDM_COORDINATOR /
FDDM_NUM_PROCESSES / FDDM_PROCESS_ID, which `--coordinator`,
`--num-processes` and `--process-id` override; FDDM_BACKEND (nccl | gloo)
and FDDM_DEVICE (e.g. cuda:0, for ranks that share a card over gloo) where
set.  `--mesh data=D,model=M` (`parallel.parse_mesh`) must cover every
process; M > 1 splits each utterance's encoder frames over the "model"
ranks with model.encoder.seq_parallel (the ring), else the weights of the
attention heads, the FFNs and the vocabulary (tensor parallelism,
`parallel/tensor.py`):

    torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.train --config ... --mesh model=2
"""
from __future__ import annotations

import argparse

import torch


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
                   help="mesh over the process group, e.g. data=8 or data=2,model=2 "
                        "(one process a GPU)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="rank 0's host:port (or FDDM_COORDINATOR, or torchrun's)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes in the group (or FDDM_NUM_PROCESSES, or torchrun's)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (or FDDM_PROCESS_ID, or torchrun's)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from fddm_asr_tpu_torch import parallel as P
    from fddm_asr_tpu_torch.config import load_config, load_yaml
    from fddm_asr_tpu_torch.convert import load_wavlm
    from fddm_asr_tpu_torch.train_lib import run_training, setup_logging

    cfg = load_config(args.config)
    spec = P.parse_mesh(args.mesh)
    # the flags override the environment; one process with nothing set is a no-op
    dist_cfg = P.DistributedConfig.from_env().overridden(
        args.coordinator, args.num_processes, args.process_id)
    rank, _ = P.initialize(dist_cfg, device=args.device)
    try:
        device = str(dist_cfg.rank_device(args.device)) if rank or dist_cfg.is_multiprocess \
            else args.device
        setup_logging(rank=rank)
        mesh = P.make_mesh(spec, torch.device(device))
        wavlm_sd = load_wavlm(args.wavlm_ckpt) if args.wavlm_ckpt else None
        return run_training(cfg, raw_cfg=load_yaml(args.config), resume=args.resume,
                            wavlm_state_dict=wavlm_sd,
                            max_steps_per_epoch=args.max_steps_per_epoch,
                            export_pt=not args.no_pt_export, profile_dir=args.profile_dir,
                            debug_nans=args.debug_nans, eval_every=args.eval_every,
                            device=device, mesh=mesh)
    finally:
        P.shutdown()


if __name__ == "__main__":
    main()
