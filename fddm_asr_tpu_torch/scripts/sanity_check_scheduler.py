# -*- coding: utf-8 -*-
"""Scheduler sanity check.

    python -m fddm_asr_tpu_torch.scripts.sanity_check_scheduler [CONFIG] [--device cpu]

Counterpart of `scripts/sanity_check_scheduler.py` (the config path as the
first argument, default configs/fddm_zhTW_base.yaml): builds the diffusion
schedule at the config's vocabulary size, runs q_sample and q_posterior on
one-hot rows, and checks that both outputs sum to 1 on every row.  Runs on
CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

__all__ = ["check", "main"]

B, L, T, BETA_MAX = 2, 6, 200, 0.2
TOL = 1e-5


def check(K: int, device: str = None, seed: int = 0) -> Dict[str, torch.Tensor]:
    """{"xt", "post"}: q_sample of one-hot rows (token 10) at t drawn in
    [1, T) and q_posterior of it against a noisy x0hat; raises
    AssertionError unless every row of both sums to 1 within TOL."""
    from fddm_asr_tpu_torch import diffusion as D
    from fddm_asr_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sched = D.make_schedule(K=K, T=T, beta_max=BETA_MAX, device=dev)
    x0 = torch.zeros(B, L, K, device=dev)
    x0[..., 10] = 1.0
    t = torch.randint(1, T, (B,), generator=gen, device=dev)
    xt = D.q_sample(sched, x0, t)
    assert torch.allclose(xt.sum(-1), torch.ones((), device=dev), atol=TOL)
    x0hat = x0 + 0.05 * torch.rand(x0.shape, generator=gen, device=dev)
    x0hat = x0hat / x0hat.sum(-1, keepdim=True)
    post = D.q_posterior(sched, xt, x0hat, t)
    assert torch.allclose(post.sum(-1), torch.ones((), device=dev), atol=TOL)
    return {"xt": xt, "post": post}


def main(argv=None) -> None:
    from fddm_asr_tpu_torch.config import load_yaml

    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="configs/fddm_zhTW_base.yaml")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)
    check(int(load_yaml(args.config)["data"]["vocab_size"]), args.device)
    print("Scheduler sanity check passed.")


if __name__ == "__main__":
    main()
