# -*- coding: utf-8 -*-
"""Average the weights of several checkpoints into one.

    python -m fddm_asr_tpu_torch.scripts.average_checkpoints --out avg.pt ck/ep005.pt ck/ep006.pt
    python -m fddm_asr_tpu_torch.scripts.average_checkpoints --out avg.pt --last 5 --ckpt-dir ck/

Counterpart of `scripts/average_checkpoints.py`: averaging the last k
epochs recovers much of an EMA's variance reduction after the fact.  The
inputs are reference-format `.pt` files (this package's training writes
them as `{prefix}.pt`, the JAX package's too); each decoder and projection
head tensor is summed in float64 and cast back to its dtype, as the JAX
script's `_tree_avg` does, and the result is a reference `.pt` (epoch and
step the largest of the inputs').  A head missing from any input is left
out.  An orbax directory (the JAX package's training checkpoint) raises:
it needs JAX to read, and `scripts/export_torch_encoder.py --ckpt DIR
--decoder-out D.pt` turns it into a `.pt` where JAX is.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Dict, List

import torch

__all__ = ["average_state_dicts", "collect_last", "main"]

PARTS = ("decoder", "s_proj", "t_embed", "t_proj")


def average_state_dicts(sds: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The element-wise mean of state_dicts with the same keys and shapes
    (in the first one's key order): summed in float64 in the given order,
    divided by their number, cast back to the first one's dtype."""
    keys = list(sds[0])
    if any(set(sd) != set(keys) for sd in sds[1:]):
        raise ValueError("the checkpoints hold different tensors; they are not one model's")
    out = {}
    for k in keys:
        total = sum(sd[k].to(torch.float64) for sd in sds)
        out[k] = (total / len(sds)).to(sds[0][k].dtype)
    return out


def collect_last(ckpt_dir: str, k: int) -> List[str]:
    """The newest k epoch checkpoints `epNNN.pt` under `ckpt_dir`."""
    eps = {}
    for p in glob.glob(os.path.join(ckpt_dir, "ep*")):
        m = re.match(r"ep(\d+)\.pt$", os.path.basename(p))
        if m:
            eps[int(m.group(1))] = p
    if not eps:
        raise SystemExit(f"no epNNN.pt checkpoints under {ckpt_dir}")
    return [eps[n] for n in sorted(eps)[-k:]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpts", nargs="*", help="explicit checkpoint paths (.pt)")
    ap.add_argument("--out", required=True, help="output .pt path")
    ap.add_argument("--last", type=int, default=0,
                    help="with --ckpt-dir: average the newest N epochs")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    paths = list(args.ckpts)
    if args.last:
        if not args.ckpt_dir:
            raise SystemExit("--last requires --ckpt-dir")
        paths += collect_last(args.ckpt_dir, args.last)
    if len(paths) < 2:
        raise SystemExit("need at least two checkpoints to average")

    from fddm_asr_tpu_torch.checkpoint import save_reference_ckpt
    from fddm_asr_tpu_torch.convert import load_reference_checkpoint

    loaded = [load_reference_checkpoint(p) for p in paths]
    parts = {}
    for key in PARTS:
        sds = [ck.get(key) for ck in loaded]
        if any(sd is None for sd in sds):
            if key == "decoder":
                raise SystemExit("every checkpoint must carry a decoder")
            parts[key] = None
            continue
        parts[key] = average_state_dicts(sds)
    save_reference_ckpt(os.path.abspath(args.out), *(parts[k] for k in PARTS),
                        epoch=max(int(ck.get("epoch") or 0) for ck in loaded),
                        step=max(int(ck.get("step") or 0) for ck in loaded))
    print(f"averaged {len(paths)} checkpoints -> {args.out}")
    for p in paths:
        print(f"  {p}")


if __name__ == "__main__":
    main()
