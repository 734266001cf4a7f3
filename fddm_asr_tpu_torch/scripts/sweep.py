# -*- coding: utf-8 -*-
"""Hyperparameter sweep over a fddm_sweep.yaml-style search space.

    python -m fddm_asr_tpu_torch.scripts.sweep --sweep configs/fddm_sweep.yaml --trials 8 \\
        [--mode random|grid] [--max-steps-per-epoch 50] [--dry-run] [--device cpu]

Counterpart of `scripts/sweep.py`.  Search-space leaves are
{distribution: log_uniform | uniform | categorical, min/max or values};
everything else is a fixed override of the base_config.  Random mode draws
from numpy's generator at --seed, leaf by leaf in the file's order, so a
seed gives the JAX script's assignments; grid mode takes three points a
continuous leaf (log-spaced for log_uniform) and every categorical value,
in itertools.product order, cut to --trials.  Each trial trains with
`train_lib.run_training` (--mesh parsed by `parallel.parse_mesh`, over the
process group torchrun's or the FDDM_* variables describe) and writes
<out>/trial_NNN/{config.yaml,result.json}; <out>/summary.json ranks the
trials by best_val_cer.  A trial that raises records {"error": ...}.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["iter_search_leaves", "sample_leaf", "grid_leaf", "set_path", "materialise",
           "assignments", "main"]


def is_search_leaf(node: Any) -> bool:
    return isinstance(node, dict) and "distribution" in node


def iter_search_leaves(space: Dict, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Dict]]:
    for key, val in space.items():
        if key == "base_config":
            continue
        if is_search_leaf(val):
            yield prefix + (key,), val
        elif isinstance(val, dict):
            yield from iter_search_leaves(val, prefix + (key,))


def sample_leaf(leaf: Dict, rng: np.random.Generator) -> Any:
    dist = leaf["distribution"]
    if dist == "categorical":
        values = leaf["values"]
        return values[int(rng.integers(len(values)))]
    lo, hi = float(leaf["min"]), float(leaf["max"])
    if dist == "log_uniform":
        return float(np.exp(rng.uniform(math.log(lo), math.log(hi))))
    if dist == "uniform":
        return float(rng.uniform(lo, hi))
    raise ValueError(f"unknown distribution {dist}")


def grid_leaf(leaf: Dict, n: int = 3) -> List[Any]:
    if leaf["distribution"] == "categorical":
        return list(leaf["values"])
    lo, hi = float(leaf["min"]), float(leaf["max"])
    if leaf["distribution"] == "log_uniform":
        return [float(x) for x in np.exp(np.linspace(math.log(lo), math.log(hi), n))]
    return [float(x) for x in np.linspace(lo, hi, n)]


def set_path(tree: Dict, path: Tuple[str, ...], value: Any) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def materialise(space: Dict, assignment: Dict[Tuple[str, ...], Any]) -> Dict:
    """The fixed (non-search) overrides plus the assignment."""
    def strip(node):
        if is_search_leaf(node):
            return None
        if isinstance(node, dict):
            out = {k: strip(v) for k, v in node.items() if k != "base_config"}
            return {k: v for k, v in out.items() if v is not None}
        return node

    overrides = strip(space) or {}
    for path, value in assignment.items():
        set_path(overrides, path, value)
    return overrides


def assignments(space: Dict, trials: int, mode: str, seed: int) -> List[Dict]:
    """The trials' {leaf path: value} (module docstring)."""
    leaves = list(iter_search_leaves(space))
    if mode == "grid":
        combos = list(itertools.product(*(grid_leaf(leaf) for _, leaf in leaves)))[:trials]
        return [{path: v for (path, _), v in zip(leaves, combo)} for combo in combos]
    rng = np.random.default_rng(seed)
    return [{path: sample_leaf(leaf, rng) for path, leaf in leaves} for _ in range(trials)]


def _best_cer(result: Tuple[int, Dict]) -> float:
    cer = result[1].get("best_val_cer")
    return cer if cer is not None else float("inf")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", type=str, required=True)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--mode", choices=["random", "grid"], default="random")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="sweeps/run")
    ap.add_argument("--max-steps-per-epoch", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None, help="override num_epochs")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--mesh", type=str, default="",
                    help="mesh spec for each trial, e.g. data=8 or data=4,model=2")
    ap.add_argument("--dry-run", action="store_true",
                    help="print sampled configs without training")
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.config import load_yaml

    space = load_yaml(args.sweep)
    base_path = space.get("base_config")
    if not base_path or not os.path.exists(base_path):
        print(f"base_config missing: {base_path}", file=sys.stderr)
        sys.exit(1)
    trials = assignments(space, args.trials, args.mode, args.seed)

    mesh, device, primary = None, args.device, True
    if not args.dry_run:
        import torch

        from fddm_asr_tpu_torch import parallel as P
        from fddm_asr_tpu_torch.config import resolve_device

        resolve_device(args.device)  # no GPU and no --device cpu: raise before any trial
        spec = P.parse_mesh(args.mesh)
        dist_cfg = P.DistributedConfig.from_env()
        rank, _ = P.initialize(dist_cfg, device=args.device)
        if rank or dist_cfg.is_multiprocess:
            device = str(dist_cfg.rank_device(args.device))
        mesh, primary = P.make_mesh(spec, torch.device(device)), P.is_primary()
    try:
        _run_trials(space, base_path, trials, args, mesh, device, primary)
    finally:
        if mesh is not None:
            P.shutdown()


def _run_trials(space: Dict, base_path: str, trials: List[Dict], args, mesh, device: str,
                primary: bool) -> None:
    """Each trial's config.yaml and, unless --dry-run, its training run and
    result.json, then summary.json; in a process group the primary rank
    alone writes the files."""
    from fddm_asr_tpu_torch.config import dump_yaml, load_config

    os.makedirs(args.out, exist_ok=True)
    results = []
    for i, assignment in enumerate(trials):
        overrides = materialise(space, assignment)
        if args.epochs:
            overrides.setdefault("optim", {})["num_epochs"] = args.epochs
        trial_dir = os.path.join(args.out, f"trial_{i:03d}")
        os.makedirs(trial_dir, exist_ok=True)
        overrides.setdefault("log", {})["ckpt_dir"] = os.path.join(trial_dir, "ckpts")
        cfg = load_config(base_path, overrides=overrides)
        if primary:
            dump_yaml(cfg.to_dict(), os.path.join(trial_dir, "config.yaml"))
        printable = {"/".join(p): v for p, v in assignment.items()}
        print(f"[trial {i}] {printable}")
        if args.dry_run:
            continue

        from fddm_asr_tpu_torch.parallel import process_group
        from fddm_asr_tpu_torch.train_lib import run_training, setup_logging

        setup_logging(os.path.join(trial_dir, "logs"), rank=process_group()[0])
        try:
            summary = run_training(cfg, raw_cfg=cfg.to_dict(),
                                   max_steps_per_epoch=args.max_steps_per_epoch,
                                   export_pt=False, device=device, mesh=mesh)
        except Exception as e:  # a failed trial is a result, the sweep goes on
            summary = {"error": str(e)}
        summary["assignment"] = printable
        if primary:
            with open(os.path.join(trial_dir, "result.json"), "w") as f:
                json.dump(summary, f, indent=2, default=float)
        results.append((i, summary))

    if results:
        ranked = sorted(results, key=_best_cer)
        print("\n== sweep ranking (by best val CER) ==")
        for i, summary in ranked:
            print(f"trial {i:03d}: val_cer={summary.get('best_val_cer')} "
                  f"{summary.get('assignment')}")
        if primary:
            with open(os.path.join(args.out, "summary.json"), "w") as f:
                json.dump([{"trial": i, **s} for i, s in ranked], f, indent=2, default=float)

if __name__ == "__main__":
    main()
