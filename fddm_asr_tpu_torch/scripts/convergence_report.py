# -*- coding: utf-8 -*-
"""Distill a training log into a convergence report.

    python -m fddm_asr_tpu_torch.scripts.convergence_report --log train.log \\
        --out report.json [--config cfg.yaml] [--note "..."]

Counterpart of `scripts/convergence_report.py`: the `[Epoch N Summary]
key=value | key=value` lines (`train_lib.run_training` writes them as the
JAX loop does) become a curve, with the best validation CER and its epoch,
the last epoch's fields, and the recipe's YAML text when --config is given,
so the report describes itself.  Prints a one-line JSON summary.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, List

__all__ = ["parse_log", "main"]

_LINE = re.compile(r"\[Epoch (\d+) Summary\] (.+)$")
_KV = re.compile(r"(\w+)=([\d.eE+-]+|nan|inf)")


def parse_log(path: str) -> List[Dict[str, float]]:
    """One row per epoch summary line, with every numeric key=value field
    on it, whatever their set or order."""
    curve = []
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            m = _LINE.search(line)
            if not m:
                continue
            row = {"epoch": int(m.group(1))}
            for k, v in _KV.findall(m.group(2)):
                try:
                    row[k] = float(v)
                except ValueError:
                    continue
            curve.append(row)
    return curve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default=None, help="YAML recipe to embed (resolved text)")
    ap.add_argument("--note", default="")
    args = ap.parse_args(argv)

    curve = parse_log(args.log)
    if not curve:
        sys.exit(f"no epoch summaries found in {args.log}")
    evals = [r for r in curve if "val_cer" in r]
    best = min(evals, key=lambda r: r["val_cer"]) if evals else None
    report = {
        "note": args.note,
        "epochs_run": curve[-1]["epoch"],
        "best_val_cer": best["val_cer"] if best else None,
        "best_epoch": best["epoch"] if best else None,
        "final": curve[-1],
        "eval_curve": evals,
        "train_loss_curve": [{"epoch": r["epoch"], "train_loss": r["train_loss"]}
                             for r in curve],
    }
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            report["recipe_yaml"] = f.read()
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, ensure_ascii=False)
    summary = {"out": args.out, "epochs": report["epochs_run"],
               "best_val_cer": report["best_val_cer"], "best_epoch": report["best_epoch"]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
