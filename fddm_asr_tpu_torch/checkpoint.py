# -*- coding: utf-8 -*-
"""Training checkpoints: the reference `.pt`, the resumable state, the sidecar.

Counterpart of `fddm_asr_tpu/checkpoint.py` (sidecar, `.pt` export), of
`fddm_asr_tpu/convert/torch_ckpt.py`'s `.pt` writer and of the JAX loop's
`_save_ckpt` and `--resume`.  The port has no orbax: a checkpoint prefix
(`<ckpt_dir>/ep001`, `<ckpt_dir>/best_model`) writes

  {prefix}.pt          the reference format ({decoder, s_proj, t_embed, t_proj,
                       epoch, step, config[, best_val_cer]}), which this
                       package's and the JAX package's loaders read; the EMA
                       weights when the run evaluates with them (ema_eval).
                       A learned-position decoder keeps `pos_emb.weight`
                       (the JAX writer drops it);
  {prefix}.state.pt    what `--resume` reads: the trained modules'
                       state_dicts, each AdamW group's moments and count,
                       the EMA, step, epoch and best_val_cer;
  {prefix}.meta.json   the JAX sidecar's keys (epoch, ema_eval, has_ema,
                       train_encoder[, best_val_cer]);
  {prefix}.encoder.pt  for a fine-tuned encoder: the `AcousticEncoder`
                       state_dict (the EMA's when ema_eval), as the
                       inference CLI's and the server's `--encoder-ckpt`
                       take it.

`restore_state` migrates the EMA: a checkpoint without one seeds a run with
an EMA from the restored weights, and a run without one drops the
checkpoint's.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from fddm_asr_tpu_torch.train_lib import MODULE_KEYS, TrainState

__all__ = ["module_state_dicts", "save_ckpt", "load_state", "restore_state"]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def module_state_dicts(state: TrainState, use_ema: bool) -> Dict[str, Dict[str, torch.Tensor]]:
    """Host state_dicts of the trained modules by MODULE_KEYS (the encoder's
    only when it trains), with the EMA in place of the trained parameters
    when `use_ema` and the state has one."""
    out = {key: {n: _host(v) for n, v in m.state_dict().items()}
           for key, m in zip(MODULE_KEYS, state.trained_modules())}
    if use_ema and state.ema is not None:
        for (key, name), e in zip(state.param_names(), state.ema):
            out[key][name] = _host(e)
    return out


def _timed_save(obj, path: str, files: Dict[str, Dict[str, float]]) -> None:
    t0 = time.time()
    torch.save(obj, path)
    files[os.path.basename(path)] = {"bytes": os.path.getsize(path),
                                     "seconds": time.time() - t0}


def save_ckpt(prefix: str, state: TrainState, epoch: int, raw_cfg: Optional[dict],
              best_val_cer: Optional[float], export_pt: bool,
              ema_export: bool = False) -> Dict[str, Dict[str, float]]:
    """Write the files of `prefix` (module docstring); returns each file's
    bytes and seconds by name."""
    files: Dict[str, Dict[str, float]] = {}
    optimizer = state.optimizer
    groups, start = [], 0
    for params, _ in optimizer.groups:
        stop = start + len(params)
        groups.append({"mu": [_host(t) for t in optimizer.mu[start:stop]],
                       "nu": [_host(t) for t in optimizer.nu[start:stop]],
                       "count": optimizer.count})
        start = stop
    raw = module_state_dicts(state, use_ema=False)
    _timed_save({
        "modules": {key: raw.get(key) for key in MODULE_KEYS},
        "optimizer": {"groups": groups, "notfinite_count": optimizer.notfinite_count},
        "ema": None if state.ema is None else [_host(e) for e in state.ema],
        "step": state.step, "epoch": epoch,
        "best_val_cer": float("inf") if best_val_cer is None else float(best_val_cer),
        "config": raw_cfg,
    }, prefix + ".state.pt", files)
    meta = {"epoch": epoch, "ema_eval": bool(ema_export), "has_ema": state.ema is not None,
            "train_encoder": state.encoder is not None}
    if best_val_cer is not None:
        meta["best_val_cer"] = float(best_val_cer)
    with open(prefix + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    exported = module_state_dicts(state, use_ema=ema_export) if ema_export else raw
    if export_pt:
        ckpt = {"decoder": exported["decoder"], "epoch": epoch, "step": state.step,
                "config": raw_cfg, "s_proj": exported["s_proj"],
                "t_embed": exported["t_embed"], "t_proj": exported["t_proj"]}
        if best_val_cer is not None:
            ckpt["best_val_cer"] = float(best_val_cer)
        _timed_save(ckpt, prefix + ".pt", files)
    if state.encoder is not None:
        _timed_save(exported["encoder"], prefix + ".encoder.pt", files)
    logging.info(f"checkpoint {prefix}: " + ", ".join(
        f"{n} {f['bytes']} B in {f['seconds']:.2f} s" for n, f in files.items()))
    return files


def load_state(path: str) -> Dict[str, Any]:
    """A `{prefix}.state.pt` on the host.  An orbax directory (the JAX
    package's training checkpoint) raises: it needs JAX to read."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"--resume {path}: a directory (an orbax checkpoint of the JAX package, which needs "
            "JAX to read), not a .state.pt; the port resumes only its own runs.  Where JAX is, "
            "scripts/export_torch_encoder.py writes the encoder for the port (ROADMAP A1 adds "
            "the trained checkpoint); start a run from the decoder .pt with model.init_ckpt")
    return torch.load(path, map_location="cpu", weights_only=True)


def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor], what: str) -> None:
    if len(dst) != len(src) or any(d.shape != s.shape for d, s in zip(dst, src)):
        raise ValueError(f"checkpoint {what} do not fit this run's parameters "
                         f"({len(src)} tensors for {len(dst)})")
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(s)


def restore_state(state: TrainState, blob: Dict[str, Any]) -> Tuple[int, float]:
    """Load a `load_state` blob into `state` bit for bit (modules, moments,
    counts, step, EMA, with the EMA migration of the module docstring);
    returns (the checkpoint's epoch, its best_val_cer, inf when none)."""
    modules = blob["modules"]
    if (modules.get("encoder") is None) != (state.encoder is None):
        trained = "trains" if modules.get("encoder") is not None else "freezes"
        raise ValueError(f"the checkpoint's run {trained} the encoder and this run does not "
                         "(model.encoder.freeze)")
    for key, m in zip(MODULE_KEYS, state.trained_modules()):
        m.load_state_dict(modules[key], strict=True)
    optimizer = state.optimizer
    groups = blob["optimizer"]["groups"]
    if len(groups) != len(optimizer.groups):
        raise ValueError(f"the checkpoint's optimizer has {len(groups)} groups, this run "
                         f"{len(optimizer.groups)}")
    _copy_into(optimizer.mu, [t for g in groups for t in g["mu"]], "first moments")
    _copy_into(optimizer.nu, [t for g in groups for t in g["nu"]], "second moments")
    if len({g["count"] for g in groups}) != 1:
        raise ValueError("the checkpoint's optimizer groups have different counts")
    optimizer.count = int(groups[0]["count"])
    optimizer.notfinite_count = int(blob["optimizer"]["notfinite_count"])
    state.step = int(blob["step"])
    if state.ema is not None:
        if blob["ema"] is None:  # the checkpoint ran without an EMA: seed it
            _copy_into(state.ema, [p.detach() for p in optimizer.params], "parameters")
        else:
            _copy_into(state.ema, blob["ema"], "EMA")
    return int(blob["epoch"]), float(blob["best_val_cer"])
