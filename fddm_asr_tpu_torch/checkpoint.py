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
                       state_dicts (and a LoRA run's adapters), each AdamW
                       group's moments and count, the gradients a
                       grad_accum_steps run has gathered, the EMA, step,
                       epoch and best_val_cer;
  {prefix}.meta.json   the JAX sidecar's keys (epoch, ema_eval, has_ema,
                       train_encoder[, best_val_cer][, lora_rank,
                       lora_alpha]);
  {prefix}.encoder.pt  for a fine-tuned encoder: the `AcousticEncoder`
                       state_dict (the EMA's when ema_eval); for a LoRA run
                       the adapters alone ({module: {"a", "b"}}, the EMA's
                       when ema_eval), which `convert.load_encoder_weights`
                       merges at the sidecar's lora_alpha.  The inference
                       CLI's, the server's and the export CLI's
                       `--encoder-ckpt` take either.

Each file is written to a temporary name and renamed into place.  Given
an `AsyncWriter`, `save_ckpt` copies the state to the host before it
returns and the writer's background thread writes the files; the next
save waits for it, and `AsyncWriter.wait` waits too, raising in the
caller's thread when a write failed.

In a process group (`parallel/`) only the primary rank writes, and every
rank reads the same files.  Under tensor parallelism every rank first
gathers the full tensors of its slices (parameters, moments, EMA,
accumulated gradients) over "model", so the files are one process's, and
`restore_state` cuts a rank's slices out of them.

`restore_state` migrates the EMA: a checkpoint without one seeds a run with
an EMA from the restored weights, and a run without one drops the
checkpoint's.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from fddm_asr_tpu_torch.parallel import is_primary
from fddm_asr_tpu_torch.train_lib import MODULE_KEYS, TrainState

__all__ = ["module_state_dicts", "reference_ckpt", "save_reference_ckpt", "AsyncWriter",
           "save_ckpt", "load_state", "restore_state"]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _by_name(state: TrainState, full: bool) -> Callable[[str, str, torch.Tensor], torch.Tensor]:
    """fn(module key, parameter name, tensor) -> the tensor whole (`full`, a
    collective over "model" for a tensor-parallel slice) or cut to this
    rank's slice (a full tensor of a checkpoint); the tensor itself for
    what is not sliced."""
    from fddm_asr_tpu_torch.parallel import tensor as T

    axes = {key: T.sharded_axes(m) for key, m in zip(MODULE_KEYS, state.trained_modules())}

    def fn(key: str, name: str, t: torch.Tensor) -> torch.Tensor:
        ax = axes.get(key, {}).get(name)
        if ax is None:
            return t
        axis, shard = ax
        if full:
            return T.gather_tensor(t.detach(), axis, shard.group)
        return T.local_tensor(t, axis, shard.rank, shard.size)

    return fn


def module_state_dicts(state: TrainState, use_ema: bool) -> Dict[str, Dict[str, torch.Tensor]]:
    """Host state_dicts of the trained modules by MODULE_KEYS (the encoder's
    only when it trains), with the EMA in place of the trained parameters
    when `use_ema` and the state has one; tensor-parallel slices gathered
    whole (every rank of a "model" group calls it)."""
    full = _by_name(state, full=True)
    out = {key: {n: _host(full(key, n, v)) for n, v in m.state_dict().items()}
           for key, m in zip(MODULE_KEYS, state.trained_modules())}
    if use_ema and state.ema is not None:
        for (key, name), e in zip(state.param_names(), state.ema):
            if key in out:  # as float32 when the EMA is kept in bfloat16
                out[key][name] = _host(full(key, name, e)).to(out[key][name].dtype)
    return out


def _host_adapters(adapters) -> Dict[str, Dict[str, torch.Tensor]]:
    return {n: {ab: _host(t) for ab, t in ad.items()} for n, ad in adapters.items()}


def reference_ckpt(decoder: Dict[str, torch.Tensor],
                   s_proj: Optional[Dict[str, torch.Tensor]] = None,
                   t_embed: Optional[Dict[str, torch.Tensor]] = None,
                   t_proj: Optional[Dict[str, torch.Tensor]] = None, epoch: int = 0,
                   step: int = 0, config: Optional[dict] = None,
                   best_val_cer: Optional[float] = None) -> Dict[str, Any]:
    """The reference `.pt`'s dict from module state_dicts, in the JAX
    writer's key order (`export_reference_ckpt`): decoder, epoch, step,
    config, then the projection heads given and best_val_cer when given.
    `convert.load_reference_checkpoint` reads it back."""
    ckpt: Dict[str, Any] = {"decoder": decoder, "epoch": epoch, "step": step, "config": config}
    for key, sd in (("s_proj", s_proj), ("t_embed", t_embed), ("t_proj", t_proj)):
        if sd is not None:
            ckpt[key] = sd
    if best_val_cer is not None:
        ckpt["best_val_cer"] = float(best_val_cer)
    return ckpt


def save_reference_ckpt(path: str, decoder: Dict[str, torch.Tensor], *heads,
                        **meta) -> Dict[str, float]:
    """Write `reference_ckpt(decoder, *heads, **meta)` to `path` (a temporary
    name renamed into place); returns its bytes and seconds."""
    files: Dict[str, Dict[str, float]] = {}
    _write(reference_ckpt(decoder, *heads, **meta), path, files)
    return files[os.path.basename(path)]


def _write(obj, path: str, files: Dict[str, Dict[str, float]]) -> None:
    t0 = time.time()
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:  # a failed write leaves no partial file behind
        if os.path.exists(tmp):
            os.remove(tmp)
    files[os.path.basename(path)] = {"bytes": os.path.getsize(path),
                                     "seconds": time.time() - t0}


def _write_all(jobs: List[Tuple[Any, str]], files: Dict[str, Dict[str, float]],
               prefix: str) -> None:
    for obj, path in jobs:
        _write(obj, path, files)
    logging.info(f"checkpoint {prefix}: " + ", ".join(
        f"{n} {f['bytes']} B in {f['seconds']:.2f} s" for n, f in files.items()))


class AsyncWriter:
    """Writes the files of one save at a time in a background thread
    (log.async_checkpoint); a failed write raises from the next `wait`, in
    the caller's thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._prefix = ""

    def wait(self) -> None:
        """Block until the save in flight (if any) has written its files."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise RuntimeError(f"asynchronous checkpoint write failed: {self._prefix}") from error

    def submit(self, jobs: List[Tuple[Any, str]], files: Dict[str, Dict[str, float]],
               prefix: str) -> None:
        self.wait()
        self._prefix = prefix
        self._thread = threading.Thread(target=self._run, args=(jobs, files, prefix),
                                        name="checkpoint-writer")
        self._thread.start()

    def _run(self, jobs, files, prefix) -> None:
        try:
            _write_all(jobs, files, prefix)
        except Exception as e:  # raised in the caller's thread by wait()
            self._error = e


def save_ckpt(prefix: str, state: TrainState, epoch: int, raw_cfg: Optional[dict],
              best_val_cer: Optional[float], export_pt: bool,
              ema_export: bool = False, extra_meta: Optional[Dict[str, Any]] = None,
              writer: Optional[AsyncWriter] = None) -> Dict[str, Dict[str, float]]:
    """Write the files of `prefix` (module docstring), through `writer` in
    its background thread when one is given; returns each file's bytes and
    seconds by name (complete once `writer.wait()` returns).  `extra_meta`
    joins the sidecar (a LoRA run's lora_rank and lora_alpha).  In a
    process group only the primary rank writes; the others return {} (every
    rank holds the same state, or its slices of it, and every rank reads the
    files back); under tensor parallelism every rank must call it."""
    from fddm_asr_tpu_torch.parallel.tensor import is_sharded

    # every rank of a tensor-parallel group gathers its slices (collectives),
    # then the primary alone writes
    if not is_primary() and not any(is_sharded(m) for m in state.trained_modules()):
        return {}
    optimizer = state.optimizer
    full = _by_name(state, full=True)
    names = state.param_names()

    def whole(tensors) -> List[torch.Tensor]:
        return [_host(full(key, name, t)) for (key, name), t in zip(names, tensors)]

    raw = module_state_dicts(state, use_ema=False)
    mu, nu = whole(optimizer.mu), whole(optimizer.nu)
    acc = None if optimizer.acc is None else whole(optimizer.acc)
    ema = None if state.ema is None else whole(state.ema)
    exported = module_state_dicts(state, use_ema=ema_export) if ema_export else raw
    if not is_primary():
        return {}
    if writer is not None:
        writer.wait()  # one save at a time, in order
    files: Dict[str, Dict[str, float]] = {}
    jobs: List[Tuple[Any, str]] = []
    groups, start = [], 0
    for params, _ in optimizer.groups:
        stop = start + len(params)
        groups.append({"mu": mu[start:stop], "nu": nu[start:stop], "count": optimizer.count})
        start = stop
    jobs.append(({
        "modules": {key: raw.get(key) for key in MODULE_KEYS},
        "lora": None if state.lora is None else _host_adapters(state.lora),
        "optimizer": {"groups": groups, "notfinite_count": optimizer.notfinite_count,
                      "mini_step": optimizer.mini_step, "acc": acc},
        "ema": ema,
        "step": state.step, "epoch": epoch,
        "best_val_cer": float("inf") if best_val_cer is None else float(best_val_cer),
        "config": raw_cfg,
    }, prefix + ".state.pt"))
    meta = {"epoch": epoch, "ema_eval": bool(ema_export), "has_ema": state.ema is not None,
            "train_encoder": state.encoder is not None or state.lora is not None}
    if best_val_cer is not None:
        meta["best_val_cer"] = float(best_val_cer)
    meta.update(extra_meta or {})
    with open(prefix + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    if export_pt:
        jobs.append((reference_ckpt(
            exported["decoder"], exported["s_proj"], exported["t_embed"], exported["t_proj"],
            epoch=epoch, step=state.step, config=raw_cfg, best_val_cer=best_val_cer),
            prefix + ".pt"))
    if state.encoder is not None:
        jobs.append((exported["encoder"], prefix + ".encoder.pt"))
    elif state.lora is not None:
        adapters = state.adapters(use_ema=ema_export)
        jobs.append(({n: {ab: _host(t).float() for ab, t in ad.items()}
                      for n, ad in adapters.items()}, prefix + ".encoder.pt"))
    if writer is None:
        _write_all(jobs, files, prefix)
    else:
        writer.submit(jobs, files, prefix)
    return files


def load_state(path: str) -> Dict[str, Any]:
    """A `{prefix}.state.pt` on the host.  An orbax directory (the JAX
    package's training checkpoint) raises: it needs JAX to read."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"--resume {path}: a directory (an orbax checkpoint of the JAX package, which needs "
            "JAX to read), not a .state.pt; the port resumes only its own runs.  Where JAX is, "
            "scripts/export_torch_encoder.py --ckpt DIR --out E.pt --decoder-out D.pt writes "
            "that run's encoder (LoRA merged, EMA under ema_eval) and decoder for the port: "
            "start a run from D.pt with model.init_ckpt, or transcribe with --ckpt D.pt "
            "--encoder-ckpt E.pt")
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
    lora = blob.get("lora")
    if (lora is None) != (state.lora is None):
        trained = "trains" if lora is not None else "does not train"
        raise ValueError(f"the checkpoint's run {trained} LoRA adapters and this run does not "
                         "(model.encoder.lora_rank)")
    from fddm_asr_tpu_torch.parallel.tensor import local_state

    for key, m in zip(MODULE_KEYS, state.trained_modules()):
        m.load_state_dict(local_state(m, modules[key]), strict=True)
    local = _by_name(state, full=False)
    names = state.param_names()

    def mine(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """A checkpoint's full tensors cut to this rank's slices."""
        if len(tensors) != len(names):
            return tensors  # _copy_into names the mismatch
        return [local(key, name, t) for (key, name), t in zip(names, tensors)]

    if lora is not None:
        if set(lora) != set(state.lora):
            raise ValueError("the checkpoint's LoRA adapters are on other layers than this "
                             "run's (model.encoder.lora_targets)")
        _copy_into([t for n in state.lora for t in state.lora[n].values()],
                   [t for n in state.lora for t in (lora[n][ab] for ab in state.lora[n])],
                   "LoRA adapters")
    optimizer = state.optimizer
    groups = blob["optimizer"]["groups"]
    if len(groups) != len(optimizer.groups):
        raise ValueError(f"the checkpoint's optimizer has {len(groups)} groups, this run "
                         f"{len(optimizer.groups)}")
    _copy_into(optimizer.mu, mine([t for g in groups for t in g["mu"]]), "first moments")
    _copy_into(optimizer.nu, mine([t for g in groups for t in g["nu"]]), "second moments")
    if len({g["count"] for g in groups}) != 1:
        raise ValueError("the checkpoint's optimizer groups have different counts")
    optimizer.count = int(groups[0]["count"])
    optimizer.notfinite_count = int(blob["optimizer"]["notfinite_count"])
    acc = blob["optimizer"].get("acc")
    if (acc is None) != (optimizer.acc is None):
        raise ValueError("the checkpoint's run accumulates gradients and this run does not, "
                         "or the other way round (optim.grad_accum_steps)")
    if acc is not None:
        _copy_into(optimizer.acc, mine(acc), "accumulated gradients")
        optimizer.mini_step = int(blob["optimizer"]["mini_step"])
    state.step = int(blob["step"])
    if state.ema is not None:
        if blob["ema"] is None:  # the checkpoint ran without an EMA: seed it
            _copy_into(state.ema, [p.detach() for p in optimizer.params], "parameters")
        else:
            _copy_into(state.ema, mine(blob["ema"]), "EMA")
    return int(blob["epoch"]), float(blob["best_val_cer"])
