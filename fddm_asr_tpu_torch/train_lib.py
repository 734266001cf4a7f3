# -*- coding: utf-8 -*-
"""Training: learning-rate schedule, AdamW, the train state, the train steps and the loop.

Counterpart of `fddm_asr_tpu/train_lib.py` (`_lr_schedule`,
`make_optimizer`, `TrainState`, `make_train_step`, `run_training`,
`setup_logging`, `RunLock`, `_ensure_feature_cache`):

  * the loss is the diffusion KL (`diffusion.kl_term_sparse` by default,
    `optim.kl_impl: dense` for the reference's form) plus, on L_fd steps,
    tau * mean(w_t) * L_fd over the projection heads;
  * AdamW with one global-norm gradient clip over every trained parameter,
    in two groups when the encoder trains (`optim.encoder_lr`), with
    optional 1-D decay exclusion and non-finite-update skipping, the first
    moment optionally stored in bfloat16 (`optim.adam_mu_dtype`), and
    gradient accumulation (`optim.grad_accum_steps`, optax.MultiSteps);
  * an EMA of the trained parameters (`optim.ema_decay`), optionally stored
    in bfloat16 (`optim.ema_dtype`);
  * the fine-tune step (model.encoder.freeze: false) runs WavLM in training
    mode with SpecAugment inside the differentiated graph; with
    model.encoder.lora_rank r > 0 the encoder stays frozen and rank-r
    adapters train in its place (`models/lora.py`: merged once a step,
    differentiably); the frozen step encodes under no_grad (the inference
    kernel on a GPU); the feature-cache step takes the frozen encoder's
    output from `data/feature_cache.py`;
  * `run_training`: manifests through `data/dataset.py`, the feature cache
    (device-resident up to 2 GiB), the L_fd schedule over global steps,
    evaluation with the port's `eval` (EMA weights under optim.ema_eval,
    LoRA adapters merged), best-model selection, early stop,
    collapse_restore, checkpoints (written in a background thread under
    log.async_checkpoint) and `--resume` through `checkpoint.py`.  Each step's draws come from one
    device generator reseeded per step from np.random.default_rng(seed), as
    the JAX loop seeds its step keys, so a resumed run restarts the stream.

The optimizer reproduces optax's arithmetic (the JAX package's): the
schedule is read at the update count BEFORE the update (so under linear
warmup the first update has lr 0); the clip scales by max/norm with no
epsilon (`torch.nn.utils.clip_grad_norm_` adds 1e-6); decoupled weight
decay is p -= lr * (adam + wd * p); parameters with no gradient in a step
(the projection heads on a non-L_fd step) count as zero gradients, so their
moments decay and weight decay still applies, as in optax.  Under
grad_accum_steps k each micro-step's gradients go into optax.MultiSteps'
running mean acc + (g - acc) / (n + 1); every k-th micro-step the clip,
the non-finite check, AdamW and the schedule (which counts these updates)
see that mean, and the other micro-steps change no parameter.  The step
counter (the L_fd period, logging, the EMA's ramp) counts micro-steps, and
the EMA updates on every one, as in the JAX step.  A bfloat16 first moment
is (1 - b1) g + bf16(b1) mu in float32 (optax's weakly typed b1 meets a
bfloat16 mu and becomes a bfloat16 constant; XLA keeps the product in
float32), used unrounded for the update and stored rounded; a bfloat16 EMA
is e + bf16(1 - decay) (bf16(p) - e), computed in float32 and rounded once
to bfloat16, the dtype JAX's promotion gives that expression.

RNG: `torch.Generator` and `jax.random` give different numbers, so the
step takes a generator and also accepts the timesteps `t`, the corrupted
tokens `xt` and the SpecAugment masks ready-made (the tests hand it the JAX
step's own draws).  Decoder and encoder dropout draw from torch's default
generator of the device; the encoder's attention dropout (training with
attention_dropout > 0) takes its per-layer mask seeds from the step's
generator (`models/wavlm.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import sys
import tempfile
import time
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fddm_asr_tpu_torch import diffusion as D
from fddm_asr_tpu_torch import parallel as P
from fddm_asr_tpu_torch.config import Config, resolve_special_ids
from fddm_asr_tpu_torch.losses import align_speech_to_text, lfd_loss
from fddm_asr_tpu_torch.models import lora as LO
from fddm_asr_tpu_torch.models.projection import SpeechProjector, TextEmbedding, TextProjector
from fddm_asr_tpu_torch.models.wavlm import sample_time_mask
from fddm_asr_tpu_torch.pipeline import random_init_

__all__ = ["AdamW", "TrainState", "lr_schedule", "make_optimizer",
           "make_projection_heads", "init_train_state", "make_train_step", "setup_logging",
           "RunLock", "run_training"]

Schedule = Callable[[int], float]


def _linear_ramp(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `steps` updates, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def lr_schedule(optim: Config, lr: float, warmup: int) -> Schedule:
    """The learning rate at update count `count` (0 for the first update).

    optim.lr_schedule: "constant" (default; a linear warmup from 0 when
    warmup_steps > 0), "cosine" or "linear" (warmup, then decay to
    optim.end_lr at optim.decay_steps, which counts the warmup too)."""
    kind = optim.get("lr_schedule", "constant")
    if kind == "constant":
        return _linear_ramp(0.0, lr, warmup) if warmup else (lambda count: lr)
    decay_steps = int(optim.get("decay_steps", 0) or 0)
    if decay_steps <= warmup:
        raise ValueError(f"optim.lr_schedule={kind!r} needs optim.decay_steps > "
                         f"warmup_steps (got {decay_steps} vs {warmup})")
    end = float(optim.get("end_lr", 0.0))
    warm = _linear_ramp(0.0, lr, warmup)
    if kind == "cosine":
        alpha = 0.0 if lr == 0.0 else end / lr
        span = decay_steps - warmup

        def decay(count):
            cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, span) / span))
            return lr * ((1.0 - alpha) * cosine + alpha)
    elif kind == "linear":
        decay = _linear_ramp(lr, end, decay_steps - warmup)
    else:
        raise ValueError(f"unknown optim.lr_schedule {kind!r} (constant | cosine | linear)")
    return lambda count: warm(count) if count < warmup else decay(count - warmup)


def _global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _cast(tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """Copies of `tensors` in `dtype`, made by one foreach copy."""
    out = [torch.empty_like(t, dtype=dtype) for t in tensors]
    torch._foreach_copy_(out, tensors)
    return out


def bf16_constant(x: float) -> float:
    """`x` rounded to bfloat16: a weakly typed Python float meeting a
    bfloat16 array in JAX becomes this constant."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw per group), optionally
    inside apply_if_finite, optionally inside optax.MultiSteps (`accum_steps`
    > 1), over parameter groups that update together.

    groups: [(parameters, schedule)], one per learning-rate group.  The
    second moment is float32 like the parameters; the first is `mu_dtype`
    (float32, or bfloat16 as optax's mu_dtype).  `step(grads)` returns the
    pre-clip global norm of the gradients it was given (a 0-d tensor) and
    whether parameters were updated."""

    def __init__(self, groups: Sequence[Tuple[Sequence[nn.Parameter], Schedule]],
                 weight_decay: float = 0.01, decay_exclude_1d: bool = False,
                 clip: float = 5.0, skip_nonfinite: int = 0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.float32, accum_steps: int = 1,
                 reduce: Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]] = None,
                 norm: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None):
        self.groups = [(list(ps), sched) for ps, sched in groups]
        # the gradient reduction over a process group (parallel.gradient_reducer),
        # applied to an update's gradients: once an update under accumulation
        self.reduce = reduce
        # the global norm (of the whole model's gradients under tensor
        # parallelism: parallel.gradient_norm)
        self.norm = norm or _global_norm
        self.params: List[nn.Parameter] = [p for ps, _ in self.groups for p in ps]
        self.weight_decay = weight_decay
        self.decayed = [i for i, p in enumerate(self.params)
                        if not decay_exclude_1d or p.dim() >= 2]
        self.clip = clip
        self.skip_nonfinite = skip_nonfinite
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0            # updates applied (each group's optax count)
        self.notfinite_count = 0  # consecutive non-finite steps
        # optax.MultiSteps: the micro-steps gathered so far and their mean
        self.accum_steps = max(1, int(accum_steps))
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params] if self.accum_steps > 1
                    else None)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> Tuple[torch.Tensor, bool]:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if self.acc is None:
            if self.reduce is not None:
                grads = self.reduce(grads)
            norm = self.norm(grads)
            return norm, self._update(grads, norm)
        # optax.MultiSteps' running mean (of this rank's gradients in a process
        # group, reduced once an update; `norm` is then this rank's micro-step's)
        norm = self.norm(grads)
        acc = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(acc, self.mini_step + 1)
        torch._foreach_add_(acc, self.acc)
        if self.mini_step < self.accum_steps - 1:
            self.acc, self.mini_step = acc, self.mini_step + 1
            return norm, False
        torch._foreach_zero_(self.acc)  # the mean so far, now in `acc`
        self.mini_step = 0
        if self.reduce is not None:
            acc = self.reduce(acc)
        return norm, self._update(acc, self.norm(acc))

    def _update(self, grads: List[torch.Tensor], norm: torch.Tensor) -> bool:
        if self.skip_nonfinite > 0:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= self.skip_nonfinite:
                return False
        if not bool(norm < self.clip):  # optax: t / norm * max, no epsilon
            grads = torch._foreach_div(grads, norm)
            torch._foreach_mul_(grads, self.clip)

        b1, b2 = self.b1, self.b2
        if self.mu[0].dtype == torch.bfloat16:
            # (1 - b1) g + bf16(b1) mu in float32 (module docstring); the float32
            # mean feeds this update, rounded when stored
            mu = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu, _cast(self.mu, torch.float32), alpha=bf16_constant(b1))
        else:
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
            mu = self.mu
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        del grads
        c = self.count + 1
        update = torch._foreach_div(self.nu, 1.0 - b2 ** c)
        torch._foreach_sqrt_(update)
        torch._foreach_add_(update, self.eps)
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** c)
        if mu is not self.mu:
            torch._foreach_copy_(self.mu, mu)
        del mu
        torch._foreach_div_(mu_hat, update)
        update = mu_hat  # mu_hat / (sqrt(nu_hat) + eps)
        if self.weight_decay:
            torch._foreach_add_([update[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed], alpha=self.weight_decay)
        start = 0
        for params, schedule in self.groups:  # each group's lr at the count before
            lr = schedule(self.count)
            torch._foreach_add_(params, update[start:start + len(params)], alpha=-lr)
            start += len(params)
        self.count = c
        return True


def state_dtype(optim: Config, key: str) -> torch.dtype:
    """optim.adam_mu_dtype / optim.ema_dtype: "bfloat16", else float32 (the
    JAX package reads any other value as its default)."""
    return torch.bfloat16 if optim.get(key) == "bfloat16" else torch.float32


def make_optimizer(cfg: Config, main_params: Sequence[nn.Parameter],
                   encoder_params: Optional[Sequence[nn.Parameter]] = None,
                   reduce=None, norm=None) -> AdamW:
    """AdamW from cfg.optim (lr 2e-4, weight_decay 0.01, grad_clip 5.0 by
    default); a second group at optim.encoder_lr (default optim.lr) when
    `encoder_params` is given (the encoder, or its LoRA adapters), under the
    same global clip; optim.adam_mu_dtype and optim.grad_accum_steps;
    `reduce` the gradient reduction of a process group, `norm` its global
    norm under tensor parallelism."""
    optim = cfg.optim
    lr = float(optim.get("lr", 2e-4))
    warmup = int(optim.get("warmup_steps", 0) or 0)
    groups = [(list(main_params), lr_schedule(optim, lr, warmup))]
    if encoder_params is not None:
        enc_lr = float(optim.get("encoder_lr", lr))
        groups.append((list(encoder_params), lr_schedule(optim, enc_lr, warmup)))
    return AdamW(groups, weight_decay=float(optim.get("weight_decay", 0.01)),
                 decay_exclude_1d=bool(optim.get("decay_exclude_1d", False)),
                 clip=float(optim.get("grad_clip", 5.0)),
                 skip_nonfinite=int(optim.get("skip_nonfinite_updates", 0) or 0),
                 mu_dtype=state_dtype(optim, "adam_mu_dtype"),
                 accum_steps=int(optim.get("grad_accum_steps", 1) or 1), reduce=reduce,
                 norm=norm)


@dataclasses.dataclass
class TrainState:
    """The trained modules, their optimizer, the micro-step count and the EMA.

    `ema` mirrors `optimizer.params` (decoder, s_proj, t_embed, t_proj,
    then the encoder's trained parameters or the LoRA adapters); None when
    optim.ema_decay is 0.  `encoder` is None for frozen-encoder and LoRA
    training; `lora` holds the adapters ({module name: {"a", "b"}}, each an
    nn.Parameter) and `lora_scale` their merge scale."""

    decoder: nn.Module
    s_proj: SpeechProjector
    t_embed: TextEmbedding
    t_proj: TextProjector
    optimizer: AdamW
    encoder: Optional[nn.Module] = None
    step: int = 0
    ema: Optional[List[torch.Tensor]] = None
    lora: Optional[Dict[str, Dict[str, nn.Parameter]]] = None
    lora_scale: float = 0.0

    def trained_modules(self) -> List[nn.Module]:
        mods = [self.decoder, self.s_proj, self.t_embed, self.t_proj]
        return mods + ([self.encoder] if self.encoder is not None else [])

    def param_names(self) -> List[Tuple[str, str]]:
        """(module key, parameter name) of each of `optimizer.params`, in
        order; the keys are MODULE_KEYS."""
        names = [(key, n) for key, m in zip(MODULE_KEYS, self.trained_modules()[:4])
                 for n, _ in m.named_parameters()]
        if self.encoder is not None:
            names += [("encoder", n) for n, p in self.encoder.named_parameters()
                      if p.requires_grad]
        if self.lora is not None:
            names += [("lora", f"{n}.{ab}") for n, ad in self.lora.items() for ab in ad]
        return names

    def adapters(self, use_ema: bool = False) -> LO.Adapters:
        """The LoRA adapters, or their EMA (`use_ema` and an EMA kept)."""
        if not use_ema or self.ema is None:
            return self.lora
        ema = {name: e for (key, name), e in zip(self.param_names(), self.ema) if key == "lora"}
        return {n: {ab: ema[f"{n}.{ab}"] for ab in ad} for n, ad in self.lora.items()}


MODULE_KEYS = ("decoder", "s_proj", "t_embed", "t_proj", "encoder")


def make_projection_heads(cfg: Config, device, dtype: torch.dtype,
                          generator: Optional[torch.Generator] = None):
    """(SpeechProjector, TextEmbedding, TextProjector) of width
    model.projector.d_proj (default 256), torch's default init drawn from
    `generator`."""
    d_proj = cfg.model.get("projector", Config()).get("d_proj", 256)
    with torch.device(device):
        heads = (SpeechProjector(cfg.model.d_model, d_proj, dtype=dtype),
                 TextEmbedding(cfg.data.vocab_size, d_proj, dtype=dtype),
                 TextProjector(d_proj, d_proj, dtype=dtype))
    if generator is not None:
        for head in heads:
            random_init_(head, generator)
    return heads


def training_pipeline(cfg: Config, wavlm_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                      encoder_state_dict=None, device: Optional[str] = None, tokenizer=None):
    """The pipeline a training run starts from, as `run_training` builds it:
    the config's seed (default 1337), the training compute dtype
    (optim.dtype over model.dtype, default bfloat16; parameters stay
    float32), the decoder of model.init_ckpt when set (a warm start),
    `wavlm_state_dict` and then `encoder_state_dict` (as
    `FDDMPipeline.from_config` takes them) in the encoder."""
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline

    dtype = cfg.optim.get("dtype", cfg.model.get("dtype", "bfloat16"))
    return FDDMPipeline.from_config(cfg, ckpt_path=cfg.model.get("init_ckpt"),
                                    wavlm_state_dict=wavlm_state_dict,
                                    encoder_state_dict=encoder_state_dict, tokenizer=tokenizer,
                                    device=device, dtype=dtype,
                                    seed=int(cfg.get("seed", 1337)))


def training_heads(cfg: Config, pipeline):
    """The projection heads a training run starts from (`make_projection_heads`
    on the pipeline's device and dtype, drawn from a generator seeded by the
    config's seed + 1)."""
    gen = torch.Generator(device=pipeline.device).manual_seed(int(cfg.get("seed", 1337)) + 1)
    return make_projection_heads(cfg, pipeline.device, pipeline.decoder.dtype, gen)


def training_dataset(cfg: Config, manifest_path: str, tokenizer):
    """A manifest as the training run reads it: data.max_len (default 128)
    ids, data.max_seconds (default 20) of audio, the special ids of
    `resolve_special_ids`, data.bos_id and data.eos_id."""
    from fddm_asr_tpu_torch.data.dataset import ManifestDataset

    data_cfg = cfg.data
    return ManifestDataset(manifest_path, tokenizer, max_len=data_cfg.get("max_len", 128),
                           pad_id=resolve_special_ids(cfg)["pad_id"],
                           bos_id=data_cfg.get("bos_id"), eos_id=data_cfg.get("eos_id"),
                           max_audio_seconds=data_cfg.get("max_seconds", 20),
                           sample_rate=data_cfg.get("sample_rate", 16000))


def init_train_state(pipeline, cfg: Config, train_encoder: Optional[bool] = None,
                     heads=None, generator: Optional[torch.Generator] = None,
                     mesh=None) -> TrainState:
    """A fresh TrainState over the pipeline's decoder (and encoder, when it
    trains: model.encoder.freeze false) plus projection heads (`heads`, or
    new ones drawn from `generator`).  A frozen conv front-end
    (freeze_feature_extractor) is left out of the optimizer altogether.
    With model.encoder.lora_rank r > 0 the encoder is frozen whole and
    rank-r adapters on the layers model.encoder.lora_targets matches
    (default `lora.DEFAULT_TARGETS`) train in its place: A drawn from a
    generator seeded by the config's seed + 7 (the JAX package's key),
    B = 0, scale lora_alpha / r.  On a `mesh` over a process group the
    optimizer reduces the gradients of each update (`parallel.gradient_reducer`:
    the parts summed over "model" that `_gradient_classes` names, everything
    averaged over "data"), and under tensor parallelism clips by the whole
    model's norm (`parallel.gradient_norm`).  AdamW's moments and the EMA
    mirror the parameters, so a tensor-parallel rank keeps its slices'."""
    enc_cfg = cfg.model.get("encoder", Config())
    if train_encoder is None:
        train_encoder = not enc_cfg.get("freeze", True)
    lora_rank = int(enc_cfg.get("lora_rank", 0) or 0)
    if lora_rank > 0 and not train_encoder:
        raise ValueError(LORA_NEEDS_FINE_TUNE)
    if heads is None:
        heads = make_projection_heads(cfg, pipeline.device, pipeline.decoder.dtype, generator)
    main = [p for m in (pipeline.decoder, *heads) for p in m.parameters()]
    encoder = adapters = None
    enc_params = None
    lora_scale = 0.0
    if train_encoder:
        encoder = pipeline.encoder
        if encoder.freeze:
            raise ValueError("train_encoder=True needs an encoder built with "
                             "model.encoder.freeze: false")
        if lora_rank > 0:
            encoder.requires_grad_(False)
            gen = torch.Generator(device=pipeline.device).manual_seed(
                int(cfg.get("seed", 1337)) + 7)
            adapters = {name: {k: nn.Parameter(t) for k, t in ad.items()}
                        for name, ad in LO.init_lora(
                            encoder, lora_rank, enc_cfg.get("lora_targets", LO.DEFAULT_TARGETS),
                            gen).items()}
            enc_params = [t for ad in adapters.values() for t in ad.values()]
            lora_scale = LO.resolve_scale(lora_rank, enc_cfg.get("lora_alpha"))
            encoder = None
        else:
            encoder.backbone.feature_extractor.requires_grad_(
                not encoder.config.freeze_feature_extractor)
            enc_params = [p for p in encoder.parameters() if p.requires_grad]
    reduce = norm = None
    if mesh is not None:
        summed, sharded = _gradient_classes(pipeline, main, enc_params, adapters)
        reduce = P.gradient_reducer(mesh, summed)
        norm = P.gradient_norm(mesh, sharded)
    optimizer = make_optimizer(cfg, main, enc_params, reduce=reduce, norm=norm)
    ema = None
    if float(cfg.optim.get("ema_decay", 0.0) or 0.0) > 0.0:
        ema_dtype = state_dtype(cfg.optim, "ema_dtype")
        ema = [p.detach().to(ema_dtype, copy=True) for p in optimizer.params]
    return TrainState(pipeline.decoder, *heads, optimizer=optimizer, encoder=encoder, ema=ema,
                      lora=adapters, lora_scale=lora_scale)


def _gradient_classes(pipeline, main, enc_params, adapters):
    """(summed, sharded): the indices of the optimizer's parameters (`main`
    then `enc_params`) whose gradients are summed over "model", and those
    that are a rank's slice of a tensor-parallel weight.  On a
    sequence-parallel ring every encoder gradient (or adapter) is summed;
    under tensor parallelism the partial ones (`parallel.tensor.
    parameter_kinds`) and the adapters of sliced layers; the sliced weights
    themselves are complete."""
    from fddm_asr_tpu_torch.parallel import tensor as T

    params = list(main) + list(enc_params or [])
    if pipeline.encoder.backbone.encoder.ring is not None:
        return list(range(len(main), len(params))), []
    kinds = {}
    for module in (pipeline.decoder, pipeline.encoder):  # the projection heads stay whole
        named = dict(module.named_parameters())
        for name, kind in T.parameter_kinds(module).items():
            kinds[id(named[name])] = kind
    if adapters is not None:
        modules = dict(pipeline.encoder.named_modules())
        for name, ad in adapters.items():
            if "_tp" in modules[name].__dict__:
                for t in ad.values():
                    kinds[id(t)] = "partial"
    summed = [i for i, p in enumerate(params) if kinds.get(id(p)) == "partial"]
    sharded = [i for i, p in enumerate(params) if kinds.get(id(p)) == "sharded"]
    return summed, sharded


LORA_NEEDS_FINE_TUNE = ("encoder.lora_rank > 0 requires model.encoder.freeze: false (LoRA is a "
                        "fine-tuning mode; with freeze: true it would be a silent no-op)")


@torch.no_grad()
def update_ema(ema: List[torch.Tensor], params: Sequence[torch.Tensor], decay_cap: float,
               step: int) -> None:
    """One EMA update after micro-step `step` (1-based): decay
    min(decay_cap, (1 + step) / (10 + step)), as the JAX step computes it in
    float32; a bfloat16 EMA in bfloat16 (module docstring)."""
    decay = np.minimum(np.float32(decay_cap), np.float32(1 + step) / np.float32(10 + step))
    weight = float(np.float32(1.0) - decay)
    if ema[0].dtype == torch.bfloat16:
        wide = _cast(ema, torch.float32)
        diff = torch._foreach_sub(_cast(_cast(params, torch.bfloat16), torch.float32), wide)
        torch._foreach_add_(wide, diff, alpha=bf16_constant(weight))
        torch._foreach_copy_(ema, wide)
    else:
        torch._foreach_add_(ema, torch._foreach_sub(params, ema), alpha=weight)


def make_train_step(pipeline, cfg: Config, train_encoder: bool = False,
                    cached_features: bool = False, mesh=None):
    """Returns step(state, wave, x0, apply_lfd=None, lengths=None,
    generator=None, t=None, xt=None, time_mask=None, feat_mask=None) -> metrics.

    One optimizer update of `state` in place.  `step.forward(state, wave,
    x0, apply_lfd, ...)` is the same step's loss and metrics without the
    update (draws as `step` takes them), for reading gradients.  apply_lfd=None takes the
    L_fd schedule: every lfd.n_step_fd-th step (1-based), unless lfd is
    disabled.  train_encoder=True is the fine-tune step (the encoder trains,
    in training mode, with SpecAugment masks drawn unless given); False the
    frozen step; a state with LoRA adapters (`state.lora`) runs the
    fine-tune step with the encoder frozen and W + s (A B)^T in each
    adapted layer, merged once a step and held across its forward and
    backward (`step.merged(state)`, a `lora.installed` block; `step` holds
    it itself, a caller of `step.forward` must, or `forward` raises).
    Metrics (0-d
    tensors): loss_diff, total_loss, grad_norm (the micro-step's, before
    the clip), and on L_fd steps loss_fd and w_t.

    cached_features=True returns the feature-cache step instead,
    step(state, c, x0, apply_lfd=None, c_mask=None, generator=None, t=None,
    xt=None) (and its `.forward`): `c` [B, S, d] is the frozen encoder's
    output read from `data/feature_cache.py` and `c_mask` an optional [B, S]
    frame mask; the encoder does not run.  It shares the loss and the update
    with the wave step, so on the same `c` and draws it is the frozen step.

    On a `mesh` whose "data" axis has D > 1 ranks, each rank's step takes its
    rows of a global batch of D equal parts (x0, wave, c: the rank's rows)
    and computes what the one-process step computes on the global batch: t,
    x_t and the SpecAugment masks are drawn (or given) for the global batch,
    the same on every rank from the same generator state, and each rank
    takes its rows, so every row meets the noise it meets in one process;
    L_fd standardises over the global batch (z_speech and z_text gathered,
    `parallel.gather`) and w_t is the mean over the global t; the metrics
    are the global batch's.  The gradients are reduced by the state's
    optimizer (`init_train_state(mesh=...)`).  Dropout masks are drawn per
    rank, for its rows."""
    if train_encoder and cached_features:
        raise ValueError("cached_features is incompatible with train_encoder "
                         "(fine-tuning changes the features every step)")
    if train_encoder and pipeline.encoder.freeze:
        raise ValueError("train_encoder=True but the encoder was built with freeze: true; "
                         "set model.encoder.freeze: false")
    sched = pipeline.sched
    pad_id = pipeline.pad_id
    T_total = cfg.diffusion["T"]
    lfd_cfg = cfg.get("lfd", Config())
    tau = float(lfd_cfg.get("tau", 1.0))
    lambda_off = float(lfd_cfg.get("lambda_offdiag", 5e-3))
    n_step_fd = int(lfd_cfg.get("n_step_fd", 4))
    lfd_enabled = bool(lfd_cfg.get("enabled", True)) and tau != 0.0
    mask_pad_loss = bool(cfg.optim.get("mask_pad_loss", True))
    kl_fn = D.kl_term if cfg.optim.get("kl_impl") == "dense" else D.kl_term_sparse
    ema_decay = float(cfg.optim.get("ema_decay", 0.0) or 0.0)
    enc_cfg = cfg.model.get("encoder", Config())
    mask_time_prob = float(enc_cfg.get("mask_time_prob", 0.0))
    mask_time_length = int(enc_cfg.get("mask_time_length", 10))
    mask_feature_prob = float(enc_cfg.get("mask_feature_prob", 0.0))
    mask_feature_length = int(enc_cfg.get("mask_feature_length", 10))
    encoder = pipeline.encoder
    dev = pipeline.device
    data_group = mesh.data_group if mesh is not None and mesh.shape["data"] > 1 else None

    def as_tensor(x, dtype=None):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)

    def rows(x: torch.Tensor, b: int) -> torch.Tensor:
        """This rank's b rows of a global-batch tensor."""
        if data_group is None or x is None:
            return x
        return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]

    def corrupt(state: TrainState, x0, generator, t, xt):
        """x0 on the device, t ~ U{1..T} and x_t ~ q(x_t | x_0) unless given,
        the token masks; the trained modules in training mode.  On a data
        mesh t and x_t are the global batch's (drawn from the gathered x0,
        or given), and the rank's rows of them are returned beside the
        global t."""
        x0 = as_tensor(x0, torch.long)
        b = x0.shape[0]
        x0_all = x0 if data_group is None else P.distributed.all_gather(x0, data_group)
        B = x0_all.shape[0]
        t = (torch.randint(1, T_total + 1, (B,), generator=generator, device=dev)
             if t is None else as_tensor(t, torch.long))
        xt = (D.sample_xt_tokens(sched, x0_all, t, generator) if xt is None
              else as_tensor(xt, torch.long))
        t_all, t, xt = t, rows(t, b), rows(xt, b)
        x_mask = x0 != pad_id
        loss_mask = x_mask if mask_pad_loss else torch.ones_like(x_mask)
        if state.lora is not None and not train_encoder:
            raise ValueError("a state with LoRA adapters trains through the fine-tune step "
                             "(train_encoder=True)")
        for m in state.trained_modules():
            m.train()
        if state.lora is not None:
            encoder.train()
        return x0, t, xt, x_mask, loss_mask, t_all

    def losses(state, c, c_mask, xt, x0, t, x_mask, loss_mask, apply_lfd, t_all):
        logits = state.decoder(xt, t, c, x_mask, c_mask)
        loss_diff = kl_fn(sched, xt, x0, logits, t, loss_mask)
        metrics = {"loss_diff": loss_diff}
        loss = loss_diff
        if apply_lfd:
            z_text = state.t_proj(state.t_embed(logits))
            z_speech = align_speech_to_text(state.s_proj(c), x0.shape[1])
            if data_group is not None:  # L_fd standardises over the global batch
                z_text = P.gather(z_text, data_group)
                z_speech = P.gather(z_speech, data_group)
            w_t = sched.w_t(t_all).mean()
            loss_fd = lfd_loss(z_speech, z_text, lambda_offdiag=lambda_off)
            loss = loss + tau * w_t * loss_fd
            metrics.update(loss_fd=loss_fd, w_t=w_t)
        metrics["total_loss"] = loss
        return loss, metrics

    def backward(state: TrainState, loss: torch.Tensor) -> None:
        for p in state.optimizer.params:
            p.grad = None
        loss.backward()

    def update(state: TrainState, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The optimizer step on the gradients `backward` left and the EMA;
        the detached metrics."""
        params = state.optimizer.params
        grad_norm, _ = state.optimizer.step([p.grad for p in params])
        for p in params:
            p.grad = None
        state.step += 1
        if state.ema is not None:
            update_ema(state.ema, params, ema_decay, state.step)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data_group is not None:  # the KL is a mean of per-row means: D equal parts
            both = torch.stack([metrics["loss_diff"], metrics["total_loss"]]).float()
            P.distributed.all_reduce_([both], data_group, scale=1.0 / mesh.shape["data"])
            metrics["loss_diff"], metrics["total_loss"] = both[0], both[1]
        metrics["grad_norm"] = grad_norm
        return metrics

    def scheduled(state: TrainState, apply_lfd: Optional[bool]) -> bool:
        if apply_lfd is None:
            return lfd_enabled and (state.step + 1) % n_step_fd == 0
        return apply_lfd

    if cached_features:
        def cached_forward(state: TrainState, c, x0, apply_lfd: bool, c_mask=None,
                           generator: Optional[torch.Generator] = None, t=None, xt=None):
            x0, t, xt, x_mask, loss_mask, t_all = corrupt(state, x0, generator, t, xt)
            return losses(state, as_tensor(c), as_tensor(c_mask, torch.bool), xt, x0, t,
                          x_mask, loss_mask, apply_lfd, t_all)

        def cached_step(state: TrainState, c, x0, apply_lfd: Optional[bool] = None,
                        c_mask=None, generator: Optional[torch.Generator] = None, t=None,
                        xt=None) -> Dict[str, torch.Tensor]:
            loss, metrics = cached_forward(state, c, x0, scheduled(state, apply_lfd), c_mask,
                                           generator, t, xt)
            backward(state, loss)
            return update(state, metrics)

        cached_step.forward = cached_forward
        return cached_step

    def forward(state: TrainState, wave, x0, apply_lfd: bool, lengths=None,
                generator: Optional[torch.Generator] = None, t=None, xt=None,
                time_mask=None, feat_mask=None):
        wave = as_tensor(wave, torch.float32)
        lengths = as_tensor(lengths, torch.long)
        x0, t, xt, x_mask, loss_mask, t_all = corrupt(state, x0, generator, t, xt)
        b, B = x0.shape[0], t_all.shape[0]
        if train_encoder:
            S = encoder.config.feat_extract_output_length(wave.shape[1])
            if time_mask is None and mask_time_prob > 0.0:
                time_mask = sample_time_mask(B, S, mask_time_prob, mask_time_length,
                                             generator, dev)
            if feat_mask is None and mask_feature_prob > 0.0:
                feat_mask = sample_time_mask(B, encoder.config.hidden_size, mask_feature_prob,
                                             mask_feature_length, generator, dev)
            time_mask, feat_mask = (rows(as_tensor(m, torch.bool), b)
                                    for m in (time_mask, feat_mask))
            if state.lora is not None and not LO.is_installed(encoder):
                raise RuntimeError("a LoRA step's forward runs inside step.merged(state), "
                                   "held across its backward")
            c, c_mask, _ = encoder(wave, lengths, as_tensor(time_mask, torch.bool),
                                   as_tensor(feat_mask, torch.bool), generator=generator)
        else:
            encoder.eval()
            with torch.no_grad():
                c, c_mask, _ = encoder(wave, lengths)
        return losses(state, c, c_mask, xt, x0, t, x_mask, loss_mask, apply_lfd, t_all)

    def step(state: TrainState, wave, x0, apply_lfd: Optional[bool] = None, lengths=None,
             generator: Optional[torch.Generator] = None, t=None, xt=None,
             time_mask=None, feat_mask=None) -> Dict[str, torch.Tensor]:
        with merged(state):
            loss, metrics = forward(state, wave, x0, scheduled(state, apply_lfd), lengths,
                                    generator, t, xt, time_mask, feat_mask)
            backward(state, loss)
        return update(state, metrics)

    def merged(state: TrainState):
        """The step's LoRA merge (`lora.installed`) for a block that runs
        `forward` and its backward; nothing without adapters."""
        if state.lora is None:
            return contextlib.nullcontext()
        return LO.installed(encoder, state.lora, state.lora_scale)

    step.forward = forward
    step.merged = merged
    return step


# ------------------------------------------------------------ the training loop
def setup_logging(log_dir: str = "logs", rank: int = 0) -> str:
    """Console + `<log_dir>/train_<timestamp>.log`, the reference's format
    (`train_<timestamp>.rank<r>.log` for rank r > 0 of a process group)."""
    os.makedirs(log_dir, exist_ok=True)
    suffix = f".rank{rank}" if rank else ""
    log_file = os.path.join(log_dir,
                            f"train_{datetime.now().strftime('%Y%m%d_%H%M%S')}{suffix}.log")
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    if logger.hasHandlers():
        logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    for handler in (logging.FileHandler(log_file, encoding="utf-8"), logging.StreamHandler()):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    logging.info("Logging initialised.")
    return log_file


def _active_log_file() -> Optional[str]:
    for h in logging.getLogger().handlers:
        if isinstance(h, logging.FileHandler):
            return h.baseFilename
    return None


class RunLock:
    """`<ckpt_dir>/.run.lock`: refuse to start while another live process
    owns the checkpoint directory (two runs in one directory overwrite each
    other's checkpoints).  The file records pid, log file and start time; a
    lock whose pid is dead is stale and taken over.  log.run_lock: false
    turns it off."""

    def __init__(self, ckpt_dir: str):
        self.path = os.path.join(ckpt_dir, ".run.lock")
        self.acquired = False

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, owned by someone else
        return True

    def acquire(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        if os.path.exists(self.path):
            try:
                with open(self.path, encoding="utf-8") as f:
                    holder = json.load(f)
            except (OSError, ValueError):
                holder = {}
            pid = int(holder.get("pid", -1))
            if pid > 0 and pid != os.getpid() and self._pid_alive(pid):
                raise RuntimeError(
                    f"ckpt_dir is owned by a LIVE training run: pid {pid} (log "
                    f"{holder.get('log_file')}, started {holder.get('started')}) holds "
                    f"{self.path}.  Two concurrent runs sharing one ckpt_dir stomp each "
                    "other's checkpoints: pick a different log.ckpt_dir, wait for / kill "
                    "the other run, or (if you really mean it) set log.run_lock: false")
            if pid > 0 and not self._pid_alive(pid):
                logging.info(f"stale run lock (dead pid {pid}) in {self.path}: taking over")
        record = {"pid": os.getpid(), "host": os.uname().nodename,
                  "log_file": _active_log_file(),
                  "started": datetime.now().isoformat(timespec="seconds"), "argv": sys.argv}
        tmp = self.path + f".tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(record, f)
        os.replace(tmp, self.path)
        self.acquired = True
        logging.info(f"run lock: pid {record['pid']} log={record['log_file']} "
                     f"ckpt_dir={os.path.dirname(self.path)}")

    def release(self) -> None:
        if not self.acquired:
            return
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
        self.acquired = False


def run_training(cfg: Config, raw_cfg: Optional[dict] = None, resume: Optional[str] = None,
                 wavlm_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 max_steps_per_epoch: Optional[int] = None, export_pt: bool = True,
                 profile_dir: Optional[str] = None, debug_nans: bool = False,
                 eval_every: Optional[int] = None, device: Optional[str] = None,
                 mesh=None) -> Dict[str, Any]:
    """A whole training run on `device` (default CUDA; raises without a GPU
    unless device="cpu"); returns the last epoch's summary.  CLI:
    `python -m fddm_asr_tpu_torch.train`.

    `mesh` (`parallel.make_mesh`, one process a GPU): optim.batch_size is the
    global batch, split over "data" (each rank loads its rows of every
    global batch, `data.dataset.make_batches(shard=...)`), the step as
    `make_train_step` describes, evaluation on each rank's shard of the
    eval sets, combined weighted by shard size; with
    model.encoder.seq_parallel the encoder's frames split over "model" (the
    ring, `pipeline.enable_seq_parallel`), else the decoder's and encoder's
    weights (tensor parallelism, `pipeline.enable_tensor_parallel`; the
    checkpoints hold the full tensors, gathered before the primary
    writes).  The primary rank alone takes the run lock and writes
    metrics.jsonl and the checkpoints; the others wait
    for it, and every rank resumes from the same file.

    eval_every=k evaluates val/test CER every k-th epoch and at the last;
    None takes log.eval_every (default 1).  `--resume` takes a
    `{prefix}.state.pt`.  The profiler trace and the NaN guard wrap the
    whole run, so a run that raises still writes its trace and restores the
    anomaly mode; checkpoints still being written (log.async_checkpoint)
    are waited for, and a failed write raises, on a run that raises too
    (chained to its error); the run lock is released at the end either
    way."""
    from fddm_asr_tpu_torch import checkpoint as C
    from fddm_asr_tpu_torch.profiling import nan_guard, trace

    log_cfg = cfg.get("log", Config())
    if mesh is None:
        mesh = P.make_mesh(P.MeshSpec(data=1, model=1))
    if mesh.shape["model"] > 1 and not mesh.distributed:
        raise ValueError(f"a model axis of {mesh.shape['model']} needs a process group of "
                         "data x model ranks: launch torchrun --nproc_per_node "
                         f"{mesh.size} and build the mesh over it (parallel.make_mesh)")
    lock = None
    if log_cfg.get("run_lock", True):
        # the primary takes it; every rank learns whether it could (a rank
        # left running alone would wait in its first collective)
        refusal = None
        if P.is_primary():
            lock = RunLock(os.path.abspath(log_cfg.get("ckpt_dir", "ckpts/run")))
            try:
                lock.acquire()
            except RuntimeError as e:
                refusal = str(e)
        refusal = P.broadcast_object(refusal)
        if refusal is not None:
            raise RuntimeError(refusal)
    # log.async_checkpoint: the state is copied to the host in the loop, the
    # files are written by the writer's background thread
    writer = C.AsyncWriter() if log_cfg.get("async_checkpoint", False) else None
    try:
        with trace(profile_dir), nan_guard(debug_nans) as guard:
            return _run_training_impl(cfg, raw_cfg, resume, wavlm_state_dict,
                                      max_steps_per_epoch, export_pt, eval_every, device, guard,
                                      writer, mesh)
    finally:
        try:
            if writer is not None:
                writer.wait()
        finally:
            if lock is not None:
                lock.release()


def _clones(tensors) -> List[torch.Tensor]:
    return [t.detach().clone() for t in tensors]


class _Snapshot:
    """A device copy of what collapse_restore puts back: the trained
    parameters, the optimizer's moments, counts and accumulated gradients,
    the EMA and the step."""

    def __init__(self, state: TrainState):
        opt = state.optimizer
        self.params, self.mu, self.nu = _clones(opt.params), _clones(opt.mu), _clones(opt.nu)
        self.acc = None if opt.acc is None else _clones(opt.acc)
        self.ema = None if state.ema is None else _clones(state.ema)
        self.counts = (opt.count, opt.notfinite_count, opt.mini_step, state.step)

    @torch.no_grad()
    def restore(self, state: TrainState) -> None:
        opt = state.optimizer
        for dst, src in ((opt.params, self.params), (opt.mu, self.mu), (opt.nu, self.nu),
                         (opt.acc, self.acc), (state.ema, self.ema)):
            if dst is not None:
                torch._foreach_copy_(dst, src)
        opt.count, opt.notfinite_count, opt.mini_step, state.step = self.counts


@contextlib.contextmanager
def _evaluating(pipeline, state: TrainState, use_ema: bool):
    """The pipeline's modules in eval mode, with the EMA in the trained
    parameters when `use_ema` (a bfloat16 EMA as float32 copies) and the
    LoRA adapters (the EMA's under `use_ema`) merged into the encoder; the
    trained parameters and the base encoder put back, bit for bit, after.
    Raises inside a step's merge (`lora.installed`)."""
    LO.check_not_installed(pipeline.encoder, "evaluation")
    for m in (pipeline.decoder, pipeline.encoder):
        m.eval()
    params = state.optimizer.params
    saved = [p.data for p in params] if use_ema and state.ema is not None else None
    try:
        if saved is not None:
            for p, e in zip(params, state.ema):
                p.data = e if e.dtype == p.dtype else e.to(p.dtype)
        with (LO.merged_into(pipeline.encoder, state.lora, state.lora_scale)
              if state.lora is not None else contextlib.nullcontext()):
            yield
    finally:
        if saved is not None:
            for p, data in zip(params, saved):
                p.data = data


def _run_training_impl(cfg: Config, raw_cfg, resume, wavlm_state_dict, max_steps_per_epoch,
                       export_pt, eval_every, device, guard, writer, mesh) -> Dict[str, Any]:
    from fddm_asr_tpu_torch import checkpoint as C
    from fddm_asr_tpu_torch import eval as E
    from fddm_asr_tpu_torch.config import resolve_device
    from fddm_asr_tpu_torch.data.dataset import make_batches, shard_example_count
    from fddm_asr_tpu_torch.models.encoder import frame_length_estimate
    from fddm_asr_tpu_torch.profiling import StepTimer, annotate

    seed = int(cfg.get("seed", 1337))
    log_cfg = cfg.get("log", Config())
    enc_cfg = cfg.model.get("encoder", Config())
    train_encoder = not enc_cfg.get("freeze", True)
    lora_rank = int(enc_cfg.get("lora_rank", 0) or 0)
    if lora_rank > 0 and not train_encoder:  # before any model is built
        raise ValueError(LORA_NEEDS_FINE_TUNE)
    # the sidecar's LoRA keys: the loaders merge at the training run's alpha
    ckpt_meta = ({"lora_rank": lora_rank,
                  "lora_alpha": float(enc_cfg.get("lora_alpha", lora_rank))}
                 if lora_rank > 0 else {})
    dev = resolve_device(device)
    init_ckpt = cfg.model.get("init_ckpt")
    pipeline = training_pipeline(cfg, wavlm_state_dict, device=str(dev))
    if init_ckpt:
        logging.info(f"decoder warm-started from {init_ckpt} (fresh optimizer state)")
    # model.encoder.seq_parallel: the encoder's frames split over the mesh's
    # "model" ranks (the ring), in the forward and the backward
    if enc_cfg.get("seq_parallel") and pipeline.enable_seq_parallel(mesh):
        logging.info(f"sequence-parallel encoder: ring size {mesh.shape['model']}")
    # else the model axis splits the weights (tensor parallelism)
    elif pipeline.enable_tensor_parallel(mesh):
        logging.info(f"tensor-parallel decoder and encoder over {mesh.shape['model']} ranks")
        from fddm_asr_tpu_torch.parallel.tensor import sync_default_generators

        # dropout of whole activations must draw the same masks on every model rank
        sync_default_generators(mesh)
    heads = training_heads(cfg, pipeline)
    state = init_train_state(pipeline, cfg, train_encoder=train_encoder, heads=heads, mesh=mesh)
    ema_eval = state.ema is not None and bool(cfg.optim.get("ema_eval", True))

    ckpt_dir = os.path.abspath(log_cfg.get("ckpt_dir", "ckpts/run"))
    os.makedirs(ckpt_dir, exist_ok=True)
    # log.metrics_jsonl: one JSON line per logged step ("step") and epoch
    # ("epoch"), as the JAX loop writes them; also "feature_cache", "eval",
    # "checkpoint" and "collapse_restore" lines.  true -> <ckpt_dir>/metrics.jsonl
    metrics_path = log_cfg.get("metrics_jsonl")
    if metrics_path is True:
        metrics_path = os.path.join(ckpt_dir, "metrics.jsonl")

    def emit_metrics(**record):
        if not metrics_path or not P.is_primary():
            return
        record["ts"] = time.time()
        with open(metrics_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")

    # the "checkpoint" line of an asynchronous save waits for its files
    writing: List[dict] = []

    def flush_saves():
        if writer is not None:
            writer.wait()
        for record in writing:
            emit_metrics(**record)
        writing.clear()

    def save(name: str, epoch: int, best):
        t0 = time.time()
        files = C.save_ckpt(os.path.join(ckpt_dir, name), state, epoch, raw_cfg, best,
                            export_pt, ema_export=ema_eval, extra_meta=ckpt_meta, writer=writer)
        # blocked_seconds: how long the loop waited (the host copy; under
        # async_checkpoint the write before this one too)
        P.barrier()  # the other ranks wait for the primary's host copy
        record = dict(kind="checkpoint", name=name, epoch=epoch, files=files,
                      blocked_seconds=time.time() - t0, asynchronous=writer is not None)
        for done in writing:  # save_ckpt waited for the writes before this one
            emit_metrics(**done)
        writing[:] = [record]
        if writer is None:
            flush_saves()

    start_epoch, resumed_best_cer = 1, float("inf")
    if resume:
        epoch_done, resumed_best_cer = C.restore_state(state, C.load_state(resume))
        start_epoch = epoch_done + 1
        logging.info(f"Resumed from {resume} at epoch {start_epoch}"
                     + (f" (best_val_cer so far {resumed_best_cer:.4f})"
                        if resumed_best_cer != float("inf") else ""))

    data_cfg = cfg.data
    tokenizer = pipeline.tokenizer

    def make_ds(path):
        if not path or not os.path.exists(path):
            return None
        return training_dataset(cfg, path, tokenizer)

    train_manifest = data_cfg.get("train_json",
                                  data_cfg.get("manifest_train", "data/processed/train.json"))
    train_ds = make_ds(train_manifest)
    val_ds = make_ds(data_cfg.get("val_json", data_cfg.get(
        "manifest_dev", "data/processed/validation.json")))
    test_ds = make_ds(data_cfg.get("test_json", data_cfg.get(
        "manifest_test", "data/processed/test.json")))
    if train_ds is None or len(train_ds) == 0:
        raise FileNotFoundError("no training manifest found / empty dataset")

    batch_size = int(cfg.optim.get("batch_size", 4))
    data_ways = mesh.shape["data"]
    if batch_size % data_ways != 0:
        raise ValueError(f"global batch_size {batch_size} must be divisible by the "
                         f"data-parallel mesh size {data_ways} (use --mesh data=N or raise "
                         "optim.batch_size)")
    # each data rank loads its rows of every global batch
    shard = P.host_shard(mesh)
    local_bs = batch_size // data_ways
    lfd_cfg = cfg.get("lfd", Config())
    n_step_fd = int(lfd_cfg.get("n_step_fd", 4))
    lfd_enabled = bool(lfd_cfg.get("enabled", True)) and float(lfd_cfg.get("tau", 1.0)) != 0.0
    if not lfd_enabled:
        logging.info("L_fd disabled (lfd.enabled/tau): pure-KL training")
    log_every = int(log_cfg.get("log_every", 50))
    num_epochs = int(cfg.optim.get("num_epochs", 10))
    # model.encoder.condition_mask: mask padded audio frames out of the
    # decoder's cross-attention in training too (reference parity: off)
    condition_mask = bool(enc_cfg.get("condition_mask", False))
    if condition_mask:
        logging.info("condition_mask: cross-attention masks padded frames "
                     "(deviation from reference parity)")
    # optim.collapse_restore: true (defaults) or {factor, margin, max_restores}
    collapse_cfg = cfg.optim.get("collapse_restore")
    collapse_cfg = {} if collapse_cfg is True else (collapse_cfg or None)
    snapshot, collapse_best, collapse_restores = None, float("inf"), 0
    if collapse_cfg is not None:
        logging.info("collapse_restore armed: snapshot-on-best, restore on epoch-loss spikes")
    if eval_every is None:
        eval_every = int(log_cfg.get("eval_every", 1))
    host_rng = np.random.default_rng(seed)
    pin = dev.type == "cuda"

    # the frozen-encoder feature cache: c computed once, the WavLM forward
    # skipped in every step; device-resident (rows gathered on the device)
    # when data.cache_device is true, or auto and it holds at most 2 GiB
    feat_cache = feats_dev = None
    cache_dir = data_cfg.get("cache_features")
    if cache_dir and train_encoder:
        raise ValueError("data.cache_features requires a frozen encoder "
                         "(model.encoder.freeze: true): a fine-tuned encoder changes its "
                         "features every step")
    if cache_dir:
        t0 = time.time()
        # the primary builds a missing cache; the others open it after.  Under
        # tensor parallelism the encoder's calls are collectives: the others
        # make the same sweep into a scratch directory
        from fddm_asr_tpu_torch.data.feature_cache import cache_exists
        from fddm_asr_tpu_torch.parallel.tensor import is_sharded

        checksum = _encoder_checksum(pipeline)
        missing = P.broadcast_object(not cache_exists(cache_dir, "train"))
        if P.is_primary():
            feat_cache, built = _ensure_feature_cache(pipeline, train_ds, cache_dir, "train",
                                                      batch_size, train_manifest, checksum)
        elif missing and is_sharded(pipeline.encoder):
            with tempfile.TemporaryDirectory() as scratch:
                _ensure_feature_cache(pipeline, train_ds, scratch, "train", batch_size,
                                      train_manifest, checksum)
        P.barrier()
        if not P.is_primary():
            feat_cache, built = _ensure_feature_cache(pipeline, train_ds, cache_dir, "train",
                                                      batch_size, train_manifest, checksum)
        cache_s = time.time() - t0
        step_fn = make_train_step(pipeline, cfg, cached_features=True, mesh=mesh)
        cache_device = data_cfg.get("cache_device", "auto")
        if cache_device is True and P.process_group()[1] > 1:
            raise ValueError("data.cache_device: true is single-process only (each rank "
                             "streams its own batch rows in a process group); use 'auto' "
                             "or false")
        upload_s = None
        # auto: device-resident on a one-process mesh that it fits
        if cache_device is True or (cache_device == "auto" and mesh.size == 1
                                    and feat_cache.nbytes <= 2 * 1024 ** 3):
            t0 = time.time()
            feats_dev = feat_cache.rows(np.arange(feat_cache.shape[0])).to(dev)
            upload_s = time.time() - t0
            logging.info(f"feature cache device-resident: {feat_cache.shape[0]} rows, "
                         f"{feat_cache.nbytes / 1e6:.0f} MB on {dev}")
        emit_metrics(kind="feature_cache", built=built, seconds=cache_s,
                     bytes=feat_cache.nbytes, shape=list(feat_cache.shape),
                     device_resident=feats_dev is not None, upload_seconds=upload_s)
        frames = feat_cache.shape[1]
    else:
        step_fn = make_train_step(pipeline, cfg, train_encoder=train_encoder, mesh=mesh)

    # eval batches are the same every eval epoch: made once, their waves on
    # the device (log.cache_eval_waves, up to 512 MiB); each data rank takes
    # its shard of the examples, global batches of batch_size rows a rank
    def eval_batches(ds, limit=None):
        if ds is None or len(ds) == 0:
            return None
        batches = []
        it = make_batches(ds, batch_size, drop_last=False, shard=shard)
        try:
            for b in it:
                batches.append(b)
                if limit and len(batches) >= limit:
                    break
        finally:
            it.close()
        if (log_cfg.get("cache_eval_waves", True)
                and sum(b.wave.nbytes for b in batches) <= 512 * 1024 ** 2):
            batches = [dataclasses.replace(b, wave=torch.from_numpy(b.wave).to(dev))
                       for b in batches]
        return batches

    val_batches = eval_batches(val_ds)
    test_batches = eval_batches(test_ds)
    # log.train_cer_batches: N train batches decoded at every eval epoch
    # (train CER -> 0 with val CER flat is memorization)
    train_cer_batches = int(log_cfg.get("train_cer_batches", 0) or 0)
    train_eval_batches = eval_batches(train_ds, train_cer_batches) if train_cer_batches else None

    # survives --resume: a post-resume epoch replaces best_model only if better
    best_val_cer, best_epoch = resumed_best_cer, 0
    early_stop_patience = int(cfg.optim.get("early_stop_patience", 0) or 0)
    ckpt_every = int(log_cfg.get("ckpt_every", 1) or 1)
    evals_since_best = 0
    global_step = state.step + 1
    summary: Dict[str, Any] = {}
    timer = StepTimer(skip=2, device=dev)
    generator = torch.Generator(device=dev)

    for epoch in range(start_epoch, num_epochs + 1):
        logging.info(f"Epoch {epoch}")
        t0 = time.time()
        loss_sum, step_cnt = None, 0
        batches = make_batches(train_ds, local_bs, shuffle=True, seed=seed, epoch=epoch,
                               pin_memory=pin, shard=shard)
        try:
            for bi, batch in enumerate(batches):
                if max_steps_per_epoch and bi >= max_steps_per_epoch:
                    break
                apply_lfd = lfd_enabled and global_step % n_step_fd == 0
                generator.manual_seed(int(host_rng.integers(2 ** 63)))
                with annotate("host_to_device"):
                    x0 = torch.from_numpy(batch.tokens).to(dev, non_blocking=True)
                    if feat_cache is not None:
                        if feats_dev is not None:
                            c = feats_dev.index_select(
                                0, torch.from_numpy(batch.indices).to(dev, non_blocking=True))
                        else:
                            c = feat_cache.rows(batch.indices).to(dev, non_blocking=True)
                        c_mask = None
                        if condition_mask:  # the encoder's ceil(len / 320) frame count
                            fl = np.minimum(frame_length_estimate(batch.wave_lengths), frames)
                            c_mask = torch.from_numpy(
                                np.arange(frames)[None, :] < fl[:, None]).to(dev)
                    else:
                        wave = torch.as_tensor(batch.wave).to(dev, non_blocking=True)
                        lengths = (torch.from_numpy(batch.wave_lengths).to(dev)
                                   if condition_mask else None)
                if feat_cache is not None:
                    metrics = step_fn(state, c, x0, apply_lfd, c_mask=c_mask,
                                      generator=generator)
                else:
                    metrics = step_fn(state, wave, x0, apply_lfd, lengths=lengths,
                                      generator=generator)
                guard.check(metrics["total_loss"], global_step)
                timer.tick()
                # summed on the device: a float() here would wait for it every step
                loss_sum = (metrics["total_loss"] if loss_sum is None
                            else loss_sum + metrics["total_loss"])
                step_cnt += 1
                if global_step % log_every == 0:
                    lead = timer.host_lead_s()
                    record = {"total_loss": float(metrics["total_loss"]),
                              "loss_diff": float(metrics["loss_diff"])}
                    if "loss_fd" in metrics:
                        record.update(loss_fd=float(metrics["loss_fd"]),
                                      w_t=float(metrics["w_t"]))
                    record["grad_norm"] = float(metrics["grad_norm"])
                    if timer.seconds_per_step:
                        record["examples_per_s"] = timer.throughput(batch_size)
                    parts = [f"step={global_step}", f"loss_diff={record['loss_diff']:.4f}"]
                    if "loss_fd" in record:
                        parts += [f"loss_fd={record['loss_fd']:.4f}", f"w_t={record['w_t']:.4f}"]
                    parts += [f"total_loss={record['total_loss']:.4f}",
                              f"grad_norm={record['grad_norm']:.3f}"]
                    if "examples_per_s" in record:
                        parts.append(f"examples_per_s={record['examples_per_s']:.1f}")
                    if lead is not None:
                        parts.append(f"host_lead_ms={lead * 1e3:.1f}")
                    logging.info(" ".join(parts))
                    emit_metrics(kind="step", step=global_step, epoch=epoch, **record)
                global_step += 1
        finally:
            batches.close()
        timer.pause()
        train_loss = float(loss_sum) / step_cnt if step_cnt else 0.0
        logging.info(f"[Summary] Epoch {epoch} Avg Train Loss: {train_loss:.4f}")

        # optim.collapse_restore: an epoch loss factor x + margin above the
        # best epoch's puts back the best epoch's state (the step generator's
        # stream keeps going, so the replay draws anew)
        if collapse_cfg is not None and step_cnt:
            c_factor = float(collapse_cfg.get("factor", 2.0))
            c_margin = float(collapse_cfg.get("margin", 0.3))
            c_max = int(collapse_cfg.get("max_restores", 8))
            if (snapshot is not None and collapse_restores < c_max
                    and train_loss > c_factor * collapse_best + c_margin):
                snapshot.restore(state)
                collapse_restores += 1
                logging.warning(f"collapse detected (epoch {epoch} train_loss {train_loss:.4f} "
                                f"vs best {collapse_best:.4f}): restored best snapshot "
                                f"(restore {collapse_restores}/{c_max})")
                emit_metrics(kind="collapse_restore", epoch=epoch, train_loss=train_loss,
                             best=collapse_best, restores=collapse_restores)
            elif train_loss < collapse_best:
                collapse_best = train_loss
                snapshot = _Snapshot(state)

        do_eval = epoch % max(1, eval_every) == 0 or epoch == num_epochs
        val_loss = val_cer = test_cer = val_kl = train_cer = None
        if do_eval:
            t_eval = time.time()

            def combined(evaluate, ds, batches):
                """`evaluate(pipeline, batches)` on this rank's shard, the
                ranks' values weighted by their shards' sizes."""
                n_local = shard_example_count(len(ds), batch_size, shard, drop_last=False)
                local = evaluate(pipeline, batches) if batches else 0.0
                return P.all_hosts_weighted_mean(local, n_local, mesh.data_group)

            def cer(pipe, batches):
                return E.evaluate_cer_with_jumpy_sampling(pipe, batches, cfg)

            # ema_eval: evaluate the EMA weights, the ones the checkpoints export
            with _evaluating(pipeline, state, ema_eval):
                if val_batches is not None:
                    val_cer = combined(cer, val_ds, val_batches)
                    if bool(log_cfg.get("val_loss", True)):
                        val_loss = combined(E.evaluate_validation_loss, val_ds, val_batches)
                    if log_cfg.get("val_kl") == "sampled":
                        val_kl = combined(lambda pipe, batches: E.evaluate_validation_kl_sampled(
                            pipe, batches,
                            mask_pad_loss=bool(cfg.optim.get("mask_pad_loss", True))),
                            val_ds, val_batches)
                if test_batches is not None:
                    test_cer = combined(cer, test_ds, test_batches)
                if train_eval_batches:
                    train_cer = P.all_hosts_mean(cer(pipeline, train_eval_batches),
                                                 mesh.data_group)
            emit_metrics(kind="eval", epoch=epoch, seconds=time.time() - t_eval)
        if val_cer is not None and val_cer < best_val_cer:
            best_val_cer, best_epoch = val_cer, epoch
            save("best_model", epoch, best_val_cer)
            best_art = "best_model.pt" if export_pt else "best_model.state.pt"
            suffix = ("" if not train_encoder else
                      " (+ best_model.encoder.pt, the LoRA adapters)" if lora_rank > 0 else
                      " (+ best_model.encoder.pt, the fine-tuned encoder)")
            logging.info(f"Saved BEST model (epoch {best_epoch}, val_cer {best_val_cer:.4f}) "
                         f"→ {os.path.join(ckpt_dir, best_art)}{suffix}")

        # the train/eval mode gap: a train-mode loss far under the
        # deterministic val_kl is a fit that needs dropout noise
        if (val_kl is not None and train_loss > 0.0
                and float(cfg.model.get("dropout", 0.1)) > 0.0 and train_loss < 0.5 * val_kl):
            logging.warning(f"train-mode loss ({train_loss:.3f}) << deterministic val_kl "
                            f"({val_kl:.3f}): possible dropout-mode-dependent fit; verify "
                            "decode quality; consider model.dropout: 0.0")

        msg = f"[Epoch {epoch} Summary] train_loss={train_loss:.4f}"
        for name, value in (("train_cer", train_cer), ("val_loss", val_loss),
                            ("val_kl", val_kl), ("val_cer", val_cer), ("test_cer", test_cer)):
            if value is not None:
                msg += f" | {name}={value:.4f}"
        logging.info(msg)

        # optim.early_stop_patience: stop after N evals without a new best
        # (decided before the periodic checkpoint, so the last state is saved)
        stop_early = False
        if val_cer is not None:
            evals_since_best = 0 if epoch == best_epoch else evals_since_best + 1
            stop_early = 0 < early_stop_patience <= evals_since_best
        if epoch % ckpt_every == 0 or epoch == num_epochs or stop_early:
            save(f"ep{epoch:03d}", epoch,
                 best_val_cer if best_val_cer != float("inf") else None)
        summary = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                   "val_cer": val_cer, "test_cer": test_cer, "best_val_cer": best_val_cer,
                   "best_epoch": best_epoch, "epoch_seconds": time.time() - t0}
        if val_kl is not None:
            summary["val_kl"] = val_kl
        if train_cer is not None:
            summary["train_cer"] = train_cer
        if stop_early:
            summary["early_stopped"] = True
        emit_metrics(kind="epoch", **{k: (None if v is None or v == float("inf") else v)
                                      for k, v in summary.items()})
        if stop_early:
            logging.info(f"Early stopping at epoch {epoch}: no val CER improvement in "
                         f"{evals_since_best} evals (best {best_val_cer:.4f} @ epoch "
                         f"{best_epoch})")
            break

    flush_saves()
    logging.info("=" * 50)
    logging.info("TRAINING COMPLETED!")
    logging.info(f"Best validation CER: {best_val_cer:.4f} (Epoch {best_epoch})")
    logging.info("Best model saved at: " + os.path.join(
        ckpt_dir, "best_model.pt" if export_pt else "best_model.state.pt"))
    logging.info("=" * 50)
    return summary


def _encoder_checksum(pipeline) -> float:
    """The feature cache's fingerprint of the encoder's weights, of the full
    tensors under tensor parallelism (a collective over "model")."""
    from fddm_asr_tpu_torch.data import feature_cache as FC
    from fddm_asr_tpu_torch.parallel.tensor import gather_state

    return FC.param_checksum(gather_state(pipeline.encoder))


def _ensure_feature_cache(pipeline, train_ds, cache_dir: str, split: str, batch_size: int,
                          manifest_path: str, checksum: Optional[float] = None,
                          rebuild: bool = False):
    """(the feature cache, whether it was built now): opened, after one
    encoder sweep over the manifest in order when absent (or `rebuild`);
    refused when stale or of another width.  `checksum`:
    `_encoder_checksum`'s."""
    from fddm_asr_tpu_torch.data import feature_cache as FC

    if checksum is None:
        checksum = _encoder_checksum(pipeline)
    masked = bool(pipeline.use_condition_mask)
    fp = FC.fingerprint(manifest_path, len(train_ds), checksum, masked=masked)
    built = rebuild or not FC.cache_exists(cache_dir, split)
    if built:
        logging.info(f"building feature cache under {cache_dir}/{split} …")

        def encode(waves, lengths=None):
            return pipeline.encode_waveform(waves, lengths)[0]

        FC.build_cache(cache_dir, split, train_ds, encode, batch_size=batch_size,
                       manifest_path=manifest_path, checksum=checksum, log_every=10,
                       masked=masked)
    cache = FC.FeatureCache(cache_dir, split, expect_fingerprint=fp)
    # the sampled checksum can miss a changed projection width; the width is
    # cheap to check exactly
    enc = pipeline.encoder
    d_expect = enc.proj.out_features if hasattr(enc, "proj") else enc.config.hidden_size
    if cache.shape[-1] != d_expect:
        raise ValueError(f"feature cache at {cache_dir}/{split} has width {cache.shape[-1]} but "
                         f"this encoder outputs {d_expect}: the cache belongs to a different "
                         "model geometry; delete it or point data.cache_features elsewhere")
    return cache, built
