# -*- coding: utf-8 -*-
"""Training: learning-rate schedule, AdamW, the train state and one train step.

Counterpart of `fddm_asr_tpu/train_lib.py:82-414` (`_lr_schedule`,
`make_optimizer`, `TrainState`, `make_train_step`):

  * the loss is the diffusion KL (`diffusion.kl_term_sparse` by default,
    `optim.kl_impl: dense` for the reference's form) plus, on L_fd steps,
    tau * mean(w_t) * L_fd over the projection heads;
  * AdamW with one global-norm gradient clip over every trained parameter,
    in two groups when the encoder trains (`optim.encoder_lr`), with
    optional 1-D decay exclusion and non-finite-update skipping;
  * an EMA of the trained parameters (`optim.ema_decay`);
  * the fine-tune step (model.encoder.freeze: false) runs WavLM in training
    mode with SpecAugment inside the differentiated graph; the frozen step
    encodes under no_grad (the inference kernel on a GPU).

The optimizer reproduces optax's arithmetic (the JAX package's): the
schedule is read at the update count BEFORE the update (so under linear
warmup the first update has lr 0); the clip scales by max/norm with no
epsilon (`torch.nn.utils.clip_grad_norm_` adds 1e-6); decoupled weight
decay is p -= lr * (adam + wd * p); parameters with no gradient in a step
(the projection heads on a non-L_fd step) count as zero gradients, so their
moments decay and weight decay still applies, as in optax.

RNG: `torch.Generator` and `jax.random` give different numbers, so the
step takes a generator and also accepts the timesteps `t`, the corrupted
tokens `xt` and the SpecAugment masks ready-made (the tests hand it the JAX
step's own draws).  Decoder and encoder dropout draw from torch's default
generator of the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from fddm_asr_tpu_torch import diffusion as D
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.losses import align_speech_to_text, lfd_loss
from fddm_asr_tpu_torch.models.projection import SpeechProjector, TextEmbedding, TextProjector
from fddm_asr_tpu_torch.models.wavlm import sample_time_mask
from fddm_asr_tpu_torch.pipeline import random_init_

__all__ = ["AdamW", "TrainState", "lr_schedule", "make_optimizer",
           "make_projection_heads", "init_train_state", "make_train_step"]

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


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw per group), optionally
    inside apply_if_finite, over parameter groups that update together.

    groups: [(parameters, schedule)], one per learning-rate group.  Moments
    are float32 like the parameters.  `step(grads)` returns the pre-clip
    global gradient norm (a 0-d tensor) and whether the update was applied."""

    def __init__(self, groups: Sequence[Tuple[Sequence[nn.Parameter], Schedule]],
                 weight_decay: float = 0.01, decay_exclude_1d: bool = False,
                 clip: float = 5.0, skip_nonfinite: int = 0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.groups = [(list(ps), sched) for ps, sched in groups]
        self.params: List[nn.Parameter] = [p for ps, _ in self.groups for p in ps]
        self.weight_decay = weight_decay
        self.decayed = [i for i, p in enumerate(self.params)
                        if not decay_exclude_1d or p.dim() >= 2]
        self.clip = clip
        self.skip_nonfinite = skip_nonfinite
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0            # updates applied (each group's optax count)
        self.notfinite_count = 0  # consecutive non-finite steps

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> Tuple[torch.Tensor, bool]:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.skip_nonfinite > 0:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= self.skip_nonfinite:
                return norm, False
        if not bool(norm < self.clip):  # optax: t / norm * max, no epsilon
            grads = torch._foreach_div(grads, norm)
            torch._foreach_mul_(grads, self.clip)

        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        del grads
        c = self.count + 1
        update = torch._foreach_div(self.nu, 1.0 - b2 ** c)
        torch._foreach_sqrt_(update)
        torch._foreach_add_(update, self.eps)
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** c)
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
        return norm, True


def make_optimizer(cfg: Config, main_params: Sequence[nn.Parameter],
                   encoder_params: Optional[Sequence[nn.Parameter]] = None) -> AdamW:
    """AdamW from cfg.optim (lr 2e-4, weight_decay 0.01, grad_clip 5.0 by
    default); a second group at optim.encoder_lr (default optim.lr) when
    `encoder_params` is given, under the same global clip."""
    optim = cfg.optim
    unsupported = {key: optim.get(key) for key in ("adam_mu_dtype", "ema_dtype")
                   if optim.get(key) not in (None, "float32")}
    if unsupported:
        raise NotImplementedError(f"not ported yet: optim {unsupported}")
    if int(optim.get("grad_accum_steps", 1) or 1) > 1:
        raise NotImplementedError("optim.grad_accum_steps > 1 is not ported yet")
    lr = float(optim.get("lr", 2e-4))
    warmup = int(optim.get("warmup_steps", 0) or 0)
    groups = [(list(main_params), lr_schedule(optim, lr, warmup))]
    if encoder_params is not None:
        enc_lr = float(optim.get("encoder_lr", lr))
        groups.append((list(encoder_params), lr_schedule(optim, enc_lr, warmup)))
    return AdamW(groups, weight_decay=float(optim.get("weight_decay", 0.01)),
                 decay_exclude_1d=bool(optim.get("decay_exclude_1d", False)),
                 clip=float(optim.get("grad_clip", 5.0)),
                 skip_nonfinite=int(optim.get("skip_nonfinite_updates", 0) or 0))


@dataclasses.dataclass
class TrainState:
    """The trained modules, their optimizer, the update step and the EMA.

    `ema` mirrors `optimizer.params` (decoder, s_proj, t_embed, t_proj,
    then the encoder's trained parameters); None when optim.ema_decay is 0.
    `encoder` is None for frozen-encoder training."""

    decoder: nn.Module
    s_proj: SpeechProjector
    t_embed: TextEmbedding
    t_proj: TextProjector
    optimizer: AdamW
    encoder: Optional[nn.Module] = None
    step: int = 0
    ema: Optional[List[torch.Tensor]] = None

    def trained_modules(self) -> List[nn.Module]:
        mods = [self.decoder, self.s_proj, self.t_embed, self.t_proj]
        return mods + ([self.encoder] if self.encoder is not None else [])


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


def init_train_state(pipeline, cfg: Config, train_encoder: Optional[bool] = None,
                     heads=None, generator: Optional[torch.Generator] = None) -> TrainState:
    """A fresh TrainState over the pipeline's decoder (and encoder, when it
    trains: model.encoder.freeze false) plus projection heads (`heads`, or
    new ones drawn from `generator`).  A frozen conv front-end
    (freeze_feature_extractor) is left out of the optimizer altogether."""
    enc_cfg = cfg.model.get("encoder", Config())
    if train_encoder is None:
        train_encoder = not enc_cfg.get("freeze", True)
    if int(enc_cfg.get("lora_rank", 0) or 0) > 0:
        raise NotImplementedError("LoRA fine-tuning is not ported yet")
    if heads is None:
        heads = make_projection_heads(cfg, pipeline.device, pipeline.decoder.dtype, generator)
    main = [p for m in (pipeline.decoder, *heads) for p in m.parameters()]
    encoder = None
    enc_params = None
    if train_encoder:
        encoder = pipeline.encoder
        if encoder.freeze:
            raise ValueError("train_encoder=True needs an encoder built with "
                             "model.encoder.freeze: false")
        encoder.backbone.feature_extractor.requires_grad_(
            not encoder.config.freeze_feature_extractor)
        enc_params = [p for p in encoder.parameters() if p.requires_grad]
    optimizer = make_optimizer(cfg, main, enc_params)
    ema = None
    if float(cfg.optim.get("ema_decay", 0.0) or 0.0) > 0.0:
        ema = [p.detach().clone() for p in optimizer.params]
    return TrainState(pipeline.decoder, *heads, optimizer=optimizer, encoder=encoder, ema=ema)


def make_train_step(pipeline, cfg: Config, train_encoder: bool = False):
    """Returns step(state, wave, x0, apply_lfd=None, lengths=None,
    generator=None, t=None, xt=None, time_mask=None, feat_mask=None) -> metrics.

    One optimizer update of `state` in place.  `step.forward(state, wave,
    x0, apply_lfd, ...)` is the same step's loss and metrics without the
    update (draws as `step` takes them), for reading gradients.  apply_lfd=None takes the
    L_fd schedule: every lfd.n_step_fd-th step (1-based), unless lfd is
    disabled.  train_encoder=True is the fine-tune step (the encoder trains,
    in training mode, with SpecAugment masks drawn unless given); False the
    frozen step.  Metrics (0-d tensors): loss_diff, total_loss, grad_norm
    (before the clip), and on L_fd steps loss_fd and w_t."""
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

    def as_tensor(x, dtype):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=dev)

    def losses(state, c, c_mask, xt, x0, t, x_mask, loss_mask, apply_lfd):
        logits = state.decoder(xt, t, c, x_mask, c_mask)
        loss_diff = kl_fn(sched, xt, x0, logits, t, loss_mask)
        metrics = {"loss_diff": loss_diff}
        loss = loss_diff
        if apply_lfd:
            z_text = state.t_proj(state.t_embed(logits))
            z_speech = align_speech_to_text(state.s_proj(c), x0.shape[1])
            w_t = sched.w_t(t).mean()
            loss_fd = lfd_loss(z_speech, z_text, lambda_offdiag=lambda_off)
            loss = loss + tau * w_t * loss_fd
            metrics.update(loss_fd=loss_fd, w_t=w_t)
        metrics["total_loss"] = loss
        return loss, metrics

    def forward(state: TrainState, wave, x0, apply_lfd: bool, lengths=None,
                generator: Optional[torch.Generator] = None, t=None, xt=None,
                time_mask=None, feat_mask=None):
        wave = as_tensor(wave, torch.float32)
        x0 = as_tensor(x0, torch.long)
        lengths = as_tensor(lengths, torch.long)
        B = x0.shape[0]
        t = (torch.randint(1, T_total + 1, (B,), generator=generator, device=dev)
             if t is None else as_tensor(t, torch.long))
        xt = (D.sample_xt_tokens(sched, x0, t, generator) if xt is None
              else as_tensor(xt, torch.long))
        x_mask = x0 != pad_id
        loss_mask = x_mask if mask_pad_loss else torch.ones_like(x_mask)

        for m in state.trained_modules():
            m.train()
        if train_encoder:
            S = encoder.config.feat_extract_output_length(wave.shape[1])
            if time_mask is None and mask_time_prob > 0.0:
                time_mask = sample_time_mask(B, S, mask_time_prob, mask_time_length,
                                             generator, dev)
            if feat_mask is None and mask_feature_prob > 0.0:
                feat_mask = sample_time_mask(B, encoder.config.hidden_size, mask_feature_prob,
                                             mask_feature_length, generator, dev)
            c, c_mask, _ = encoder(wave, lengths, as_tensor(time_mask, torch.bool),
                                   as_tensor(feat_mask, torch.bool))
        else:
            encoder.eval()
            with torch.no_grad():
                c, c_mask, _ = encoder(wave, lengths)
        return losses(state, c, c_mask, xt, x0, t, x_mask, loss_mask, apply_lfd)

    def step(state: TrainState, wave, x0, apply_lfd: Optional[bool] = None, lengths=None,
             generator: Optional[torch.Generator] = None, t=None, xt=None,
             time_mask=None, feat_mask=None) -> Dict[str, torch.Tensor]:
        if apply_lfd is None:
            apply_lfd = lfd_enabled and (state.step + 1) % n_step_fd == 0
        loss, metrics = forward(state, wave, x0, apply_lfd, lengths, generator, t, xt,
                                time_mask, feat_mask)
        params = state.optimizer.params
        for p in params:
            p.grad = None
        loss.backward()
        grad_norm, _ = state.optimizer.step([p.grad for p in params])
        for p in params:
            p.grad = None
        state.step += 1
        if state.ema is not None:
            decay = min(ema_decay, (1.0 + state.step) / (10.0 + state.step))
            with torch.no_grad():
                diff = torch._foreach_sub(params, state.ema)
                torch._foreach_add_(state.ema, diff, alpha=1.0 - decay)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    step.forward = forward
    return step
