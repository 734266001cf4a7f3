# -*- coding: utf-8 -*-
"""Jumpy sampling: the inference-time denoising loop.

Counterpart of `fddm_asr_tpu/sampler.py` (one `lax.scan` there, a Python
loop over the few jumps here).  Semantics, as the reference's:

  * jump schedule: t starts at T_infer; each jump takes delta = min(r, t);
  * exact mode walks the TRAINING beta table with inference-axis steps
    t in 1..T_infer (the reference's quirk: no axis remap);
  * fast mode remaps t_infer -> t_train = round(clamp(t / T_infer * T_train,
    1, T_train)) and mixes alpha_bar p(x0) + (1 - alpha_bar) / K; the
    reference's lookup returns alpha_bar_{t_train+1} (quirk #5), kept when
    `ref_compat` (default);
  * posterior_mode "max" or greedy -> argmax, else a temperature draw;
  * only the last step's p(x0) is kept; the output is its argmax.

Randomness comes from an explicit `torch.Generator`; `x_init` overrides the
uniform draw of x_T (how tests compare the two frameworks token for token).
Where the JAX package splits its key per batch (`rng, step = split(rng)`),
the port takes a step generator from the caller's (`split_generator`).

A non-greedy step draws each position's token by inverse CDF from one
uniform a position (`categorical`): x_T first, then one [B, seq_len]
uniform draw a step, from the same generator in that order.  `noise`
passes those uniforms in instead, as an exported program takes them
(`aot.py`), so a program and the live sampler fed the same generator give
the same ids.  The draws cannot match `jax.random`'s.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from fddm_asr_tpu_torch.diffusion import DiffusionSchedule, q_posterior_multi_step

__all__ = ["SamplerConfig", "argmax_repeat_penalized", "build_jump_schedule", "categorical",
           "make_sample_fn", "split_generator"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    K: int
    T_train: int
    T_infer: int = 20
    r: int = 5
    greedy: bool = True
    posterior_mode: str = "average"  # "average" | "max" | "map" (== average+greedy)
    sampling_mode: str = "exact"     # "exact" | "fast"
    temperature: float = 1.0
    ref_compat: bool = True          # reproduce the reference's multi-step recurrence
    # > 0: repetition-penalized final read-out (argmax_repeat_penalized)
    repeat_penalty: float = 0.0


def split_generator(generator: torch.Generator,
                    device: Union[str, torch.device, None] = None) -> torch.Generator:
    """A new generator on `device` (default the parent's), seeded by one
    63-bit draw of `generator`: the port's `rng, step = jax.random.split(rng)`.
    The parent advances by that draw only, so successive calls give
    independent streams, reproducibly from the parent's seed.  A CPU
    parent draws without touching the device."""
    seed = torch.empty((), dtype=torch.int64, device=generator.device).random_(
        generator=generator).item()
    return torch.Generator(device=device or generator.device).manual_seed(seed)


def build_jump_schedule(T_infer: int, r: int) -> Tuple[np.ndarray, np.ndarray]:
    """(t, delta) pairs of `while t > 0: delta = min(r, t); t -= delta`."""
    ts, deltas = [], []
    t = T_infer
    while t > 0:
        d = min(r, t)
        ts.append(t)
        deltas.append(d)
        t -= d
    return np.asarray(ts, np.int32), np.asarray(deltas, np.int32)


def _fast_alpha_bar_targets(sched: DiffusionSchedule, cfg: SamplerConfig,
                            ts: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """Per-jump alpha_bar at the remapped train-axis target (fast mode).

    Python (banker's) round of clamp(t / T_infer * T_train, 1, T_train);
    target 0 -> 1.0.  ref_compat indexes one step further (the reference's
    1-based lookup into a 0-based table, quirk #5); both clamp at T."""
    table = sched.alpha_bar_ext.cpu().numpy()
    out = []
    for t, d in zip(ts.tolist(), deltas.tolist()):
        target = max(0, t - d)
        if target <= 0:
            out.append(1.0)
            continue
        t_train = round(max(1.0, min(float(cfg.T_train),
                                     target / max(1, cfg.T_infer) * cfg.T_train)))
        idx = int(t_train) + 1 if cfg.ref_compat else int(t_train)
        out.append(float(table[min(idx, sched.T)]))
    return np.asarray(out, np.float32)


def argmax_repeat_penalized(p_last: torch.Tensor, penalty: float) -> torch.Tensor:
    """Left-to-right greedy read-out of p(x0) [B, L, K] where position i's
    log-prob of the token chosen at i-1 is reduced by `penalty`; penalty 0
    is plain argmax."""
    logp = p_last.float().clamp(min=1e-12).log()
    B, L, _ = logp.shape
    idxs = []
    prev = None
    for i in range(L):
        scores = logp[:, i]
        if prev is not None:
            scores = scores.scatter_add(
                1, prev[:, None], torch.full((B, 1), -penalty, device=scores.device))
        prev = scores.argmax(dim=-1)
        idxs.append(prev)
    return torch.stack(idxs, dim=1)


def categorical(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw a position from `probs` [..., K] (rows need not sum to 1)
    by inverse CDF at `u` [...] in [0, 1): the first k whose cumulative sum
    exceeds u times the row's total.  A token of probability 0 is never
    drawn."""
    cdf = probs.cumsum(dim=-1)
    k = torch.searchsorted(cdf, (u * cdf[..., -1])[..., None], right=True)[..., 0]
    return k.clamp(max=probs.shape[-1] - 1)


def sampling_draws(cfg: SamplerConfig) -> int:
    """The [B, seq_len] uniform draws a sample makes after x_T: one a jump
    unless every step is an argmax."""
    if cfg.posterior_mode == "max" or cfg.greedy:
        return 0
    return len(build_jump_schedule(cfg.T_infer, cfg.r)[0])


def make_sample_fn(decoder_apply: Callable, sched: DiffusionSchedule,
                   cfg: SamplerConfig) -> Callable:
    """sample(cond [B, S, D], seq_len, c_mask=None, x_init=None, generator=None,
    noise=None) -> (x0 ids [B, seq_len] int64, p_x0 of the last step
    [B, seq_len, K]).  `noise` [sampling_draws(cfg), B, seq_len]: the
    uniforms the steps would draw from `generator`.

    decoder_apply(xt [B, L] int, t [B] int, cond, c_mask) -> logits [B, L, K]."""
    ts_np, deltas_np = build_jump_schedule(cfg.T_infer, cfg.r)
    # fast mode reads the schedule table on the host once, here; exact mode
    # never does, so building a sampler queues nothing and waits for nothing
    ab_targets = (_fast_alpha_bar_targets(sched, cfg, ts_np, deltas_np).tolist()
                  if cfg.sampling_mode == "fast" else [None] * len(ts_np))

    def to_indices(probs, generator, u):
        if cfg.posterior_mode == "max" or cfg.greedy:
            return probs.argmax(dim=-1)
        if u is None:
            u = torch.rand(probs.shape[:-1], generator=generator, device=probs.device)
        logits = probs.clamp(min=1e-12).log() / cfg.temperature
        return categorical(torch.softmax(logits, dim=-1), u)

    def sample(cond: torch.Tensor, seq_len: int, c_mask: Optional[torch.Tensor] = None,
               x_init: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        B = cond.shape[0]
        device = cond.device
        if x_init is None:
            x_t = torch.randint(0, cfg.K, (B, seq_len), generator=generator, device=device)
        else:
            x_t = torch.as_tensor(x_init, device=device).long()
        p_x0 = None
        for step, (t, delta, ab) in enumerate(zip(ts_np.tolist(), deltas_np.tolist(),
                                                  ab_targets)):
            t_b = torch.full((B,), t, dtype=torch.long, device=device)
            logits = decoder_apply(x_t, t_b, cond, c_mask)
            p_x0 = torch.softmax(logits.float(), dim=-1)
            if cfg.sampling_mode == "exact":
                onehot = F.one_hot(x_t, cfg.K).float()
                p_next = q_posterior_multi_step(sched, onehot, p_x0, t_b, delta,
                                                ref_compat=cfg.ref_compat)
            else:  # fast: convex mix with uniform at the remapped target step
                p_next = ab * p_x0 + (1.0 - ab) / cfg.K
            x_t = to_indices(p_next, generator, None if noise is None else noise[step])
        if cfg.repeat_penalty > 0.0:
            return argmax_repeat_penalized(p_x0, cfg.repeat_penalty), p_x0
        return p_x0.argmax(dim=-1), p_x0

    return sample
