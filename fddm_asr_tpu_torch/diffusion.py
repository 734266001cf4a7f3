# -*- coding: utf-8 -*-
"""Discrete (multinomial) diffusion over token sequences: schedule + posteriors.

Counterpart of `fddm_asr_tpu/diffusion.py`: the schedule, the posteriors
the sampler needs, and the training side (`q_sample`, `sample_xt_tokens`,
the diffusion KL in its dense and O(B*L) forms, the L_fd weight).  Each step
applies M_t = (1 - beta_t) I + (beta_t / K) 11^T, never materialised: every
quantity reduces to the scalar pair (1 - beta_t, beta_t / K).  The schedule
is cosine, beta_t = beta_max sin^2(pi t / 2T), alpha_bar_t = prod_{s<=t}
(1 - beta_s).  Tables have length T+1 with index 0 the identity step.

All math is float32: at K = 8000 the mass per class is ~1e-4, below bf16's
resolution for the posterior's renormalisation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["DiffusionSchedule", "make_schedule", "q_sample", "sample_xt_tokens",
           "q_posterior", "multi_step_coeffs", "q_posterior_multi_step", "kl_term",
           "kl_term_sparse"]

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Noise-schedule tables, float32 tensors of length T+1.

    betas_ext[0] = 0, alpha_bar_ext[0] = 1;
    beta_over_abar_prefix[t] = S_t = sum_{s<=t} beta_s / alpha_bar_{s-1}
    (the closed form of the reference's aliased b-term recurrence, see
    `multi_step_coeffs`)."""

    betas_ext: torch.Tensor
    alpha_bar_ext: torch.Tensor
    beta_over_abar_prefix: torch.Tensor
    K: int
    T: int

    @property
    def w_prefix(self) -> torch.Tensor:
        """w_t = prod_{s<=t}(1 - beta_s) for t = 1..T: the L_fd weight table."""
        return self.alpha_bar_ext[1:]

    def w_t(self, t: torch.Tensor) -> torch.Tensor:
        """Per-example L_fd weight, t in 1..T -> alpha_bar_t."""
        return self.alpha_bar_ext[t]


def make_schedule(K: int, T: int, beta_max: float = 0.2,
                  device: Union[str, torch.device] = "cpu") -> DiffusionSchedule:
    """The cosine schedule, computed in numpy exactly as the JAX package does
    (f32 betas and cumulative product, f64 prefix sum)."""
    t = np.arange(1, T + 1, dtype=np.float32)
    betas = (beta_max * np.sin(0.5 * np.pi * (t / float(T))) ** 2).astype(np.float32)
    alpha_bar = np.cumprod(1.0 - betas).astype(np.float32)
    abar_ext64 = np.concatenate([[1.0], alpha_bar]).astype(np.float64)
    prefix = np.concatenate(
        [[0.0], np.cumsum(betas.astype(np.float64) / abar_ext64[:-1])]
    ).astype(np.float32)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return DiffusionSchedule(
        betas_ext=tensor(np.concatenate([[0.0], betas])),
        alpha_bar_ext=tensor(np.concatenate([[1.0], alpha_bar])),
        beta_over_abar_prefix=tensor(prefix),
        K=int(K), T=int(T),
    )


def _renorm(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(min=_EPS)
    return p / p.sum(dim=-1, keepdim=True).clamp(min=_EPS)


def q_sample(sched: DiffusionSchedule, x0_prob: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Forward corruption q(x_t | x_0) = alpha_bar_t x0 + (1 - alpha_bar_t) / K
    over [B, L, K] one-hot or probability rows, t [B] in 1..T."""
    ab = sched.alpha_bar_ext[t][:, None, None]
    return _renorm(ab * x0_prob.float() + (1.0 - ab) / sched.K)


def sample_xt_tokens(sched: DiffusionSchedule, x0_tokens: torch.Tensor, t: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forward-diffuse token ids x0 [B, L] to x_t, drawing from `generator`.

    The categorical of the one-hot q_sample row ab*onehot(x0) + (1-ab)/K
    decomposes exactly as: keep x0 with probability ab, else draw uniformly
    over ALL K tokens (which re-picks x0 with probability 1/K, supplying the
    + (1-ab)/K mass).  Keeping with probability ab + (1-ab)/K and then
    resampling over all K would count that mass twice.  O(B*L): the
    [B, L, K] one-hot is never built."""
    B, L = x0_tokens.shape
    dev = x0_tokens.device
    ab = sched.alpha_bar_ext[t][:, None]
    keep = torch.rand(B, L, device=dev, generator=generator) < ab
    rand_tok = torch.randint(0, sched.K, (B, L), device=dev, generator=generator,
                             dtype=x0_tokens.dtype)
    return torch.where(keep, x0_tokens, rand_tok)


def q_posterior(sched: DiffusionSchedule, xt_prob: torch.Tensor,
                x0hat_prob: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Single-step posterior q(x_{t-1} | x_t, x0hat) over [B, L, K] rows.

    q ∝ (M_t^T x_t) . (M_{t-1} x0hat) / (x_t^T M_t x0hat), M_0 = I.  The prior
    term applies the single transition M_{t-1} (the reference's design, not
    the cumulative D3PM prior)."""
    xt_prob = xt_prob.float()
    x0hat_prob = x0hat_prob.float()
    beta_t = sched.betas_ext[t][:, None, None]
    a_t, b_t = 1.0 - beta_t, beta_t / sched.K
    beta_tm1 = sched.betas_ext[(t - 1).clamp(min=0)][:, None, None]
    a_tm1, b_tm1 = 1.0 - beta_tm1, beta_tm1 / sched.K
    A = a_t * xt_prob + b_t
    Bv = a_tm1 * x0hat_prob + b_tm1
    denom = a_t * (xt_prob * x0hat_prob).sum(dim=-1, keepdim=True) + b_t
    return _renorm((A * Bv) / denom.clamp(min=_EPS))


def multi_step_coeffs(sched: DiffusionSchedule, t: torch.Tensor, delta,
                      ref_compat: bool = True):
    """(a_cum, b_cum, a_target, b_target), each [B], with t_target = max(t - delta, 0):

      prod_{s=t_target+1}^{t} M_s == a_cum I + b_cum 11^T,
      M_{t_target}               == a_target I + b_target 11^T.

    ref_compat=True reproduces the reference's recurrence, whose b-update
    reads an already-updated a through a tensor alias, giving
      b_cum = (alpha_bar_t / K) (S_t - S_{t-delta});
    ref_compat=False uses the exact product b_cum = (1 - a_cum) / K."""
    t_target = (t - delta).clamp(min=0)
    a_cum = sched.alpha_bar_ext[t] / sched.alpha_bar_ext[t_target]
    if ref_compat:
        b_cum = (sched.alpha_bar_ext[t] / sched.K) * (
            sched.beta_over_abar_prefix[t] - sched.beta_over_abar_prefix[t_target])
    else:
        b_cum = (1.0 - a_cum) / sched.K
    beta_tgt = sched.betas_ext[t_target]
    return a_cum, b_cum, 1.0 - beta_tgt, beta_tgt / sched.K


def q_posterior_multi_step(sched: DiffusionSchedule, xt_prob: torch.Tensor,
                           x0hat_prob: torch.Tensor, t: torch.Tensor, delta,
                           ref_compat: bool = True) -> torch.Tensor:
    """Delta-step posterior q(x_{t-delta} | x_t, x0hat) over [B, L, K] rows.

    q ∝ (M_{t:t-delta+1}^T x_t) . (M_{t-delta} x0hat) / (x_t^T M_{t:t-delta+1} x0hat)."""
    xt_prob = xt_prob.float()
    x0hat_prob = x0hat_prob.float()
    a_c, b_c, a_tg, b_tg = (c[:, None, None] for c in
                            multi_step_coeffs(sched, t, delta, ref_compat))
    sum_xt = xt_prob.sum(dim=-1, keepdim=True)
    sum_x0 = x0hat_prob.sum(dim=-1, keepdim=True)
    A = a_c * xt_prob + b_c * sum_xt
    Bv = a_tg * x0hat_prob + b_tg * sum_x0
    dot = (xt_prob * x0hat_prob).sum(dim=-1, keepdim=True)
    denom = a_c * dot + b_c * sum_x0 * sum_xt
    return _renorm((A * Bv) / denom.clamp(min=_EPS))


def _mean_over_valid(kl_token: torch.Tensor, x_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample mean over valid positions (eps-guarded), then the batch mean."""
    if x_mask is None:
        return kl_token.mean(dim=1).mean()
    valid = x_mask.float()
    return ((kl_token * valid).sum(dim=1) / (valid.sum(dim=1) + _EPS)).mean()


def kl_term(sched: DiffusionSchedule, xt: torch.Tensor, x0: torch.Tensor,
            logits_x0: torch.Tensor, t: torch.Tensor,
            x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diffusion loss KL[q(x_{t-1}|x_t, x_0) || p_theta(x_{t-1}|x_t, c)], dense.

    The reference's form: both posteriors share (M_t^T x_t).(M_{t-1} x) over
    [B, L, K] one-hot rows and are divided by their analytic denominators;
    the model's uses x0hat = softmax(logits).  xt, x0 [B, L] ids, logits
    [B, L, K], t [B] in 1..T, x_mask [B, L] True = valid.  Scalar."""
    logits_x0 = logits_x0.float()
    V = logits_x0.shape[-1]
    x0_hat = torch.softmax(logits_x0, dim=-1)
    xt_onehot = torch.nn.functional.one_hot(xt, V).float()
    x0_onehot = torch.nn.functional.one_hot(x0, V).float()
    beta_t = sched.betas_ext[t][:, None, None]
    beta_prev = sched.betas_ext[(t - 1).clamp(min=0)][:, None, None]
    K = float(V)
    MtT_xt = beta_t / K + (1.0 - beta_t) * xt_onehot
    Mprev_x0 = (1.0 - beta_prev) * x0_onehot + beta_prev / K
    Mprev_x0hat = (1.0 - beta_prev) * x0_hat + beta_prev / K
    x0_at_xt = (x0_onehot * xt_onehot).sum(dim=-1)
    x0hat_at_xt = torch.gather(x0_hat, -1, xt[..., None])[..., 0]
    beta_t_bl = sched.betas_ext[t][:, None]
    denom_true = beta_t_bl / K + (1.0 - beta_t_bl) * x0_at_xt
    denom_pred = beta_t_bl / K + (1.0 - beta_t_bl) * x0hat_at_xt
    q_post = MtT_xt * Mprev_x0 / (denom_true[..., None] + _EPS)
    p_post = MtT_xt * Mprev_x0hat / (denom_pred[..., None] + _EPS)
    kl_token = (q_post * (torch.log(q_post + _EPS) - torch.log(p_post + _EPS))).sum(dim=-1)
    return _mean_over_valid(kl_token, x_mask)


def kl_term_sparse(sched: DiffusionSchedule, xt: torch.Tensor, x0: torch.Tensor,
                   logits_x0: torch.Tensor, t: torch.Tensor,
                   x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same KL with no [B, L, K] one-hot: the K classes fall into at most
    three groups of equal (q_k, p_k) -- k == x0, k == xt, the rest -- so the
    q side is closed-form and the only K-wide work is one log-softmax and one
    sum of log(M_{t-1} x0hat).  The training default.  Agrees with `kl_term`
    to f32 tolerance where the posteriors are well conditioned; where the
    model's posterior underflows the dense form's +1e-8 this one keeps the
    true log (and its gradient)."""
    logits_x0 = logits_x0.float()
    K = float(logits_x0.shape[-1])
    beta_t = sched.betas_ext[t][:, None]
    beta_prev = sched.betas_ext[(t - 1).clamp(min=0)][:, None]
    a_t, b_t = 1.0 - beta_t, beta_t / K
    a_p, b_p = 1.0 - beta_prev, beta_prev / K

    same = (xt == x0).float()
    is_same = same > 0.5
    u_x0 = (b_t + a_t * same) * (b_p + a_p)
    u_xt = (b_t + a_t) * (b_p + a_p * same)
    u_other = b_t * b_p
    denom_true = b_t + a_t * same
    q_x0 = u_x0 / (denom_true + _EPS)
    q_xt = u_xt / (denom_true + _EPS)
    q_other = u_other / (denom_true + _EPS)

    x0_hat = torch.log_softmax(logits_x0, dim=-1).exp()
    ph_xt = torch.gather(x0_hat, -1, xt[..., None])[..., 0]
    denom_pred = b_t + a_t * ph_xt
    log_Mp = torch.log(a_p[..., None] * x0_hat + b_p[..., None] + _EPS)
    sum_log_Mp = log_Mp.sum(dim=-1)
    log_Mp_x0 = torch.gather(log_Mp, -1, x0[..., None])[..., 0]
    log_Mp_xt = torch.gather(log_Mp, -1, xt[..., None])[..., 0]
    log_b_t = torch.log(b_t + _EPS)
    log_atbt = torch.log(a_t + b_t + _EPS)

    def xlogx(x):
        return x * torch.log(x + _EPS)

    n_other = K - 2.0 + same
    ent = torch.where(is_same, xlogx(q_x0), xlogx(q_x0) + xlogx(q_xt)) + n_other * xlogx(q_other)
    cross_mt = q_xt * log_atbt + torch.where(is_same, 0.0, q_x0 * log_b_t)
    cross_mt = cross_mt + n_other * q_other * log_b_t
    cross_mp = (q_other * sum_log_Mp + (q_x0 - q_other) * log_Mp_x0
                + torch.where(is_same, 0.0, (q_xt - q_other) * log_Mp_xt))
    q_total = torch.where(is_same, q_x0, q_x0 + q_xt) + n_other * q_other
    cross = cross_mt + cross_mp - q_total * torch.log(denom_pred + _EPS)
    return _mean_over_valid(ent - cross, x_mask)
