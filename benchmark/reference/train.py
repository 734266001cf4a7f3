"""Plain float32 fine-tune step of FDDM-ASR: the loss, its gradient, AdamW
and the EMA, written from the FDDM reference's description and optax's
definitions.  Imports torch and numpy only.

  * the diffusion KL between q(x_{t-1} | x_t, x_0) and the model's
    posterior with x0hat = softmax(logits) (one-step transitions
    M_t = (1 - beta_t) I + beta_t / K 11^T), a per-row mean over the target's
    tokens, then the batch mean;
  * L_fd every n-th step: the speech projection of the condition (its first
    L frames) against the text projection of softmax(logits), each
    standardised over the batch, sum_j (1 - C_jj)^2 + lambda sum_{j!=k} C_jk^2,
    weighted by tau and the batch mean of alpha_bar_t;
  * AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) after a clip
    by the global norm, over two learning-rate groups, linear warm-up then
    cosine decay; an EMA of the trained parameters with decay
    min(cap, (1 + step) / (10 + step)).

The decoder's dropout applies given keep masks (the program's draws) at the
program's places.  The gradient comes in two passes, since L_fd standardises over the whole
batch: the encoder's output for every row is made a leaf, the decoder, the
heads and the loss run on the whole batch and give the leaf's gradient; then
the encoder runs again in blocks of rows, each block's output given its rows
of that gradient.  The conv front-end is frozen and runs without a gradient.
`fp8` rounds every matmul's and conv's operands to float8 e4m3 in the
forward pass (a straight-through rounding): the comparison's control.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from reference.wavlm import AcousticEncoder, _fp8, in_blocks

EPS = 1e-8


class _MLP(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(d_in, d_out))


class SpeechProjector(nn.Module):
    def __init__(self, d_in: int, d_proj: int):
        super().__init__()
        self.proj = _MLP(d_in, d_proj)


class TextEmbedding(nn.Module):
    def __init__(self, vocab: int, d_proj: int):
        super().__init__()
        self.proj = nn.Linear(vocab, d_proj, bias=False)


class TextProjector(nn.Module):
    def __init__(self, d_proj: int):
        super().__init__()
        self.proj = _MLP(d_proj, d_proj)


def kl_loss(betas: torch.Tensor, xt, x0, logits, t, mask) -> torch.Tensor:
    """KL[q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t, x0hat)] over [B, L, K] in
    the reference's form: (M_t^T x_t) . (M_{t-1} x) divided by the analytic
    x_t^T M_t x (not a sum to one), x0hat = softmax(logits); a mean over
    each row's `mask`, then over rows."""
    K = logits.shape[-1]
    b_t, b_p = betas[t][:, None, None], betas[(t - 1).clamp(min=0)][:, None, None]
    xt1, x01 = F.one_hot(xt, K).float(), F.one_hot(x0, K).float()
    p0 = torch.softmax(logits.float(), dim=-1)
    MtT = b_t / K + (1 - b_t) * xt1
    d_true = b_t[..., 0] / K + (1 - b_t[..., 0]) * (x01 * xt1).sum(-1)
    d_pred = b_t[..., 0] / K + (1 - b_t[..., 0]) * p0.gather(-1, xt[..., None])[..., 0]
    q = MtT * ((1 - b_p) * x01 + b_p / K) / (d_true[..., None] + EPS)
    log_p = (torch.log(MtT) + torch.log((1 - b_p) * p0 + b_p / K + EPS)
             - torch.log(d_pred[..., None] + EPS))
    kl = (q * (torch.log(q + EPS) - log_p)).sum(-1)
    m = mask.float()
    return ((kl * m).sum(1) / (m.sum(1) + EPS)).mean()


def lfd_loss(z_a: torch.Tensor, z_b: torch.Tensor, lam: float, eps: float = 1e-5):
    def standardize(z):
        return (z - z.mean(0, keepdim=True)) / torch.sqrt(z.var(0, unbiased=False,
                                                                 keepdim=True) + eps)
    B, T, D = z_a.shape
    C = standardize(z_a).reshape(B * T, D).T @ standardize(z_b).reshape(B * T, D) / (B * T)
    diag = torch.diagonal(C)
    return ((1 - diag) ** 2).sum() + lam * ((C ** 2).sum() - (diag ** 2).sum())


def lr_at(count: int, lr: float, warmup: int, decay_steps: int, end: float = 0.0) -> float:
    """Linear warm-up from 0 over `warmup` updates, then cosine to `end` at
    `decay_steps` (counted from the start)."""
    if count < warmup:
        return lr * count / warmup
    span = decay_steps - warmup
    cosine = 0.5 * (1 + math.cos(math.pi * min(count - warmup, span) / span))
    alpha = end / lr if lr else 0.0
    return lr * ((1 - alpha) * cosine + alpha)


class _Fp8Operands(TorchFunctionMode):
    """Float8 operands for every linear, conv and matmul in the forward pass;
    the backward sees the rounding as the identity."""

    OPS = {F.linear, F.conv1d, torch.matmul, torch.Tensor.__matmul__, torch.bmm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            def q(x):
                if not torch.is_tensor(x) or not x.is_floating_point():
                    return x
                return x + (_fp8(x.detach()) - x).detach()
            n = 1 if func in (F.linear, F.conv1d) else 2
            args = tuple(q(a) if i <= n else a for i, a in enumerate(args))
        return func(*args, **kwargs)


class Trainer:
    """The reference's fine-tune, step by step.  `params` is every trained
    parameter by the program's name (decoder., s_proj., t_embed., t_proj.,
    encoder.)."""

    def __init__(self, enc: AcousticEncoder, dec: nn.Module, heads: Dict[str, nn.Module],
                 sched_betas: torch.Tensor, sched_abar: torch.Tensor, recipe: dict,
                 rows: int = 2, fp8: bool = False):
        self.enc, self.dec, self.heads = enc, dec, heads
        self.betas, self.abar = sched_betas, sched_abar
        self.r, self.rows, self.fp8 = recipe, rows, fp8
        enc.backbone.feature_extractor.requires_grad_(False)
        self.params: Dict[str, nn.Parameter] = {}
        for prefix, module in [("decoder", dec), *heads.items(), ("encoder", enc)]:
            for name, p in module.named_parameters():
                if p.requires_grad:
                    self.params[f"{prefix}.{name}"] = p
        self.group = {n: "encoder" if n.startswith("encoder.") else "main" for n in self.params}
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.ema = {n: p.detach().clone() for n, p in self.params.items()}
        self.count = 0

    def _mode(self):
        return _Fp8Operands() if self.fp8 else contextlib.nullcontext()

    def step(self, wave, x0, t, xt, time_mask, apply_lfd: bool, drop=None) -> Dict[str, float]:
        """One step; `drop`: the decoder's dropout (`decoder.GivenDropout`)."""
        r, enc, dec, pad = self.r, self.enc, self.dec, self.dec.pad_id
        with self._mode():
            with torch.no_grad():
                feats = in_blocks(enc.conv_features, wave, self.rows)
                c = torch.cat([enc.layers(enc.project(feats[i:i + self.rows],
                                                      time_mask[i:i + self.rows]))
                               for i in range(0, wave.shape[0], self.rows)])
            c = c.requires_grad_()
            mask = x0 != pad
            logits = dec(xt, t, c, mask, drop=drop)
            loss_kl = kl_loss(self.betas, xt, x0, logits, t, mask)
            loss = loss_kl
            out = {"loss_diff": loss_kl}
            if apply_lfd:
                h = self.heads
                z_text = h["t_proj"].proj.net[0](h["t_embed"].proj(torch.softmax(logits, -1)))
                z_speech = h["s_proj"].proj.net[0](c)[:, :x0.shape[1]]
                loss_fd = lfd_loss(z_speech, z_text, r["lambda_offdiag"])
                loss = loss + r["tau"] * self.abar[t].mean() * loss_fd
                out["loss_fd"] = loss_fd
            out["total_loss"] = loss
            for p in self.params.values():
                p.grad = None
            loss.backward()
            g_c = c.grad
            for i in range(0, wave.shape[0], self.rows):
                part = enc.layers(enc.project(feats[i:i + self.rows], time_mask[i:i + self.rows]))
                part.backward(g_c[i:i + self.rows])
        self._update()
        return {k: float(v.detach()) for k, v in out.items()}

    @torch.no_grad()
    def _update(self) -> None:
        r = self.r
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        if not bool(norm < r["grad_clip"]):
            grads = {n: g / norm * r["grad_clip"] for n, g in grads.items()}
        self.first_grads = getattr(self, "first_grads", None) or {
            n: g.clone() for n, g in grads.items()}
        b1, b2, eps, c = 0.9, 0.999, 1e-8, self.count + 1
        lr = {"main": lr_at(self.count, r["lr"], r["warmup_steps"], r["decay_steps"]),
              "encoder": lr_at(self.count, r["encoder_lr"], r["warmup_steps"],
                               r["decay_steps"])}
        for n, p in self.params.items():
            g = grads[n]
            self.mu[n].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.mu[n] / (1 - b1 ** c)) / ((self.nu[n] / (1 - b2 ** c)).sqrt() + eps)
            p.sub_(lr[self.group[n]] * (upd + r["weight_decay"] * p))
            p.grad = None
        self.count = c
        decay = float(np.minimum(np.float32(r["ema_decay"]),
                                 np.float32(1 + c) / np.float32(10 + c)))
        for n, p in self.params.items():
            self.ema[n].add_((p - self.ema[n]) * (1 - decay))


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              names: List[str]) -> float:
    """The worst leaf's |‖got‖ - ‖want‖| over the larger of ‖want‖ and the
    median leaf's ‖want‖, over `names`."""
    norms = {n: float(want[n].norm()) for n in names}
    median = float(np.median(list(norms.values())))
    return max(abs(float(got[n].norm()) - norms[n]) / max(norms[n], median) for n in names)
