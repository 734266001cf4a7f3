"""Plain float32 FDDM denoising decoder and the jumpy sampler's posterior.

The benchmark's yardstick for the decoder and the sampler, written from the
FDDM reference's description (`models/denoise_decoder.py` of
github.com/TeemoCaption/FDDM-asr): post-LN blocks of self-attention,
cross-attention to the acoustic condition, FiLM on the mean-pooled condition
and a GELU FFN; RoPE rotating the whole d_model embedding before the q/k
projections with the interleaved split; a sinusoidal time embedding through a
4x SiLU MLP, added to every position; the pad row of the token embedding read
as zero.  Dropout, in a training step, applies the program's own keep masks
(`GivenDropout`) at the program's places.  Parameter names are the
reference `.pt`'s.  Imports torch and numpy only.

The schedule and the multi-step posterior are the reference's cosine schedule
and its aliased b-term recurrence in closed form (`ref_compat`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
NEG = torch.finfo(torch.float32).min


class MHA(nn.Module):
    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, q_in, k_in, v_in, key_mask: Optional[torch.Tensor], drop=None):
        """`drop`: the dropout of the attention weights (training), if any."""
        B, Lq, d = q_in.shape
        Lk = k_in.shape[1]
        w, b = self.in_proj_weight, self.in_proj_bias
        H = self.nhead
        q = F.linear(q_in, w[:d], b[:d]).reshape(B, Lq, H, -1).transpose(1, 2)
        k = F.linear(k_in, w[d:2 * d], b[d:2 * d]).reshape(B, Lk, H, -1).transpose(1, 2)
        v = F.linear(v_in, w[2 * d:], b[2 * d:]).reshape(B, Lk, H, -1).transpose(1, 2)
        s = q @ k.transpose(-1, -2) / math.sqrt(d // H)
        if key_mask is not None:
            s = s.masked_fill(~key_mask[:, None, None, :], NEG)
        weights = torch.softmax(s, dim=-1)
        if drop is not None:
            weights = drop(weights)
        out = (weights @ v).transpose(1, 2).reshape(B, Lq, d)
        return self.out_proj(out)


class Film(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale_proj, self.shift_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, pooled):
        return x * (1.0 + self.scale_proj(pooled)[:, None]) + self.shift_proj(pooled)[:, None]


class Block(nn.Module):
    def __init__(self, d: int, nhead: int, dim_ff: int):
        super().__init__()
        self.self_attn, self.cross_attn = MHA(d, nhead), MHA(d, nhead)
        self.film_layer = Film(d)
        self.ff = nn.Sequential(nn.Linear(d, dim_ff), nn.GELU(), nn.Identity(),
                                nn.Linear(dim_ff, d))
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)


class TimeEmbedding(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(d, 4 * d), nn.SiLU(), nn.Linear(4 * d, d))


class Rope(nn.Module):
    def __init__(self, d: int, base: float = 10000.0):
        super().__init__()
        self.register_buffer("inv_freq",
                             1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32) / d)))


class Decoder(nn.Module):
    """f(x_t, t, c) -> logits [B, L, K] float32 (rope positions, FiLM on)."""

    def __init__(self, vocab: int, d: int, nhead: int, layers: int, dim_ff: int, pad_id: int):
        super().__init__()
        self.d, self.pad_id = d, pad_id
        self.tok_emb = nn.Embedding(vocab, d)
        self.pos_emb = Rope(d)
        self.time_emb = TimeEmbedding(d)
        self.time_proj = nn.Linear(d, d)
        self.blocks = nn.ModuleList(Block(d, nhead, dim_ff) for _ in range(layers))
        self.head = nn.Linear(d, vocab)

    def rope(self, x):
        L = x.shape[1]
        f = torch.outer(torch.arange(L, dtype=torch.float32, device=x.device),
                        self.pos_emb.inv_freq)
        emb = torch.cat([f, f], dim=-1)
        cos, sin = emb.cos(), emb.sin()
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.cat([x1 * cos[:, 0::2] - x2 * sin[:, 1::2],
                          x1 * sin[:, 0::2] + x2 * cos[:, 1::2]], dim=-1)

    def embed(self, xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Token embeddings (the pad row read as zero) plus the time embedding."""
        d = self.d
        x = self.tok_emb(xt) * (xt != self.pad_id)[..., None]
        freqs = torch.exp(-torch.linspace(0.0, math.log(10000.0), d // 2, device=xt.device))
        args = t.float()[:, None] * freqs[None]
        te = self.time_emb.mlp(torch.cat([args.sin(), args.cos()], dim=1))
        return x + self.time_proj(te)[:, None]

    def mask(self, xt: torch.Tensor) -> torch.Tensor:
        """The self-attention's key mask: not pad; an all-pad row sees every position."""
        mask = xt != self.pad_id
        return mask | ~mask.any(dim=-1, keepdim=True)

    @staticmethod
    def pool(cond: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The condition's mean over its frames (over the kept ones under a mask)."""
        if key_mask is None:
            return cond.mean(dim=1)
        m = key_mask.float()[..., None]
        return (cond * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)

    def ffn(self, j: int, x: torch.Tensor, drop=None) -> torch.Tensor:
        """Block j's feed-forward (its hidden activation dropped under `drop`)."""
        ff = self.blocks[j].ff
        h = F.gelu(ff[0](x))
        return ff[3](drop(h) if drop is not None else h)

    def block(self, j: int, x, cond, mask, drop=None) -> torch.Tensor:
        """Block j; `drop` (training): the dropout of the attention weights,
        of each sublayer's output and of the FFN's hidden activation, in the
        order the program draws them."""
        blk = self.blocks[j]
        keep = drop if drop is not None else (lambda h: h)
        r = self.rope(x)
        x = blk.norm1(x + keep(blk.self_attn(r, r, x, mask, drop)))
        x = blk.norm2(x + keep(blk.cross_attn(x, cond, cond, None, drop)))
        x = blk.film_layer(x, self.pool(cond))
        return blk.norm3(x + keep(self.ffn(j, x, drop)))

    def forward(self, xt: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                keep: Optional[torch.Tensor] = None, drop=None) -> torch.Tensor:
        """`keep` [B, L]: the self-attention's keys (default: x_t's non-pad
        tokens; training passes the target's); `drop` as in `block`."""
        x = self.embed(xt, t)
        mask = self.mask(xt) if keep is None else keep | ~keep.any(dim=-1, keepdim=True)
        for j in range(len(self.blocks)):
            x = self.block(j, x, cond, mask, drop)
        return self.head(x)


class GivenDropout:
    """Dropout with given keep masks, taken in the order they come: a mask
    whose shape differs from its activation's is a misaligned order and
    raises."""

    def __init__(self, masks, p: float):
        self.masks, self.p, self.used = iter(masks), p, 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = next(self.masks).to(x.device)
        if m.shape != x.shape:
            raise RuntimeError(f"dropout mask {self.used}: shape {tuple(m.shape)}, "
                               f"activation {tuple(x.shape)}")
        self.used += 1
        return x * m / (1.0 - self.p)


class Schedule:
    """The cosine schedule beta_t = beta_max sin^2(pi t / 2T), tables of
    length T + 1 (index 0 the identity), as float32 tensors."""

    def __init__(self, K: int, T: int, beta_max: float, device):
        t = np.arange(1, T + 1, dtype=np.float32)
        betas = (beta_max * np.sin(0.5 * np.pi * (t / float(T))) ** 2).astype(np.float32)
        abar = np.cumprod(1.0 - betas).astype(np.float32)
        abar_ext64 = np.concatenate([[1.0], abar]).astype(np.float64)
        prefix = np.concatenate([[0.0], np.cumsum(betas.astype(np.float64) / abar_ext64[:-1])])
        as_t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.K, self.T = K, T
        self.betas = as_t(np.concatenate([[0.0], betas]))
        self.abar = as_t(np.concatenate([[1.0], abar]))
        self.prefix = as_t(prefix)

    def posterior(self, x_t: torch.Tensor, p0: torch.Tensor, t: int, delta: int) -> torch.Tensor:
        """q(x_{t-delta} | x_t, p0) [B, L, K] with the reference's b-term
        (b_cum = abar_t / K * (S_t - S_{t-delta}))."""
        K = self.K
        tg = max(t - delta, 0)
        a_c = self.abar[t] / self.abar[tg]
        b_c = self.abar[t] / K * (self.prefix[t] - self.prefix[tg])
        a_tg, b_tg = 1.0 - self.betas[tg], self.betas[tg] / K
        onehot = F.one_hot(x_t, K).float()
        A = a_c * onehot + b_c
        Bv = a_tg * p0 + b_tg * p0.sum(-1, keepdim=True)
        dot = p0.gather(-1, x_t[..., None])
        denom = a_c * dot + b_c * p0.sum(-1, keepdim=True)
        q = (A * Bv / denom.clamp(min=1e-8)).clamp(min=1e-8)
        return q / q.sum(-1, keepdim=True).clamp(min=1e-8)


def jumps(T_infer: int, r: int):
    """[(t, delta)] of `while t > 0: delta = min(r, t); t -= delta`."""
    out, t = [], T_infer
    while t > 0:
        out.append((t, min(r, t)))
        t -= min(r, t)
    return out
