# -*- coding: utf-8 -*-
"""Sequence-parallel ring attention for WavLM's gated relative-position attention.

Counterpart of `fddm_asr_tpu/ops/ring_attention.py`: one utterance's frames
are split over the ranks of a process group (the mesh's "model" axis), rank
r holding frames [r l, (r + 1) l).  Its queries stay; the key, value and
key-mask blocks travel around the ring, one hop a step (rank i sends to
i - 1 and receives from i + 1, the JAX ring's ppermute), and each block is
folded into a running softmax in float32.  WavLM's position
bias enters as the rank's query rows of every key column, [H, l, L], and
the per-query gate [B, H, l] is local.  Scores are float32; masked keys sit
at float32's minimum, so a row whose keys are all masked gives the uniform
average of the values, as the XLA softmax of the JAX package does.

The per-block products are plain torch matmuls, as they are XLA einsums
outside any Pallas kernel in the JAX package: the ring has no hand-written
kernel (and `PERF.md` §6 no row).

Each hop is `fddm::ring_shift` (`parallel/distributed.py`), an op that
`torch.export` records, so an exported sequence-parallel program holds the
ring.  Under autograd it is an autograd Function.  The forward keeps each
query row's running max and sum, not the [l, l] probabilities (24 layers
times the ring's steps of [B, H, l, l] float32 tiles would not fit two
ranks on one card at full width).  The backward is a second ring: each
step recomputes one block's probabilities from the saved max and sum, and
the block's dK and dV accumulators travel with K and V, so after n steps
and one more hop they are back at the rank that owns those frames.  dQ,
the gate's gradient and the bias rows' gradient stay on the rank.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fddm_asr_tpu_torch.parallel.distributed import ring_rank, ring_shift

__all__ = ["ring_gated_attention"]

_NEG = float(np.finfo(np.float32).min)


def _rotate(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor one hop around the ring, all packed into one byte buffer
    (widest elements first, so every view stays aligned).  A ring of one
    keeps them where they are."""
    if dist.get_world_size(group) == 1:
        return list(tensors)
    order = sorted(range(len(tensors)), key=lambda i: -tensors[i].element_size())
    flat = torch.cat([tensors[i].contiguous().view(-1).view(torch.uint8) for i in order])
    got = ring_shift(flat, group)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    offset = 0
    for i in order:
        t = tensors[i]
        nbytes = t.numel() * t.element_size()
        out[i] = got[offset:offset + nbytes].view(t.dtype).view(t.shape)
        offset += nbytes
    return out  # type: ignore[return-value]


def _scores(qh, k_blk, bias_blk, gate_f, mask_blk):
    """Float32 scores of local queries against one key block: (q scale) k^T
    + gate * bias, masked keys at float32's minimum.  [B, H, l, l]."""
    kf = k_blk.float().permute(0, 2, 3, 1)  # [B, H, dh, l]
    s = torch.matmul(qh, kf)
    s.add_(gate_f * bias_blk.float()[None])
    return s.masked_fill_(~mask_blk[:, None, None, :], _NEG)


def _ring_forward(q, k, v, bias_rows, gate, key_mask, group):
    """(out [B, l, H, dh] in q's dtype, the running max and sum [B, H, l])
    of this rank's queries over the ring's key blocks."""
    me, n = ring_rank(group)
    B, l, H, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qh = q.float().permute(0, 2, 1, 3) * scale           # [B, H, l, dh]
    gate_f = gate.float()[..., None]                      # [B, H, l, 1]
    m = torch.full((B, H, l), -math.inf, dtype=torch.float32, device=q.device)
    s = torch.zeros((B, H, l), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, l, dh), dtype=torch.float32, device=q.device)
    k_blk, v_blk, mask_blk = k, v, key_mask
    for step in range(n):
        src = (me + step) % n  # the rank whose frames are resident now
        scores = _scores(qh, k_blk, bias_rows[:, :, src * l:(src + 1) * l], gate_f, mask_blk)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        e = torch.exp(scores.sub_(m_new[..., None]))
        s = s * corr + e.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(e, v_blk.float().permute(0, 2, 1, 3))
        m = m_new
        del scores, e
        if step < n - 1:
            k_blk, v_blk, mask_blk = _rotate((k_blk, v_blk, mask_blk), group)
    out = (acc / s[..., None]).permute(0, 2, 1, 3).to(q.dtype)  # [B, l, H, dh]
    return out, m, s


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias_rows, gate, key_mask, group):
        out, m, s = _ring_forward(q, k, v, bias_rows, gate, key_mask, group)
        ctx.save_for_backward(q, k, v, bias_rows, gate, key_mask, out, m, s)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias_rows, gate, key_mask, out, m, s = ctx.saved_tensors
        group = ctx.group
        me, n = ring_rank(group)
        B, l, H, dh = q.shape
        scale = 1.0 / math.sqrt(dh)
        want_bias = ctx.needs_input_grad[3]
        qh = q.float().permute(0, 2, 1, 3) * scale
        gate_f = gate.float()[..., None]
        d_o = dout.float().permute(0, 2, 1, 3)                 # [B, H, l, dh]
        delta = (d_o * out.float().permute(0, 2, 1, 3)).sum(dim=-1, keepdim=True)
        inv_s = (1.0 / s)[..., None]
        dq = torch.zeros_like(qh)
        dgate = torch.zeros((B, H, l), dtype=torch.float32, device=q.device)
        dbias = torch.zeros(bias_rows.shape, dtype=torch.float32, device=q.device) \
            if want_bias else None
        k_blk, v_blk, mask_blk = k, v, key_mask
        dk_blk = torch.zeros((B, H, l, dh), dtype=torch.float32, device=q.device)
        dv_blk = torch.zeros_like(dk_blk)
        for step in range(n):
            src = (me + step) % n
            cols = slice(src * l, (src + 1) * l)
            bias_blk = bias_rows[:, :, cols]
            kf = k_blk.float().permute(0, 2, 1, 3)
            p = _scores(qh, k_blk, bias_blk, gate_f, mask_blk)
            p = torch.exp(p.sub_(m[..., None])).mul_(inv_s)      # the forward's probabilities
            dv_blk += torch.matmul(p.transpose(-1, -2), d_o)
            dp = torch.matmul(d_o, v_blk.float().permute(0, 2, 3, 1))
            ds = p.mul_(dp.sub_(delta))
            del dp
            ds.masked_fill_(~mask_blk[:, None, None, :], 0.0)
            dq += torch.matmul(ds, kf)
            dk_blk += torch.matmul(ds.transpose(-1, -2), qh)
            dgate += (ds * bias_blk.float()[None]).sum(dim=-1)
            if want_bias:
                dbias[:, :, cols] += (ds * gate_f).sum(dim=0)
            del ds
            if step < n - 1:
                k_blk, v_blk, mask_blk, dk_blk, dv_blk = _rotate(
                    (k_blk, v_blk, mask_blk, dk_blk, dv_blk), group)
        dk_blk, dv_blk = _rotate((dk_blk, dv_blk), group)  # home to the frames' owner
        to_bldh = lambda t, like: t.permute(0, 2, 1, 3).to(like.dtype)  # noqa: E731
        return (to_bldh(dq * scale, q), to_bldh(dk_blk, k), to_bldh(dv_blk, v),
                None if dbias is None else dbias.to(bias_rows.dtype),
                dgate.to(gate.dtype), None, None)


def ring_gated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos_bias_rows: torch.Tensor, gate: torch.Tensor,
                         key_mask: Optional[torch.Tensor], group) -> torch.Tensor:
    """Gated attention of this rank's frames over the whole sequence of the
    ring `group`.

    q, k, v        [B, l, H, dh]  this rank's frame block (l = L / ring size)
    pos_bias_rows  [H, l, L]      the position bias at this rank's query rows
    gate           [B, H, l]      per-query gate
    key_mask       [B, l] bool    this block's keys, True = keep; None = all
    -> out [B, l, H, dh] in q's dtype, differentiable in q, k, v, the bias
    rows and the gate."""
    B, l, H, dh = q.shape
    n = dist.get_world_size(group)
    if pos_bias_rows.shape != (H, l, l * n):
        raise ValueError(f"pos_bias_rows {tuple(pos_bias_rows.shape)}: expected "
                         f"{(H, l, l * n)}, this rank's {l} query rows of {l * n} keys")
    if key_mask is None:
        key_mask = torch.ones((B, l), dtype=torch.bool, device=q.device)
    key_mask = key_mask.contiguous()
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v, pos_bias_rows, gate))):
        # no autograd record: what a trace sees, the hops as `fddm::ring_shift`
        return _ring_forward(q, k, v, pos_bias_rows, gate, key_mask, group)[0]
    return _RingAttention.apply(q, k, v, pos_bias_rows, gate, key_mask, group)
