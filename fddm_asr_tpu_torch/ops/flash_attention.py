# -*- coding: utf-8 -*-
"""WavLM gated relative-position-bias attention: Hopper kernels + plain versions.

    scores = q k^T / sqrt(dh) + gate[b, h, q] * pos_bias[h, q, k]   (f32)
    scores[masked keys] = f32-min
    out    = softmax(scores).to(v.dtype) @ v

Counterpart of `fddm_asr_tpu/ops/flash_attention.py`.  The TPU package runs
six Pallas kernels here; the port has hand-written CUDA kernels for Hopper:

  * `csrc/gated_attention.cu`, one online-softmax forward for every L.  It
    replaces `_kernel_packed` (L <= 4096) and `_kernel_packed_flash`
    (L > 4096), writing the row logsumexp as well the training forward
    `_kernel_packed_fwd_lse`, and through `wavlm_gated_attention` on
    [B, L, H, dh] operands the per-head `_kernel`;
  * `csrc/gated_attention_bwd.cu`, the backward: kernel A (dq, dgate) for
    `_kernel_packed_bwd_dq` and kernel B (dk, dv, dbias) for
    `_kernel_packed_bwd_dkv`.

Operands use the head-packed layout the projections produce: q/k/v/out
[B, L, H*dh], pos_bias [H, L, L] in q's dtype, gate [B, H, L] float32,
key_mask [B, L] bool (True = keep), lse and delta [B, H, L] float32.

Routing is by the device of the tensors and nothing else: a CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.  The kernels
are compiled with nvcc on first use (`ops/_build.py`).  bfloat16 runs on the tensor cores
(wgmma in the forward and in the backward); the float32 forward and the
float32 backward kernels run 3xTF32 on wgmma (each operand split into tf32
hi and lo, three products).

Training goes through `wavlm_gated_attention_heads_packed_trainable`: on the
CPU the plain version, which autograd differentiates; on CUDA the autograd
Function `GatedAttentionTrain`, whose forward saves the row logsumexp and
whose backward runs the two backward kernels.  Its gradients are those of
the plain forward exactly, including at rows whose keys are all masked
(where the forward averages v over the L real keys).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from fddm_asr_tpu_torch.ops import _build
from fddm_asr_tpu_torch.ops._build import DTYPE_CODE as _DTYPE_CODE
from fddm_asr_tpu_torch.ops._build import check_tensor as _check
from fddm_asr_tpu_torch.ops._build import launch as _launch
from fddm_asr_tpu_torch.ops._build import ptr as _ptr

_NEG_INF = torch.finfo(torch.float32).min
HEAD_DIM = 64  # the kernels' only head dim (WavLM's)

_build.register("fddm_gated_attention", "gated_attention", [_build.P] * 8 + [_build.I] * 4)
_build.register("fddm_gated_attention_bwd_dq", "gated_attention_bwd",
                [_build.P] * 11 + [_build.I] * 4)
_build.register("fddm_gated_attention_bwd_dkv", "gated_attention_bwd",
                [_build.P] * 12 + [_build.I] * 4)


# ------------------------------------------------------------ plain versions
def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, L, HD = x.shape
    return x.reshape(B, L, num_heads, HD // num_heads).transpose(1, 2)  # [B, H, L, dh]


def _packed(x: torch.Tensor) -> torch.Tensor:
    B, H, L, dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * dh)


def _gated_scores(q, k, pos_bias, gate, key_mask, num_heads) -> torch.Tensor:
    """[B, H, L, L] f32: the f32 product scaled, plus the gated bias; masked
    keys f32-min.  Every version (and kernel) computes S this way.  The
    in-place steps keep one [B, H, L, L] buffer; autograd saves none of
    their inputs that they overwrite."""
    dh = q.shape[-1] // num_heads
    scores = torch.matmul(_heads(q, num_heads).float(),
                          _heads(k, num_heads).float().transpose(-1, -2))
    scores.mul_(1.0 / dh ** 0.5)
    scores.addcmul_(gate[..., None].float(), pos_bias[None].float())
    if key_mask is not None:
        scores.masked_fill_(~key_mask[:, None, None, :], _NEG_INF)
    return scores


def wavlm_gated_attention_plain(
    q: torch.Tensor,          # [B, L, H*dh]
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: torch.Tensor,   # [H, L, L]
    gate: torch.Tensor,       # [B, H, L]
    key_mask: Optional[torch.Tensor] = None,  # [B, L] True=keep
    num_heads: int = 16,
) -> torch.Tensor:
    """Plain PyTorch version (the XLA reference's math, head-packed layout).

    The CPU path (inference and training: autograd differentiates it), the
    tests' reference and `chip_smoke.py`'s yardstick.  It materialises the
    [B, H, L, L] f32 scores; the kernels never do."""
    scores = _gated_scores(q, k, pos_bias, gate, key_mask, num_heads)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    return _packed(torch.matmul(weights, _heads(v, num_heads)))


def wavlm_gated_attention_fwd_lse_plain(q, k, v, pos_bias, gate, key_mask=None,
                                        num_heads: int = 16
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the plain forward and the row logsumexp [B, H, L] f32 of
    its scores (f32-min at a row whose keys are all masked)."""
    scores = _gated_scores(q, k, pos_bias, gate, key_mask, num_heads)
    lse = torch.logsumexp(scores, dim=-1)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    del scores
    return _packed(torch.matmul(weights, _heads(v, num_heads))), lse


def wavlm_gated_attention_bwd_plain(q, k, v, pos_bias, gate, key_mask, out, lse, dout,
                                    num_heads: int = 16):
    """(dq, dk, dv, dbias, dgate) of the plain forward, from the formulas the
    kernels use (`fddm_asr_tpu/ops/flash_attention.py:391-401`):

        P = exp(S - lse), dP = dO V^T, dS = P (dP - delta), delta = rowsum(dO O)
        dq = scale dS K, dk = scale dS^T Q, dv = P^T dO,
        dbias = sum_b dS gate, dgate = rowsum(dS bias)

    with dS = 0 at masked keys (their score is a constant) and P = 1/L there
    at a row whose keys are all masked (lse = f32-min).  dS and P are rounded
    to q's dtype before the second products, as the kernels round them;
    dbias is summed in f32 and returned in pos_bias's dtype."""
    B, L, HD = q.shape
    H = num_heads
    scale = 1.0 / (HD // H) ** 0.5
    s = _gated_scores(q, k, pos_bias, gate, key_mask, H)
    p = torch.exp(s - lse[..., None])
    del s
    delta = (dout.float() * out.float()).reshape(B, L, H, -1).sum(-1).transpose(1, 2)
    dp = torch.matmul(_heads(dout, H).float(), _heads(v, H).float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    del dp
    if key_mask is not None:
        masked = ~key_mask[:, None, None, :]
        ds = ds.masked_fill(masked, 0.0)
        p = torch.where(masked, p / L, p)
    low = q.dtype
    ds_low = ds.to(low).float()
    dq = torch.matmul(ds_low, _heads(k, H).float()) * scale
    dk = torch.matmul(ds_low.transpose(-1, -2), _heads(q, H).float()) * scale
    del ds_low
    dv = torch.matmul(p.to(low).float().transpose(-1, -2), _heads(dout, H).float())
    del p
    dbias = (ds * gate[..., None].float()).sum(0)
    dgate = (ds * pos_bias[None].float()).sum(-1)
    return (_packed(dq).to(low), _packed(dk).to(low), _packed(dv).to(low),
            dbias.to(pos_bias.dtype), dgate)


# ------------------------------------------------------------------ kernels
def _check_operands(q, k, v, pos_bias, gate, key_mask, num_heads,
                    lse=None, delta=None, dout=None):
    """Check the kernels' operands (lse, delta [B, H, L] f32 and dout, q's
    shape and type, where given).  Returns (B, L, H)."""
    if q.device.type != "cuda":
        raise ValueError(f"the gated-attention kernels need CUDA tensors, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, L, H*dh], got shape {tuple(q.shape)}")
    B, L, HD = q.shape
    H = num_heads
    if H * HEAD_DIM != HD:
        raise ValueError(f"the kernels need head dim {HEAD_DIM}; got H*dh={HD} with H={H}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernels take float32 or bfloat16, got {q.dtype}")
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if x is not None:
            _check(name, x, (B, L, HD), q.dtype, dev)
    _check("pos_bias", pos_bias, (H, L, L), q.dtype, dev)
    for name, x in (("gate", gate), ("lse", lse), ("delta", delta)):
        if x is not None:
            _check(name, x, (B, H, L), torch.float32, dev)
    if key_mask is not None:
        _check("key_mask", key_mask, (B, L), torch.bool, dev)
    return B, L, H


def _forward_cuda(q, k, v, pos_bias, gate, key_mask, num_heads, with_lse: bool):
    B, L, H = _check_operands(q, k, v, pos_bias, gate, key_mask, num_heads)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, L, device=q.device, dtype=torch.float32) if with_lse else None
    _launch("fddm_gated_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            pos_bias.data_ptr(), gate.data_ptr(), _ptr(key_mask), out.data_ptr(), _ptr(lse),
            B, L, H, _DTYPE_CODE[q.dtype])
    return out, lse


def wavlm_gated_attention_cuda(q, k, v, pos_bias, gate, key_mask=None,
                               num_heads: int = 16) -> torch.Tensor:
    """B1/B2: launch the forward kernel on CUDA tensors (raises on anything
    else).  Adds one to `wavlm_gated_attention_cuda.launches` per launch."""
    out, _ = _forward_cuda(q, k, v, pos_bias, gate, key_mask, num_heads, with_lse=False)
    wavlm_gated_attention_cuda.launches += 1
    return out


def wavlm_gated_attention_fwd_lse_cuda(q, k, v, pos_bias, gate, key_mask=None,
                                       num_heads: int = 16):
    """B3: the same forward kernel, also writing the row logsumexp; returns
    (out, lse).  Adds one to `.launches` per launch."""
    out, lse = _forward_cuda(q, k, v, pos_bias, gate, key_mask, num_heads, with_lse=True)
    wavlm_gated_attention_fwd_lse_cuda.launches += 1
    return out, lse


def wavlm_gated_attention_bwd_dq_cuda(q, k, v, pos_bias, gate, key_mask, lse, delta, dout,
                                      num_heads: int = 16):
    """B4: (dq, dgate) from backward kernel A.  Adds one to `.launches`."""
    B, L, H = _check_operands(q, k, v, pos_bias, gate, key_mask, num_heads,
                              lse=lse, delta=delta, dout=dout)
    dq = torch.empty_like(q)
    dgate = torch.empty(B, H, L, device=q.device, dtype=torch.float32)
    _launch("fddm_gated_attention_bwd_dq", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), pos_bias.data_ptr(), gate.data_ptr(), _ptr(key_mask),
            lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dgate.data_ptr(), B, L, H, _DTYPE_CODE[q.dtype])
    wavlm_gated_attention_bwd_dq_cuda.launches += 1
    return dq, dgate


def wavlm_gated_attention_bwd_dkv_cuda(q, k, v, pos_bias, gate, key_mask, lse, delta, dout,
                                       num_heads: int = 16):
    """B5: (dk, dv, dbias) from backward kernel B; dbias [H, L, L] is summed
    over the batch in f32 and returned in f32.  Adds one to `.launches`."""
    B, L, H = _check_operands(q, k, v, pos_bias, gate, key_mask, num_heads,
                              lse=lse, delta=delta, dout=dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dbias = torch.empty(H, L, L, device=q.device, dtype=torch.float32)
    _launch("fddm_gated_attention_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), pos_bias.data_ptr(), gate.data_ptr(), _ptr(key_mask),
            lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), B, L, H, _DTYPE_CODE[q.dtype])
    wavlm_gated_attention_bwd_dkv_cuda.launches += 1
    return dk, dv, dbias


def wavlm_gated_attention_bhld_cuda(q, k, v, pos_bias, gate, key_mask=None) -> torch.Tensor:
    """B6: the forward kernel on q/k/v [B, L, H, dh].  A contiguous
    [B, L, H, dh] tensor is the head-packed [B, L, H*dh] one, so this is a
    view and no copy (the TPU kernel's transposes to [B, H, L, dh] and its
    padding are Mosaic's needs, not the function's).  Adds one to its own
    `.launches` per launch."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, L, H, dh], got shape {tuple(q.shape)}")
    B, L, H, dh = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if tuple(x.shape) != (B, L, H, dh) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, L, H, dh] = {(B, L, H, dh)} "
                             f"tensor, got shape {tuple(x.shape)}")
    out, _ = _forward_cuda(q.view(B, L, H * dh), k.view(B, L, H * dh), v.view(B, L, H * dh),
                           pos_bias, gate, key_mask, H, with_lse=False)
    wavlm_gated_attention_bhld_cuda.launches += 1
    return out.view(B, L, H, dh)


for _wrapper in (wavlm_gated_attention_cuda, wavlm_gated_attention_fwd_lse_cuda,
                 wavlm_gated_attention_bwd_dq_cuda, wavlm_gated_attention_bwd_dkv_cuda,
                 wavlm_gated_attention_bhld_cuda):
    _wrapper.launches = 0


# --------------------------------------------------------------- dispatchers
def _heads_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_bias: torch.Tensor,
                  gate: torch.Tensor, key_mask: Optional[torch.Tensor],
                  num_heads: int) -> torch.Tensor:
    """B1/B2 on the tensors' device: CPU -> plain version, CUDA -> kernel."""
    if q.device.type == "cpu":
        return wavlm_gated_attention_plain(q, k, v, pos_bias, gate, key_mask, num_heads)
    return wavlm_gated_attention_cuda(q, k, v, pos_bias, gate, key_mask, num_heads)


# the op a trace records; eager calls skip its dispatch (tens of us a call)
torch.library.custom_op("fddm::gated_attention", _heads_packed, mutates_args=()).register_fake(
    lambda q, k, v, pos_bias, gate, key_mask, num_heads: torch.empty_like(q))


def wavlm_gated_attention_heads_packed(
    q, k, v, pos_bias, gate, key_mask=None, num_heads: int = 16,
) -> torch.Tensor:
    """Inference dispatch on the tensors' device: CPU -> plain version,
    CUDA -> kernel (no autograd graph through the kernel); a trace records
    the op `torch.ops.fddm.gated_attention`, which routes the same way."""
    if _build.tracing():
        return torch.ops.fddm.gated_attention(q, k, v, pos_bias, gate, key_mask, num_heads)
    return _heads_packed(q, k, v, pos_bias, gate, key_mask, num_heads)


def wavlm_gated_attention_bhld_plain(q, k, v, pos_bias, gate, key_mask=None) -> torch.Tensor:
    """Plain version on q/k/v [B, L, H, dh] (`wavlm_gated_attention_xla`'s
    layout and math): the head-packed plain version through a reshape."""
    B, L, H, dh = q.shape
    out = wavlm_gated_attention_plain(q.reshape(B, L, H * dh), k.reshape(B, L, H * dh),
                                      v.reshape(B, L, H * dh), pos_bias, gate, key_mask, H)
    return out.view(B, L, H, dh)


def _bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_bias: torch.Tensor,
          gate: torch.Tensor, key_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """B6 on the tensors' device: CPU -> plain version, CUDA -> kernel."""
    if q.device.type == "cpu":
        return wavlm_gated_attention_bhld_plain(q, k, v, pos_bias, gate, key_mask)
    return wavlm_gated_attention_bhld_cuda(q, k, v, pos_bias, gate, key_mask)


torch.library.custom_op("fddm::gated_attention_bhld", _bhld, mutates_args=()).register_fake(
    lambda q, k, v, pos_bias, gate, key_mask: torch.empty_like(q))


def wavlm_gated_attention(q, k, v, pos_bias, gate, key_mask=None) -> torch.Tensor:
    """Dispatch for q/k/v [B, L, H, dh] on the tensors' device: CPU -> plain
    version, CUDA -> the forward kernel (B6) or raise (dh other than 64
    raises on the card); a trace records `torch.ops.fddm.gated_attention_bhld`.
    No model path calls it, as in the JAX package."""
    if _build.tracing():
        return torch.ops.fddm.gated_attention_bhld(q, k, v, pos_bias, gate, key_mask)
    return _bhld(q, k, v, pos_bias, gate, key_mask)


def wavlm_gated_attention_fwd_lse(q, k, v, pos_bias, gate, key_mask=None,
                                  num_heads: int = 16):
    """(out, lse) on the tensors' device: CPU -> plain version, CUDA -> B3."""
    if q.device.type == "cpu":
        return wavlm_gated_attention_fwd_lse_plain(q, k, v, pos_bias, gate, key_mask,
                                                   num_heads)
    return wavlm_gated_attention_fwd_lse_cuda(q, k, v, pos_bias, gate, key_mask, num_heads)


BWD_DELTA_RANGE = "gated_attention_bwd_delta"  # the delta ops' range in a torch.profiler trace


def wavlm_gated_attention_bwd(q, k, v, pos_bias, gate, key_mask, out, lse, dout,
                              num_heads: int = 16):
    """(dq, dk, dv, dbias, dgate) on the tensors' device: CPU -> plain
    version; CUDA -> delta = rowsum(dO * O) in plain torch (the JAX package
    computes it in XLA too), then B4 and B5."""
    if q.device.type == "cpu":
        return wavlm_gated_attention_bwd_plain(q, k, v, pos_bias, gate, key_mask, out, lse,
                                               dout, num_heads)
    B, L, HD = q.shape
    with torch.profiler.record_function(BWD_DELTA_RANGE):
        delta = (dout.float() * out.float()).view(B, L, num_heads, -1).sum(-1)
        delta = delta.transpose(1, 2).contiguous()
    dq, dgate = wavlm_gated_attention_bwd_dq_cuda(q, k, v, pos_bias, gate, key_mask, lse,
                                                  delta, dout, num_heads)
    dk, dv, dbias = wavlm_gated_attention_bwd_dkv_cuda(q, k, v, pos_bias, gate, key_mask,
                                                       lse, delta, dout, num_heads)
    return dq, dk, dv, dbias.to(pos_bias.dtype), dgate


class GatedAttentionTrain(torch.autograd.Function):
    """Differentiable gated attention through the kernels: the forward
    launches B3 and saves (q, k, v, pos_bias, gate, key_mask, out, lse); the
    backward launches B4 and B5.  Counterpart of the JAX custom VJP
    `_gated_attention_train`.  On CPU tensors both directions take the
    kernels' plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, pos_bias, gate, key_mask, num_heads):
        out, lse = wavlm_gated_attention_fwd_lse(q, k, v, pos_bias, gate, key_mask,
                                                 num_heads)
        ctx.save_for_backward(q, k, v, pos_bias, gate, key_mask, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pos_bias, gate, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias, dgate = wavlm_gated_attention_bwd(
            q, k, v, pos_bias, gate, key_mask, out, lse, dout.contiguous(), ctx.num_heads)
        return dq, dk, dv, dbias, dgate, None, None


def wavlm_gated_attention_heads_packed_trainable(
    q, k, v, pos_bias, gate, key_mask=None, num_heads: int = 16,
) -> torch.Tensor:
    """Training dispatch on the tensors' device: CPU -> the plain version,
    which autograd differentiates; CUDA -> `GatedAttentionTrain` (kernels
    in both directions) or raise.  Exact-softmax gradients only: attention
    dropout is not applied here."""
    if q.device.type == "cpu":
        return wavlm_gated_attention_plain(q, k, v, pos_bias, gate, key_mask, num_heads)
    return GatedAttentionTrain.apply(q, k, v, pos_bias, gate, key_mask, num_heads)
