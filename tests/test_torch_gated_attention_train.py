# -*- coding: utf-8 -*-
"""The trainable gated attention's plain versions against the JAX package's.

* `wavlm_gated_attention_fwd_lse_plain` and `wavlm_gated_attention_bwd_plain`
  (the formulas of the B3/B4/B5 kernels) against the JAX package's Pallas
  training kernels `_train_forward` / `_train_backward` run in interpret
  mode, at L=256 (block_q = block_k = 128, a ragged mask) and at L=384 with
  block_k=256 (the tail-block case), as tests/test_flash_attention.py runs
  them; float32, atol 1e-5 on out and lse, 1e-4 of the reference's largest
  magnitude on the gradients.
* The CPU training dispatcher (the plain forward, differentiated by
  autograd) against jax.grad of `wavlm_gated_attention_xla`, same tolerance.
* The autograd Function the card uses, run on CPU tensors (where it takes
  the kernels' plain versions), against autograd of the plain forward,
  including a row whose keys are all masked: the exact gradient of the
  port's forward (the TPU kernels differ there).
* The arithmetic of the bf16 B4 and B5 kernels (log2-domain P, their
  masking and loop orders), emulated in float32, against the plain backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.ops.flash_attention import (
    _train_backward,
    _train_forward,
    wavlm_gated_attention_xla,
)
from fddm_asr_tpu_torch.ops import flash_attention as FA

H, DH, B = 2, 64, 2
GRAD_NAMES = ("dq", "dk", "dv", "dbias", "dgate")


def _inputs(rng, L, all_masked_row=False):
    q, k, v = (rng.standard_normal((B, L, H * DH)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (B, H, L)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, L // 3:] = False  # ragged: a span across block boundaries
    if all_masked_row:
        mask[0] = False
    dout = rng.standard_normal((B, L, H * DH)).astype(np.float32)
    return q, k, v, bias, gate, mask, dout


def _assert_grads(got, want):
    for name, a, b in zip(GRAD_NAMES, got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32).reshape(np.shape(a))
        scale = max(float(np.abs(b).max()), 1e-9)
        np.testing.assert_allclose(a, b, atol=1e-4 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("L,block_q,block_k", [(256, 128, 128), (384, 128, 256)],
                         ids=["L256", "L384-bk256"])
def test_plain_fwd_lse_and_bwd_match_pallas_interpret(rng, L, block_q, block_k):
    q, k, v, bias, gate, mask, dout = _inputs(rng, L)
    jargs = [jnp.asarray(x) for x in (q, k, v, bias, gate, mask)]
    out_j, out_p, lse_p = _train_forward(*jargs, num_heads=H, block_q=block_q, interpret=True)
    dj = _train_backward(*jargs, out_p, lse_p, jnp.asarray(dout), num_heads=H,
                         block_q=block_q, block_k=block_k, interpret=True)
    lse_j = np.asarray(jnp.transpose(lse_p, (0, 1, 3, 2))).reshape(B, H, -1)[:, :, :L]

    t = [torch.from_numpy(x) for x in (q, k, v, bias, gate, mask)]
    out, lse = FA.wavlm_gated_attention_fwd_lse_plain(*t, num_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=0)
    got = FA.wavlm_gated_attention_bwd_plain(*t, out, lse, torch.from_numpy(dout), num_heads=H)
    _assert_grads([g.numpy() for g in got], dj)


def _jax_xla_grads(q, k, v, bias, gate, mask, dout):
    def loss(q, k, v, b, g):
        def split(x):
            return x.reshape(B, -1, H, DH)
        out = wavlm_gated_attention_xla(split(q), split(k), split(v), b, g, jnp.asarray(mask))
        return jnp.sum(out.reshape(dout.shape) * dout)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(x) for x in (q, k, v, bias, gate)))


def _torch_grads(fn, q, k, v, bias, gate, mask, dout):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias, gate)]
    out = fn(*leaves, torch.from_numpy(mask), num_heads=H)
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(dout))]


def test_cpu_dispatcher_grads_match_jax_xla(rng):
    args = _inputs(rng, 203)  # no multiple of 8 or of any block
    before = FA.wavlm_gated_attention_fwd_lse_cuda.launches
    got = _torch_grads(FA.wavlm_gated_attention_heads_packed_trainable, *args)
    assert FA.wavlm_gated_attention_fwd_lse_cuda.launches == before  # CPU: no kernel
    _assert_grads(got, _jax_xla_grads(*args))


def test_autograd_function_is_the_exact_gradient_of_the_plain_forward(rng):
    """GatedAttentionTrain on CPU tensors (fwd_lse + bwd plain versions) vs
    autograd of the plain forward, with an all-masked row: there the forward
    is the mean of v over the L real keys, so dv = sum(dO) / L and no
    gradient reaches q, k, the bias or the gate."""
    L = 70
    args = _inputs(rng, L, all_masked_row=True)
    got = _torch_grads(FA.GatedAttentionTrain.apply, *args)
    want = _torch_grads(FA.wavlm_gated_attention_plain, *args)
    _assert_grads(got, want)
    dq, dk, dv, _, dgate = got
    assert not dq[0].any() and not dk[0].any() and not dgate[0].any()
    dout = args[-1]
    np.testing.assert_allclose(dv[0], np.broadcast_to(dout[0].sum(0) / L, dv[0].shape),
                               atol=1e-5)


def test_all_masked_row_differs_from_the_tpu_kernels(rng):
    """Where the port deliberately differs: at an all-masked row the TPU
    backward kernels take P = exp(S - lse) = 1 for every key (lse rounds to
    f32-min) and keep dS, so their dv there is sum(dO), L times the exact
    sum(dO) / L the port gives, and their dq is not zero."""
    L = 128
    q, k, v, bias, gate, mask, dout = _inputs(rng, L, all_masked_row=True)
    jargs = [jnp.asarray(x) for x in (q, k, v, bias, gate, mask)]
    _, out_p, lse_p = _train_forward(*jargs, num_heads=H, block_q=128, interpret=True)
    jdq, _, jdv, _, _ = _train_backward(*jargs, out_p, lse_p, jnp.asarray(dout), num_heads=H,
                                        block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(np.asarray(jdv)[0],
                               np.broadcast_to(dout[0].sum(0), (L, H * DH)), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(np.asarray(jdq)[0]).max() > 1e-3
    dq, _, dv, _, _ = _torch_grads(FA.GatedAttentionTrain.apply, q, k, v, bias, gate, mask,
                                   dout)
    np.testing.assert_allclose(dv[0], np.broadcast_to(dout[0].sum(0) / L, dv[0].shape),
                               atol=1e-5)
    assert not dq[0].any()


def test_lse_of_an_all_masked_row_is_f32_min(rng):
    """The convention the backward kernels rely on to give P = 1/L there."""
    q, k, v, bias, gate, mask, _ = _inputs(rng, 40, all_masked_row=True)
    _, lse = FA.wavlm_gated_attention_fwd_lse_plain(
        *(torch.from_numpy(x) for x in (q, k, v, bias, gate, mask)), num_heads=H)
    assert (lse[0] == torch.finfo(torch.float32).min).all()
    assert torch.isfinite(lse[1]).all() and (lse[1] > -1e30).all()


def test_cpu_tensors_never_reach_the_training_kernels(rng):
    q, k, v, bias, gate, mask, dout = (torch.from_numpy(x) for x in _inputs(rng, 16))
    lse = torch.zeros(B, H, 16)
    for fn, args in ((FA.wavlm_gated_attention_fwd_lse_cuda, (q, k, v, bias, gate, mask)),
                     (FA.wavlm_gated_attention_bwd_dq_cuda,
                      (q, k, v, bias, gate, mask, lse, lse, dout)),
                     (FA.wavlm_gated_attention_bwd_dkv_cuda,
                      (q, k, v, bias, gate, mask, lse, lse, dout))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, num_heads=H)


def _b5_arithmetic(q, k, v, bias, gate, mask, lse, delta, dout, num_heads):
    """dk, dv, dbias as B5's bf16 kernels compute them, emulated in float32:
    P = 2^(S scale log2e + gate log2e bias - lse log2e); (a) gives masked keys
    P = 1/L at a row whose keys are all masked (lse = f32-min) and 0
    elsewhere, and dS = 0; (b) sums P (dP gate - delta gate) at kept keys
    over the batch rows in order."""
    B, L, _ = q.shape
    log2e = torch.tensor(np.log2(np.e), dtype=torch.float32)
    scale = 0.125
    qh, kh, vh, dh = (FA._heads(x, num_heads) for x in (q, k, v, dout))
    s = torch.matmul(qh, kh.transpose(-1, -2))
    dp = torch.matmul(dh, vh.transpose(-1, -2))
    g, ls, de = gate[..., None], lse[..., None], delta[..., None]
    p = torch.exp2(s * (scale * log2e) + ((g * log2e) * bias[None] - ls * log2e))
    keep = mask[:, None, None, :]
    p_a = torch.where(keep, p, torch.where(ls == torch.finfo(torch.float32).min, 1.0 / L, 0.0))
    ds = torch.where(keep, p * (dp - de), 0.0)
    dv = torch.matmul(p_a.transpose(-1, -2), dh)
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dbias = torch.zeros(num_heads, L, L)
    for b in range(B):
        dbias += torch.where(keep[b], p[b] * (dp[b] * g[b] - de[b] * g[b]), 0.0)
    return FA._packed(dk), FA._packed(dv), dbias


def test_b5_arithmetic_matches_the_plain_backward(rng):
    """B5's bf16 kernels (dk/dv by key blocks, dbias by a batch loop) use
    another arithmetic than the plain backward; emulated on the CPU where
    they cannot run, in float32 at L = 203 with a ragged row, a full row and
    an all-masked row: within 1e-5 of each reference's largest magnitude."""
    L = 203
    q, k, v = (rng.standard_normal((3, L, H * DH)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (3, H, L)).astype(np.float32)
    dout = rng.standard_normal((3, L, H * DH)).astype(np.float32)
    mask = np.ones((3, L), bool)
    mask[0, 150:] = False
    mask[2] = False
    q, k, v, bias, gate, mask, dout = map(torch.from_numpy, (q, k, v, bias, gate, mask, dout))
    out, lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, H)
    delta = (dout * out).reshape(3, L, H, DH).sum(-1).transpose(1, 2)
    want = FA.wavlm_gated_attention_bwd_plain(q, k, v, bias, gate, mask, out, lse, dout, H)
    got = _b5_arithmetic(q, k, v, bias, gate, mask, lse, delta, dout, H)
    for name, a, b in zip(("dk", "dv", "dbias"), got, (want[1], want[2], want[3])):
        assert torch.isfinite(a).all(), name
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-5 * scale, name
    assert got[1][2].abs().max() > 0  # the all-masked row's dv: 1/L of sum(dO)


def _b4_arithmetic(q, k, v, bias, gate, mask, lse, delta, dout, num_heads, skip=True,
                   select=True):
    """dq, dgate as B4's bf16 kernel computes them, emulated in float32, and
    the number of (batch row, key tile) pairs it visits.  Per 64-key tile:
    P = 2^(S scale log2e + (gate log2e bias + (-lse log2e))), P = 0 at masked
    keys and keys past L (by a select, or with `select` False by a multiply
    by the keep flag), dS = P (dP - delta), dgate += dS bias, dQ += dS K;
    with `skip`, a tile with no kept key of its batch row is not visited."""
    B, L, _ = q.shape
    log2e = torch.tensor(np.log2(np.e), dtype=torch.float32)
    scale = 0.125
    qh, kh, vh, dh = (FA._heads(x, num_heads) for x in (q, k, v, dout))
    gl, nll, de = gate[..., None] * log2e, -lse[..., None] * log2e, delta[..., None]
    dq = torch.zeros_like(qh)
    dgate = torch.zeros(B, num_heads, L)
    visited = 0
    for b in range(B):
        for k0 in range(0, L, 64):
            cols = slice(k0, min(k0 + 64, L))
            keep = mask[b, cols]
            if skip and not keep.any():
                continue
            visited += 1
            s = torch.matmul(qh[b], kh[b, :, cols].transpose(-1, -2))
            dp = torch.matmul(dh[b], vh[b, :, cols].transpose(-1, -2))
            p = torch.exp2(s * (scale * log2e) + (gl[b] * bias[:, :, cols] + nll[b]))
            p = torch.where(keep, p, 0.0) if select else p * keep
            ds = p * (dp - de[b])
            dgate[b] += (ds * bias[:, :, cols]).sum(-1)
            dq[b] += torch.matmul(ds, kh[b, :, cols])
    return FA._packed(dq * scale), dgate, visited


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
def test_b4_arithmetic_matches_the_plain_backward(rng, skip):
    """B4's bf16 kernel (log2-domain P with the constants folded, a select
    at masked keys, key tiles without a kept key skipped) uses another
    arithmetic than the plain backward; emulated on the CPU where it cannot
    run, in float32 at L = 203 with a ragged row, a full row and an
    all-masked row: within 1e-5 of each reference's largest magnitude, with
    and without the skip (which is exact).  The all-masked row's lse is
    f32-min, so its P overflows to inf: a select gives dS = 0 there, a
    multiply by the keep flag NaN."""
    L = 203
    q, k, v = (rng.standard_normal((3, L, H * DH)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (3, H, L)).astype(np.float32)
    dout = rng.standard_normal((3, L, H * DH)).astype(np.float32)
    mask = np.ones((3, L), bool)
    mask[0, 150:] = False  # tile 2 (keys 128..191) partly kept, tile 3 (192..202) not at all
    mask[2] = False
    q, k, v, bias, gate, mask, dout = map(torch.from_numpy, (q, k, v, bias, gate, mask, dout))
    out, lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, H)
    delta = (dout * out).reshape(3, L, H, DH).sum(-1).transpose(1, 2)
    want = FA.wavlm_gated_attention_bwd_plain(q, k, v, bias, gate, mask, out, lse, dout, H)
    dq, dgate, visited = _b4_arithmetic(q, k, v, bias, gate, mask, lse, delta, dout, H,
                                        skip=skip)
    assert visited == (3 + 4 if skip else 3 * 4)
    for name, a, b in (("dq", dq, want[0]), ("dgate", dgate, want[4])):
        assert torch.isfinite(a).all(), name
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-5 * scale, name
    assert not dq[2].any() and not dgate[2].any()  # the all-masked row: exactly 0
    if not skip:
        dq_mul, _, _ = _b4_arithmetic(q, k, v, bias, gate, mask, lse, delta, dout, H,
                                      skip=False, select=False)
        assert torch.isnan(dq_mul[2]).all() and torch.isfinite(dq_mul[:2]).all()
