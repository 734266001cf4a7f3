# -*- coding: utf-8 -*-
"""The port's gated attention against the JAX package's.

On the CPU the dispatcher takes the plain version, held here against
`wavlm_gated_attention_xla` and against the Pallas flash kernel run in
interpret mode, in float32 at atol 1e-5 (both sides sum the same f32
products; the difference is summation order).  The CUDA kernel itself is
held against the plain version in `test_torch_gated_attention_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.ops.flash_attention import (
    wavlm_gated_attention_packed_flash,
    wavlm_gated_attention_pallas,
    wavlm_gated_attention_xla,
)
from fddm_asr_tpu_torch.ops import flash_attention as FA

ATOL = 1e-5


def _inputs(rng, B, L, H, dh, mask_kind):
    q, k, v = (rng.standard_normal((B, L, H, dh)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (B, H, L)).astype(np.float32)
    mask = None
    if mask_kind != "none":
        mask = np.ones((B, L), bool)
        mask[-1, L // 3:] = False  # ragged: a span across block boundaries
        if mask_kind == "all_masked_row":
            mask[0] = False
    return q, k, v, bias, gate, mask


def _torch_packed(q, k, v, bias, gate, mask):
    B, L, H, dh = q.shape
    t = torch.from_numpy
    return (t(q.reshape(B, L, H * dh)), t(k.reshape(B, L, H * dh)),
            t(v.reshape(B, L, H * dh)), t(bias), t(gate),
            None if mask is None else t(mask))


def _jax_ref(q, k, v, bias, gate, mask):
    B, L, H, dh = q.shape
    out = wavlm_gated_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.asarray(gate), None if mask is None else jnp.asarray(mask))
    return np.asarray(out).reshape(B, L, H * dh)


@pytest.mark.parametrize("B,L,H,dh", [(2, 9, 4, 8), (2, 384, 2, 64)], ids=["L9", "L384"])
@pytest.mark.parametrize("mask_kind", ["none", "ragged", "all_masked_row"])
def test_plain_matches_xla(rng, B, L, H, dh, mask_kind):
    args = _inputs(rng, B, L, H, dh, mask_kind)
    ref = _jax_ref(*args)
    out = FA.wavlm_gated_attention_heads_packed(*_torch_packed(*args), num_heads=H)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mask_kind", ["none", "ragged"])
def test_plain_matches_pallas_flash_interpret(rng, mask_kind):
    """L=384 with 128 blocks: three k-steps of the running softmax."""
    B, L, H, dh = 2, 384, 2, 64
    args = _inputs(rng, B, L, H, dh, mask_kind)
    tq, tk, tv, tb, tg, tm = _torch_packed(*args)
    ref = wavlm_gated_attention_packed_flash(
        jnp.asarray(tq.numpy()), jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy()),
        jnp.asarray(tb.numpy()), jnp.asarray(tg.numpy()),
        None if tm is None else jnp.asarray(tm.numpy()),
        num_heads=H, block_q=128, block_k=128, interpret=True)
    out = FA.wavlm_gated_attention_plain(tq, tk, tv, tb, tg, tm, num_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_all_masked_row_averages_the_real_keys(rng):
    """A row with every key masked is the mean of v over the L real keys
    (the XLA reference's result, which the CUDA kernel follows); the Pallas
    flash kernel averages over its block-padded key count instead."""
    B, L, H, dh = 1, 200, 2, 64  # 200 keys pad to 256 at block_k=128
    q, k, v, bias, gate, mask = _inputs(rng, B, L, H, dh, "all_masked_row")
    out = FA.wavlm_gated_attention_plain(*_torch_packed(q, k, v, bias, gate, mask),
                                         num_heads=H).numpy()
    real_mean = v.reshape(B, L, H * dh).mean(axis=1, keepdims=True)
    np.testing.assert_allclose(out, np.broadcast_to(real_mean, out.shape), atol=ATOL)
    flash = np.asarray(wavlm_gated_attention_packed_flash(
        jnp.asarray(q.reshape(B, L, H * dh)), jnp.asarray(k.reshape(B, L, H * dh)),
        jnp.asarray(v.reshape(B, L, H * dh)), jnp.asarray(bias), jnp.asarray(gate),
        jnp.asarray(mask), num_heads=H, block_q=128, block_k=128, interpret=True))
    np.testing.assert_allclose(flash, np.broadcast_to(real_mean * L / 256, out.shape),
                               atol=ATOL)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_rejects_them(rng):
    args = _torch_packed(*_inputs(rng, 2, 9, 2, 64, "ragged"))
    before = FA.wavlm_gated_attention_cuda.launches
    out = FA.wavlm_gated_attention_heads_packed(*args, num_heads=2)
    torch.testing.assert_close(out, FA.wavlm_gated_attention_plain(*args, num_heads=2),
                               rtol=0, atol=0)
    assert FA.wavlm_gated_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        FA.wavlm_gated_attention_cuda(*args, num_heads=2)


@pytest.mark.parametrize("mask_kind", ["none", "ragged", "all_masked_row"])
def test_bhld_entry_point_matches_xla(rng, mask_kind):
    """`wavlm_gated_attention` takes q/k/v [B, L, H, dh] as the JAX
    dispatcher does (whose TPU side is the per-head Pallas kernel); float32,
    atol 2e-5."""
    B, L, H, dh = 2, 150, 3, 64
    q, k, v, bias, gate, mask = _inputs(rng, B, L, H, dh, mask_kind)
    ref = np.asarray(wavlm_gated_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), jnp.asarray(gate),
        None if mask is None else jnp.asarray(mask)))
    t = torch.from_numpy
    before = FA.wavlm_gated_attention_bhld_cuda.launches
    out = FA.wavlm_gated_attention(t(q), t(k), t(v), t(bias), t(gate),
                                   None if mask is None else t(mask))
    assert FA.wavlm_gated_attention_bhld_cuda.launches == before
    assert out.shape == (B, L, H, dh)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    # the same function as the head-packed entry point, on the same memory
    packed = FA.wavlm_gated_attention_heads_packed(
        *_torch_packed(q, k, v, bias, gate, mask), num_heads=H)
    torch.testing.assert_close(out.reshape(B, L, H * dh), packed, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        FA.wavlm_gated_attention_bhld_cuda(t(q), t(k), t(v), t(bias), t(gate), None)


def test_bhld_entry_point_matches_the_per_head_pallas_kernel(rng, monkeypatch):
    """Against the Pallas body itself (`_kernel`, one head per program over
    a whole softmax row) in interpret mode, with a ragged mask."""
    from jax.experimental import pallas as pl

    B, L, H, dh = 1, 128, 2, 64
    q, k, v, bias, gate, mask = _inputs(rng, B, L, H, dh, "ragged")
    real_call = pl.pallas_call  # the wrapper has no interpret switch of its own
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: real_call(*a, **{**kw, "interpret": True}))
    ref = np.asarray(wavlm_gated_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.asarray(gate), jnp.asarray(mask), block_q=128))
    monkeypatch.undo()
    t = torch.from_numpy
    out = FA.wavlm_gated_attention(t(q), t(k), t(v), t(bias), t(gate), t(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
