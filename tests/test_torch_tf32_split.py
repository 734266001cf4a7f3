# -*- coding: utf-8 -*-
"""The float32 forward kernel's arithmetic, emulated on the CPU.

`csrc/gated_attention.cu` runs float32 attention as 3xTF32 on the tensor
cores: each f32 operand x is split into tf32 hi = rna(x) (the 13 low
mantissa bits rounded off, ties away from zero, as cvt.rna) and lo =
rna(x - hi), and each product is hi.hi + hi.lo + lo.hi with f32 sums; the
row max, the exponentials and the sums are f32.  Here that arithmetic, in
torch on the CPU, is held against the JAX package's
`wavlm_gated_attention_xla` in float32 on the same numpy inputs, within
the kernel's 1e-4; the error of plain 1xTF32 (hi.hi alone) is printed
beside it, to show what the two cross terms buy.
"""
import jax.numpy as jnp
import numpy as np
import torch

from fddm_asr_tpu.ops.flash_attention import wavlm_gated_attention_xla

TOL = 1e-4
NEG = torch.finfo(torch.float32).min


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), ties away from zero: the
    kernel's (bits + 0x1000) & 0xffffe000 on the f32 bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b with tf32 operands: 3 terms (hi.hi + hi.lo + lo.hi) or 1."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def emulated(q, k, v, bias, gate, mask, terms: int) -> torch.Tensor:
    """The kernel's forward on [B, L, H, dh] float32 operands: log2-domain
    scores, masked keys f32-min, P = 2^(s - max) rounded to tf32 hi and lo,
    the sum over keys then 1/l."""
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))  # [B, H, L, dh]
    log2e = 1.4426950408889634
    s = product(qh, kh.transpose(-1, -2), terms) * (0.125 * log2e)
    s = s + (gate[..., None] * log2e) * bias[None]
    s = s.masked_fill(~mask[:, None, None, :], NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    out = product(p, vh, terms) / p.sum(-1, keepdim=True)
    return out.permute(0, 2, 1, 3)


def test_tf32x3_matches_xla_float32():
    rng = np.random.default_rng(0)
    B, H, L, dh = 2, 2, 1024, 64
    q, k, v = (rng.standard_normal((B, L, H, dh)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (B, H, L)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[0, 700:] = False          # ragged, inside a 64-key step
    mask[1] = False                # an all-masked row: the mean of v
    ref = np.asarray(wavlm_gated_attention_xla(*(jnp.asarray(x) for x in (
        q, k, v, bias, gate, mask))))
    args = [torch.from_numpy(x) for x in (q, k, v, bias, gate, mask)]
    err3 = np.abs(emulated(*args, terms=3).numpy() - ref).max()
    err1 = np.abs(emulated(*args, terms=1).numpy() - ref).max()
    print(f"max abs error against XLA float32: 3xTF32 {err3:.3g}, 1xTF32 {err1:.3g}")
    assert np.isfinite(err3) and err3 <= TOL
    # the cross terms are what keep float32 accuracy: 1xTF32 alone misses it
    assert err1 > TOL


def test_tf32_rna_rounds_ties_away():
    """rna: the 13 low bits rounded to nearest, ties away from zero."""
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10  # a tf32 ulp at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 3.0],
                     dtype=torch.float32)
    assert tf32_rna(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 3.0]
    hi, lo = split(one / 3)
    assert float(hi + lo) != float(hi) and abs(float(hi + lo) - 1 / 3) < 2 ** -20
