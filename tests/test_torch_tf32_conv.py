# -*- coding: utf-8 -*-
"""The float32 fused conv kernel's arithmetic, emulated on the CPU.

`csrc/conv_ln_gelu.cu` runs the float32 conv product as 3xTF32 on the
tensor cores: the weight is laid out K-major and split once
(`ops/conv_frontend.tf32_split_weight`: tf32 hi = rna(w), lo = rna(w - hi),
as cvt.rna), the patches are split in the consumers' registers the same
way, and each 8-column slice of K (= j * Cin + ci), in order, adds lo.hi,
then hi.lo, then hi.hi into one f32 accumulator that is never drained;
then the conv bias, a two-pass f32 LayerNorm and GELU.  Here that
arithmetic, in torch on the CPU, is held against the JAX package's
`conv_ln_gelu_xla` in float32 on the same numpy inputs, within the
kernel's atol 2e-4 / rtol 1e-3; the error of plain 1xTF32 (hi.hi alone) is
printed beside it, to show what the two cross terms buy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fddm_asr_tpu.ops.conv_frontend import conv_ln_gelu_xla
from fddm_asr_tpu_torch.ops import conv_frontend as CF

ATOL, RTOL = 2e-4, 1e-3
K_SLICE = 8  # the K columns of one tf32 wgmma (m64n256k8)


def emulated(x, w, b, ln_scale, ln_bias, stride, gelu_tanh, terms):
    """The kernel on x [B, T, Cin], w [k, Cin, Cout]: 3 terms (lo.hi + hi.lo
    + hi.hi a slice) or 1 (hi.hi)."""
    B, T, cin = x.shape
    k, _, cout = w.shape
    T_out = (T - k) // stride + 1
    patches = x.unfold(1, k, stride).permute(0, 1, 3, 2).reshape(B * T_out, k * cin)
    a_hi = CF.tf32_rna(patches)
    a_lo = CF.tf32_rna(patches - a_hi)
    w_hi, w_lo = (m.T for m in CF.tf32_split_weight(w))  # [K, Cout] each
    acc = torch.zeros(B * T_out, cout)
    for c in range(0, k * cin, K_SLICE):
        sl = slice(c, c + K_SLICE)
        if terms == 3:
            acc = acc + a_lo[:, sl] @ w_hi[sl]
            acc = acc + a_hi[:, sl] @ w_lo[sl]
        acc = acc + a_hi[:, sl] @ w_hi[sl]
    y = acc + b
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + 1e-5) * ln_scale + ln_bias
    out = F.gelu(y, approximate="tanh" if gelu_tanh else "none")
    return out.reshape(B, T_out, cout)


@pytest.mark.parametrize("T,k,s,gelu_tanh", [(401, 3, 2, False), (400, 2, 2, True)],
                         ids=["k3s2-erf", "k2s2-tanh"])
def test_tf32x3_conv_matches_xla_float32(T, k, s, gelu_tanh):
    rng = np.random.default_rng(k)
    B, C = 2, 512
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.uniform(-1.0, 1.0, (k, C, C)) / np.sqrt(k * C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = np.asarray(conv_ln_gelu_xla(*(jnp.asarray(a) for a in (x, w, b, scale, bias)), s,
                                      gelu_tanh=gelu_tanh))
    args = [torch.from_numpy(a) for a in (x, w, b, scale, bias)]
    out3 = emulated(*args, s, gelu_tanh, terms=3).numpy()
    out1 = emulated(*args, s, gelu_tanh, terms=1).numpy()
    assert out3.shape == ref.shape == (B, (T - k) // s + 1, C)
    err3, err1 = np.abs(out3 - ref), np.abs(out1 - ref)
    print(f"max abs error against XLA float32: 3xTF32 {err3.max():.3g}, "
          f"1xTF32 {err1.max():.3g}")
    np.testing.assert_allclose(out3, ref, atol=ATOL, rtol=RTOL)
    # the cross terms are what keep float32 accuracy: 1xTF32 is ten times further off
    assert err1.max() > 10 * err3.max()


def test_split_weight_layout():
    """Row n of each half holds channel n's K = k * Cin weights in the
    patches' order (j * Cin + ci); hi is tf32 (13 low bits clear) and hi +
    lo is the weight to within 2^-22 of it."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 16, 24)).astype(np.float32))
    ws = CF.tf32_split_weight(w)
    assert ws.shape == (2, 24, 48) and ws.dtype == torch.float32 and ws.is_contiguous()
    hi, lo = ws
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    whole = (hi.double() + lo.double()).reshape(24, 3, 16).permute(1, 2, 0)
    assert (whole - w.double()).abs().le(w.double().abs() * 2.0 ** -22).all()
    assert torch.equal(hi[5, 2 * 16 + 7], CF.tf32_rna(w[2, 7, 5:6])[0])
