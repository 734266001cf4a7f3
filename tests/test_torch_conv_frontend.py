# -*- coding: utf-8 -*-
"""The port's fused conv+LayerNorm+GELU against the JAX package's.

The same numpy inputs go through `fddm_asr_tpu/ops/conv_frontend.py` (the
Pallas kernel in interpret mode, as the JAX package's own test runs it, and
its XLA reference) and the port's `conv_ln_gelu`, which on the CPU takes
the kernel's plain version.  Float32, atol 2e-4 / rtol 1e-3: the JAX test's
own tolerance (the kernel's erf is a polynomial with |err| < 1.5e-7 and the
products are summed in another order).  The CUDA kernel itself is held
against the plain version in `test_torch_conv_frontend_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fddm_asr_tpu.ops import conv_frontend as JC
from fddm_asr_tpu_torch.ops import conv_frontend as CF

TOL = dict(atol=2e-4, rtol=1e-3)


def _inputs(rng, k, cin, cout, T, B=2):
    return (rng.standard_normal((B, T, cin)).astype(np.float32),
            (rng.standard_normal((k, cin, cout)) * 0.1).astype(np.float32),
            (rng.standard_normal((cout,)) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, (cout,)).astype(np.float32),
            (rng.standard_normal((cout,)) * 0.1).astype(np.float32))


def _port(args, stride, **kw):
    with torch.no_grad():
        return CF.conv_ln_gelu(*(torch.from_numpy(a) for a in args), stride, **kw).numpy()


@pytest.mark.parametrize("k,s,cin,cout,T", [
    (10, 5, 1, 64, 5120),   # waveform layer (the TPU dispatcher reframes it)
    (3, 2, 32, 64, 1027),   # mid layers
    (2, 2, 32, 64, 1026),   # tail layers
], ids=["waveform", "k3s2", "k2s2"])
@pytest.mark.parametrize("gelu_tanh", [False, True], ids=["erf", "tanh"])
def test_plain_matches_pallas_interpret_and_xla(rng, k, s, cin, cout, T, gelu_tanh):
    args = _inputs(rng, k, cin, cout, T)
    jargs = [jnp.asarray(a) for a in args]
    ref_xla = np.asarray(JC.conv_ln_gelu_xla(*jargs, s, gelu_tanh=gelu_tanh))
    ref_pallas = np.asarray(JC.conv_ln_gelu(*jargs, s, interpret=True, gelu_tanh=gelu_tanh))
    before = CF.conv_ln_gelu_cuda.launches
    out = _port(args, s, gelu_tanh=gelu_tanh)
    assert CF.conv_ln_gelu_cuda.launches == before  # a CPU tensor takes the plain version
    assert out.shape == ref_xla.shape == (2, (T - k) // s + 1, cout)
    np.testing.assert_allclose(out, ref_xla, **TOL)
    np.testing.assert_allclose(out, ref_pallas, **TOL)


def test_tanh_and_erf_differ_and_no_conv_bias(rng):
    args = _inputs(rng, 3, 32, 64, 515)
    erf, tanh = _port(args, 2), _port(args, 2, gelu_tanh=True)
    assert np.abs(erf - tanh).max() > 1e-6  # distinct functions, so the flag is honoured
    no_bias = (args[0], args[1], None, args[3], args[4])
    ref = np.asarray(JC.conv_ln_gelu_xla(
        *(None if a is None else jnp.asarray(a) for a in no_bias), 2))
    with torch.no_grad():
        out = CF.conv_ln_gelu(*(None if a is None else torch.from_numpy(a) for a in no_bias), 2)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_matches_the_unfused_torch_layer(rng):
    """In float32 the fused arithmetic is F.conv1d + layer_norm + gelu to
    summation order: the layer `models/wavlm.py` runs without the flag."""
    x, w, b, scale, bias = (torch.from_numpy(a) for a in _inputs(rng, 3, 16, 32, 500))
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=2).transpose(1, 2)
    ref = F.gelu(F.layer_norm(y, (32,), scale, bias, 1e-5))
    with torch.no_grad():
        out = CF.conv_ln_gelu(x, w, b, scale, bias, 2)
    torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.parametrize("T,T_out", [(2, 0), (3, 1), (4, 1), (5, 2)])
def test_short_inputs(rng, T, T_out):
    """An input shorter than the kernel width gives no row (the package's
    MIN_SAMPLES guard exists for that); T = k gives one."""
    args = _inputs(rng, 3, 8, 16, T)
    out = _port(args, 2)
    assert out.shape == (2, T_out, 16)
    if T_out:
        ref = np.asarray(JC.conv_ln_gelu_xla(*(jnp.asarray(a) for a in args), 2))
        np.testing.assert_allclose(out, ref, **TOL)


def test_bfloat16_rounds_once_at_the_end(rng):
    """bf16 operands, f32 arithmetic, one cast: the f32 plain version on the
    bf16-rounded operands, rounded to bf16, is the bf16 result exactly."""
    args = [torch.from_numpy(a) for a in _inputs(rng, 3, 16, 32, 301)]
    x16 = args[0].bfloat16()
    with torch.no_grad():
        out = CF.conv_ln_gelu(x16, *args[1:], 2)
        ref = CF.conv_ln_gelu(x16.float(), args[1].bfloat16().float(), *args[2:], 2)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.bfloat16(), rtol=0, atol=0)


def test_forward_only_and_cuda_wrapper_refuses_cpu_tensors(rng):
    args = [torch.from_numpy(a) for a in _inputs(rng, 3, 8, 16, 50)]
    with pytest.raises(RuntimeError, match="forward only"):
        CF.conv_ln_gelu(*args, 2)
    with pytest.raises(ValueError, match="CUDA"):
        CF.conv_ln_gelu_cuda(*args, 2)
    assert CF.kernel_takes(512, 512) and not CF.kernel_takes(1, 512)
    assert not CF.kernel_takes(512, 520)


def _taps_as_strided_rows(rng, B, T, cin, k, s, cout=24):
    """The conv as the CUDA kernel reads it: tap j's rows as the view of x
    [B, T, Cin] at element offset j * Cin with rows s * Cin and batch rows
    T * Cin apart (its tensor map's geometry).  Each view is unfold's tap j
    and ends inside x; the port's CPU route equals the sum over taps of
    view_j @ w[j] with the LayerNorm and GELU in float64."""
    T_out = (T - k) // s + 1
    x = torch.from_numpy(rng.standard_normal((B, T, cin), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((k, cin, cout)) * 0.1).astype(np.float32))
    b, ln_scale, ln_bias = (torch.from_numpy(a) for a in _inputs(rng, 1, 8, cout, 1)[2:])
    patches = x.unfold(1, k, s)  # [B, T_out, Cin, k]
    y = b.double()
    for j in range(k):
        assert j * cin + (B - 1) * T * cin + (T_out - 1) * s * cin + cin <= x.numel()
        view = torch.as_strided(x, (B, T_out, cin), (T * cin, s * cin, 1), j * cin)
        assert torch.equal(view, patches[..., j])
        y = y + view.double() @ w[j].double()
    y = F.layer_norm(y, (cout,), eps=1e-5) * ln_scale.double() + ln_bias.double()
    with torch.no_grad():
        out = CF.conv_ln_gelu(x, w, b, ln_scale, ln_bias, s, gelu_tanh=True)
    assert out.shape == (B, T_out, cout)
    torch.testing.assert_close(out.double(), F.gelu(y, approximate="tanh"), **TOL)


@pytest.mark.parametrize("T_out", [127, 128, 129, 255, 257])
@pytest.mark.parametrize("k,s", [(1, 1), (2, 2), (3, 2), (5, 1), (4, 3), (1, 2), (2, 3)])
@pytest.mark.parametrize("cin", [8, 200, 512])
def test_tap_views_are_the_patches(rng, k, s, T_out, cin):
    """At the CUDA kernel's edges (B = 3), taps that overlap (k > s) and
    that skip rows (k < s, where T_out * s passes T)."""
    _taps_as_strided_rows(rng, 3, (T_out - 1) * s + k, cin, k, s)


@pytest.mark.parametrize("T,k,s", [(63999, 3, 2), (31999, 3, 2), (15999, 3, 2),
                                   (7999, 3, 2), (3999, 2, 2), (1999, 2, 2)])
def test_tap_views_at_the_front_end_layers(rng, T, k, s):
    """The six layers of an 8 x 20 s transcribe, one batch row (the batch
    stride is covered above), 512 input channels."""
    _taps_as_strided_rows(rng, 1, T, 512, k, s, cout=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weight_is_cast_once_per_weight(dtype):
    """The kernel's operand of a conv weight is made on the first call and
    reused until the weight changes in place."""
    conv = torch.nn.Conv1d(16, 24, 3)
    cache = {}
    w = CF.kernel_weight(cache, conv.weight, dtype)
    assert w.dtype == dtype and w.is_contiguous() and not w.requires_grad
    assert torch.equal(w, conv.weight.detach().permute(2, 1, 0).to(dtype))
    assert CF.kernel_weight(cache, conv.weight, dtype) is w
    with torch.no_grad():
        conv.weight.mul_(2)
    again = CF.kernel_weight(cache, conv.weight, dtype)
    assert again is not w
    assert torch.equal(again, conv.weight.detach().permute(2, 1, 0).to(dtype))


def test_kernel_weight_tf32_is_split_once_per_weight():
    """The float32 kernel's K-major tf32 hi/lo operand of a conv weight is
    made on the first call, reused while the weight is unchanged, and made
    again after an in-place update."""
    conv = torch.nn.Conv1d(16, 24, 3)
    cache = {}
    ws = CF.kernel_weight_tf32(cache, conv.weight)
    assert ws.shape == (2, 24, 48) and ws.is_contiguous() and not ws.requires_grad
    assert torch.equal(ws, CF.tf32_split_weight(conv.weight.detach().permute(2, 1, 0)))
    assert CF.kernel_weight_tf32(cache, conv.weight) is ws
    assert CF.kernel_weight(cache, conv.weight, torch.float32) is not ws  # a key of its own
    with torch.no_grad():
        conv.weight.mul_(2)
    again = CF.kernel_weight_tf32(cache, conv.weight)
    assert again is not ws and CF.kernel_weight_tf32(cache, conv.weight) is again
    assert torch.equal(again, CF.tf32_split_weight(conv.weight.detach().permute(2, 1, 0)))


def test_fused_layer_reuses_its_kernel_weight(rng):
    """The fused front-end layer passes its weight through `kernel_weight`:
    one copy in the run's dtype, reused by every call, and the same output
    as the plain version on the layer's own weight."""
    from fddm_asr_tpu_torch.models.wavlm import ConvLayer

    layer = ConvLayer(32, 64, 3, 2, True, "layer", 1e-5, True, fused=True)
    x = torch.from_numpy(rng.standard_normal((2, 101, 32), dtype=np.float32))
    with torch.no_grad():
        out = layer(x, torch.bfloat16, channels_last=True)
        kept = layer._kernel_weight["w"][1]
        again = layer(x, torch.bfloat16, channels_last=True)
        assert layer._kernel_weight["w"][1] is kept and kept.dtype == torch.bfloat16
        ln = layer.layer_norm
        ref = CF.conv_ln_gelu_plain(x.bfloat16(), layer.conv.weight.permute(2, 1, 0),
                                    layer.conv.bias, ln.weight, ln.bias, 2, gelu_tanh=True)
    assert torch.equal(out, again) and torch.equal(out, ref)
