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
