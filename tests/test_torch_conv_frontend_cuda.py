# -*- coding: utf-8 -*-
"""The fused conv+LayerNorm+GELU CUDA kernel against its plain version, on
the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine, where JAX is absent and the tests'
conftest.py (which imports JAX) has to be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_conv_frontend_cuda.py

Tolerances: float32 atol 2e-4 / rtol 1e-3 (the JAX package's own for its
kernel: both sum the same f32 products in another order); bfloat16 atol
3e-2 plus one bf16 ulp of the value (rtol 2^-7): the outputs reach past 4,
where an ulp is 0.03125."""
import pytest
import torch

from fddm_asr_tpu_torch.ops import conv_frontend as CF

TOL = {torch.float32: dict(atol=2e-4, rtol=1e-3), torch.bfloat16: dict(atol=3e-2, rtol=2.0 ** -7)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, T, cin, cout, k, dtype, with_bias=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, cin, device=dev, generator=g).to(dtype)
    w = torch.randn(k, cin, cout, device=dev, generator=g) * 0.1
    b = torch.randn(cout, device=dev, generator=g) * 0.1 if with_bias else None
    scale = torch.rand(cout, device=dev, generator=g) + 0.5
    bias = torch.randn(cout, device=dev, generator=g) * 0.1
    return x, w, b, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,cin,cout,k,s", [
    (2, 1027, 512, 512, 3, 2), (2, 1026, 512, 512, 2, 2), (3, 203, 32, 64, 3, 2),
    (2, 131, 128, 128, 2, 2), (1, 3, 16, 8, 3, 2), (2, 70, 8, 24, 5, 1)],
    ids=["k3s2-512", "k2s2-512", "narrow", "c128", "one-row", "k5s1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("gelu_tanh", [False, True], ids=["erf", "tanh"])
def test_kernel_matches_plain_on_card(cuda_device, B, T, cin, cout, k, s, dtype, gelu_tanh):
    args = _case(cuda_device, B, T, cin, cout, k, dtype)
    before = CF.conv_ln_gelu_cuda.launches
    with torch.no_grad():
        out = CF.conv_ln_gelu(*args, s, gelu_tanh=gelu_tanh)
    torch.cuda.synchronize()
    assert CF.conv_ln_gelu_cuda.launches == before + 1
    ref = CF.conv_ln_gelu_plain(*args, s, gelu_tanh=gelu_tanh)
    assert out.shape == ref.shape == (B, (T - k) // s + 1, cout) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


@pytest.mark.cuda
def test_no_bias_and_the_unfused_layer(cuda_device):
    """Without a conv bias; and against F.conv1d + layer_norm + gelu in f32,
    where fused and unfused agree to summation order."""
    F = torch.nn.functional
    x, w, _, scale, bias = _case(cuda_device, 2, 301, 64, 96, 3, torch.float32, with_bias=False)
    with torch.no_grad():
        out = CF.conv_ln_gelu(x, w, None, scale, bias, 2)
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), None, stride=2).transpose(1, 2)
    ref = F.gelu(F.layer_norm(y, (96,), scale, bias, 1e-5))
    torch.testing.assert_close(out, ref, **TOL[torch.float32])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    """Cin = 1 (the waveform layer), Cout past 512 and autograd raise before
    any launch; an input shorter than the kernel returns an empty tensor
    without one.  Nothing falls back to the plain version on the card."""
    before = CF.conv_ln_gelu_cuda.launches
    ones, zeros = torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device)
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiples of 8"):
            CF.conv_ln_gelu(torch.zeros(1, 50, 1, device=cuda_device),
                            torch.zeros(10, 1, 8, device=cuda_device), None, ones, zeros, 5)
        with pytest.raises(ValueError, match="Cout <= 512"):
            CF.conv_ln_gelu(torch.zeros(1, 50, 8, device=cuda_device),
                            torch.zeros(2, 8, 520, device=cuda_device), None,
                            torch.ones(520, device=cuda_device),
                            torch.zeros(520, device=cuda_device), 2)
        empty = CF.conv_ln_gelu(torch.zeros(2, 2, 8, device=cuda_device),
                                torch.zeros(3, 8, 8, device=cuda_device), None, ones, zeros, 2)
    assert empty.shape == (2, 0, 8)
    with pytest.raises(RuntimeError, match="forward only"):
        CF.conv_ln_gelu(torch.zeros(1, 50, 8, device=cuda_device),
                        torch.zeros(2, 8, 8, device=cuda_device), None, ones, zeros, 2)
    assert CF.conv_ln_gelu_cuda.launches == before
