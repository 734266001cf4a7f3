# -*- coding: utf-8 -*-
"""The fused conv+LayerNorm+GELU CUDA kernel against its plain version, on
the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine, where JAX is absent and the tests'
conftest.py (which imports JAX) has to be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_conv_frontend_cuda.py

Tolerances: float32 atol 2e-4 / rtol 1e-3 (the JAX package's own for its
kernel: both sum the same f32 products in another order; the kernel's
3xTF32 products keep f32 accuracy, tests/test_torch_tf32_conv.py); bfloat16 atol
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


def _edge_case(dev, B, T_out, cin, cout, k, s, gelu_tanh=True):
    """The bfloat16 kernel at one shape, called twice: bit-identical outputs
    (no atomics, a fixed order of sums), within TOL of the plain version."""
    args = _case(dev, B, (T_out - 1) * s + k, cin, cout, k, torch.bfloat16)
    with torch.no_grad():
        out = CF.conv_ln_gelu(*args, s, gelu_tanh=gelu_tanh)
        again = CF.conv_ln_gelu(*args, s, gelu_tanh=gelu_tanh)
    torch.cuda.synchronize()
    assert out.shape == (B, T_out, cout) and torch.equal(out, again)
    ref = CF.conv_ln_gelu_plain(*args, s, gelu_tanh=gelu_tanh)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("T_out", [127, 128, 129, 255, 257])
def test_bf16_row_tile_edges(cuda_device, T_out):
    """Around the 128-row tiles, which never cross a batch row (B = 3)."""
    _edge_case(cuda_device, 3, T_out, 512, 512, 3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [8, 248, 256, 264, 512])
def test_bf16_channel_halves(cuda_device, cout):
    """Each CTA of a cluster owns 256 channels: Cout <= 256 leaves the second
    with none, 248 and 264 end inside a 64-channel store chunk."""
    _edge_case(cuda_device, 3, 129, 128, cout, 3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [8, 200, 512])
def test_bf16_input_channel_chunks(cuda_device, cin):
    """The K loop's 64-channel chunks: Cin below one, ending inside one, whole."""
    _edge_case(cuda_device, 3, 129, cin, 512, 3, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s", [(1, 1), (2, 2), (3, 2), (5, 1), (4, 3), (1, 2), (2, 3)])
@pytest.mark.parametrize("gelu_tanh", [False, True], ids=["erf", "tanh"])
def test_bf16_kernel_widths_and_strides(cuda_device, k, s, gelu_tanh):
    """One tensor map a tap, rows s * Cin apart: taps overlap when k > s and
    skip rows when k < s, where a map's T_out rows of s * Cin pass a batch
    row's T * Cin (T = 257 and 386 here)."""
    _edge_case(cuda_device, 3, 129, 64, 512, k, s, gelu_tanh)


@pytest.mark.cuda
def test_bf16_layer_one_shape(cuda_device):
    """Layer 1 of the front-end at 8 x 20 s: x [8, 63999, 512], k = 3, s = 2."""
    _edge_case(cuda_device, 8, 31999, 512, 512, 3, 2)


def _f32_case(dev, B, T_out, cin, cout, k, s, gelu_tanh=False, seed=0):
    """The float32 kernel (3xTF32) at one shape, called twice: bit-identical
    outputs, within TOL of the plain version, one launch a call."""
    args = _case(dev, B, (T_out - 1) * s + k, cin, cout, k, torch.float32, seed=seed)
    before = CF.conv_ln_gelu_cuda.launches
    with torch.no_grad():
        out = CF.conv_ln_gelu(*args, s, gelu_tanh=gelu_tanh)
        again = CF.conv_ln_gelu(*args, s, gelu_tanh=gelu_tanh)
    torch.cuda.synchronize()
    assert CF.conv_ln_gelu_cuda.launches == before + 2
    assert out.shape == (B, T_out, cout) and torch.equal(out, again)
    ref = CF.conv_ln_gelu_plain(*args, s, gelu_tanh=gelu_tanh)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_out,cin,cout,k,s", [
    (3, 127, 512, 512, 3, 2), (3, 128, 512, 512, 3, 2), (3, 129, 512, 512, 3, 2),
    (3, 257, 512, 512, 3, 2), (3, 129, 128, 8, 3, 2), (3, 129, 128, 248, 3, 2),
    (3, 129, 128, 256, 3, 2), (3, 129, 128, 264, 3, 2), (3, 129, 8, 512, 3, 2),
    (3, 129, 200, 512, 3, 2), (3, 129, 64, 512, 1, 1), (3, 129, 64, 512, 5, 1),
    (3, 129, 64, 512, 4, 3), (3, 129, 64, 512, 1, 2), (3, 129, 64, 512, 2, 3),
    (1, 1, 16, 8, 3, 2), (2, 40, 8, 24, CF.MAX_TAPS + 1, 1)],
    ids=["rows127", "rows128", "rows129", "rows257", "cout8", "cout248", "cout256",
         "cout264", "cin8", "cin200", "k1s1", "k5s1", "k4s3", "k1s2", "k2s3", "one-row",
         "k17"])
def test_f32_tile_edges(cuda_device, B, T_out, cin, cout, k, s):
    """Around the float32 kernel's 128-row tiles and 256-channel halves, K
    (= k * Cin) ending inside a 32-column stage (Cin = 8, 200; k = 17 at
    Cin = 8: K = 136), taps that overlap or skip rows in the patch view."""
    _f32_case(cuda_device, B, T_out, cin, cout, k, s)


@pytest.mark.cuda
@pytest.mark.parametrize("T,k", [(63999, 3), (1999, 2)], ids=["layer1", "layer6"])
@pytest.mark.parametrize("gelu_tanh", [False, True], ids=["erf", "tanh"])
def test_f32_layer_shapes(cuda_device, T, k, gelu_tanh):
    """Layers 1 and 6 of the front-end at 8 x 20 s in float32: x [8, T,
    512], s = 2; at layer 1, K = 1536 sums into one undrained accumulator."""
    _f32_case(cuda_device, 8, (T - k) // 2 + 1, 512, 512, k, 2, gelu_tanh)


@pytest.mark.cuda
def test_f32_fused_layer_keeps_its_split_weight(cuda_device):
    """The fused layer in float32 on the card passes `kernel_weight_tf32`'s
    operand: made once, reused by the next call, remade after an in-place
    update; each output within TOL of the plain version on the layer's
    weight."""
    from fddm_asr_tpu_torch.models.wavlm import ConvLayer

    layer = ConvLayer(64, 96, 3, 2, True, "layer", 1e-5, False, fused=True).to(cuda_device)
    x = torch.randn(2, 301, 64, device=cuda_device)

    def check():
        out = layer(x, torch.float32, channels_last=True)
        ln = layer.layer_norm
        ref = CF.conv_ln_gelu_plain(x, layer.conv.weight.permute(2, 1, 0), layer.conv.bias,
                                    ln.weight, ln.bias, 2)
        torch.testing.assert_close(out, ref, **TOL[torch.float32])

    with torch.no_grad():
        check()
        kept = layer._kernel_weight["w_tf32"][1]
        check()
        assert layer._kernel_weight["w_tf32"][1] is kept
        layer.conv.weight.mul_(-0.5)
        check()
        assert layer._kernel_weight["w_tf32"][1] is not kept


@pytest.mark.cuda
def test_bf16_refuses_more_taps_than_maps(cuda_device):
    """The bf16 kernel holds one tensor map a tap, MAX_TAPS of them: a wider
    kernel raises before any launch; the f32 kernel takes it."""
    args = _case(cuda_device, 1, 40, 8, 8, CF.MAX_TAPS + 1, torch.bfloat16)
    before = CF.conv_ln_gelu_cuda.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match=f"kernel widths up to {CF.MAX_TAPS}"):
            CF.conv_ln_gelu(*args, 1)
        assert CF.conv_ln_gelu_cuda.launches == before
        f32 = [a.float() if a is not None else None for a in args]
        out = CF.conv_ln_gelu(*f32, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, CF.conv_ln_gelu_plain(*f32, 1), **TOL[torch.float32])
    _edge_case(cuda_device, 1, 24, 8, 8, CF.MAX_TAPS, 1)  # the widest it takes


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
