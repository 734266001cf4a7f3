# -*- coding: utf-8 -*-
"""The fused int8 matmul CUDA kernel against its plain version, on the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine, where JAX is absent and the tests'
conftest.py (which imports JAX) has to be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_quant_cuda.py

The integers are exact in both, and the kernel's epilogue rounds each f32
step separately as the plain version does, so float32 outputs must be
identical and bfloat16 outputs within one bf16 ulp (they round the same f32
value; a difference would be a fault).

The kernel quantizes into a workspace and multiplies in 128-row x 256-column
tiles over 128-byte steps of din, with per-row-tile counters that one launch
leaves at 0 for the next, and keeps each weight's tensor maps: so the cases
below sit at those tiles' edges, at WavLM-large's shapes, and repeat calls
across shapes and weights."""
import pytest
import torch

from fddm_asr_tpu_torch.ops import quant as Q


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _case(dev, M, din, dout, in_dtype, with_bias, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(M, din, device=dev, generator=g) * 3.0).to(in_dtype)
    w = torch.randn(dout, din, device=dev, generator=g) * 0.05
    bias = torch.randn(dout, device=dev, generator=g) if with_bias else None
    return x, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("M,din,dout", [(51, 64, 136), (300, 1024, 1024), (130, 4096, 264),
                                        (64, 48, 7), (33, 1792, 256), (8, 1808, 512)],
                         ids=["ragged", "square", "long-k", "odd-dout", "k-1792-33-rows",
                              "k-tail-8-rows"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["to-f32", "to-bf16"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_kernel_matches_plain_on_card(cuda_device, M, din, dout, in_dtype, out_dtype, with_bias):
    x, w, bias = _case(cuda_device, M, din, dout, in_dtype, with_bias)
    before = Q.int8_matmul_fused_cuda.launches
    out = Q.int8_matmul_fused(x, w, bias, out_dtype)
    torch.cuda.synchronize()
    assert Q.int8_matmul_fused_cuda.launches == before + 1
    ref = Q.int8_matmul_fused_plain(x, w, bias, out_dtype)
    assert out.dtype == out_dtype and out.shape == (M, dout)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# WavLM-large's three denses (q/k/v/out, fc1, fc2) at 8 x 20 s and one 20 s
# utterance; rows and columns at the 128 x 256 output tile's edges; din at
# the kernel's limit
EDGE_SHAPES = [(8192, 1024, 1024), (8192, 1024, 4096), (8192, 4096, 1024),
               (1024, 1024, 1024), (1024, 1024, 4096), (1024, 4096, 1024),
               (127, 256, 512), (128, 256, 512), (129, 256, 512), (257, 256, 512),
               (300, 256, 255), (300, 256, 256), (300, 256, 264), (64, Q.MAX_FUSED_DIN, 256)]
EDGE_IDS = ["qkvo-8x20s", "fc1-8x20s", "fc2-8x20s", "qkvo-20s", "fc1-20s", "fc2-20s",
            "m127", "m128", "m129", "m257", "n255", "n256", "n264", "din-limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("M,din,dout", EDGE_SHAPES, ids=EDGE_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_kernel_matches_plain_at_path_and_tile_edges(cuda_device, M, din, dout, dtype,
                                                     with_bias):
    """Output type = input type, as WavLM calls it; bit for bit."""
    x, w, bias = _case(cuda_device, M, din, dout, dtype, with_bias, seed=M + din + dout)
    out = Q.int8_matmul_fused(x, w, bias, dtype)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, Q.int8_matmul_fused_plain(x, w, bias, dtype),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_two_calls_give_the_same_bits(cuda_device):
    x, w, bias = _case(cuda_device, 8192, 1024, 4096, torch.bfloat16, True)
    wq_sw = Q.quantized_weight({}, "w", w)
    first = Q.int8_matmul_fused(x, w, bias, torch.bfloat16, wq_sw=wq_sw)
    second = Q.int8_matmul_fused(x, w, bias, torch.bfloat16, wq_sw=wq_sw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_kept_weight_maps_follow_the_weight(cuda_device):
    """The weight's tensor maps are encoded once and kept by address and
    size: the same wq and sw with a bias, without one and with another, and
    a new weight of the same shape (the allocator may hand it the freed
    weight's address), each give the plain version's outputs."""
    x, w, bias = _case(cuda_device, 300, 1024, 1024, torch.bfloat16, True)
    wq_sw = Q.quantized_weight({}, "w", w)
    for b in (bias, None, bias * 2.0):
        out = Q.int8_matmul_fused(x, w, b, torch.bfloat16, wq_sw=wq_sw)
        torch.testing.assert_close(out, Q.int8_matmul_fused_plain(x, w, b, torch.bfloat16),
                                   rtol=0, atol=0)
    del wq_sw
    for seed in (1, 2):
        x, w, bias = _case(cuda_device, 300, 1024, 1024, torch.bfloat16, True, seed=seed)
        out = Q.int8_matmul_fused(x, w, bias, torch.bfloat16)
        torch.testing.assert_close(out, Q.int8_matmul_fused_plain(x, w, bias, torch.bfloat16),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_interleaved_shapes_then_the_first_again(cuda_device):
    """Calls of other row counts between two calls of one shape (each sets
    other row tiles' counters, and leaves them at 0) change nothing."""
    shapes = [(300, 1024, 1024), (8192, 4096, 1024), (51, 64, 136), (1024, 1024, 4096),
              (8, 1808, 512)]
    cases = [_case(cuda_device, *shape, torch.bfloat16, True, seed=i)
             for i, shape in enumerate(shapes)]
    outs = [Q.int8_matmul_fused(x, w, bias, torch.bfloat16) for x, w, bias in cases]
    again = Q.int8_matmul_fused(*cases[0], torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(again, outs[0])
    for (x, w, bias), out in zip(cases, outs):
        torch.testing.assert_close(out, Q.int8_matmul_fused_plain(x, w, bias, torch.bfloat16),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_half_way_values_all_zero_rows_and_leading_dims(cuda_device):
    """Values at an exact .5 after scaling round half to even, an all-zero row
    takes the eps scale, and leading dims are kept."""
    x = torch.zeros(2, 5, 32, device=cuda_device)
    x[0, 0] = torch.arange(32, device=cuda_device) * 0.5   # amax 15.5 is not a power of two:
    x[0, 0, -1] = 127.0                                    # so pin the scale to exactly 1
    x[0, 1, 0] = -3.0
    w = torch.randn(24, 32, device=cuda_device)
    out = Q.int8_matmul_fused(x, w, None, torch.float32)
    torch.testing.assert_close(out, Q.int8_matmul_fused_plain(x, w, None, torch.float32),
                               rtol=0, atol=0)
    assert out.shape == (2, 5, 24) and (out[1] == 0).all()


@pytest.mark.cuda
def test_library_path_agrees_with_the_kernel(cuda_device):
    """`int8_matmul` (row quantization in torch + `torch._int_mm`) computes
    the same function as the fused kernel."""
    x, w, bias = _case(cuda_device, 200, 256, 512, torch.bfloat16, True)
    torch.testing.assert_close(Q.int8_matmul(x, w, bias, torch.float32),
                               Q.int8_matmul_fused(x, w, bias, torch.float32), rtol=0, atol=0)
    few = Q.int8_matmul(x[:3], w, bias, torch.float32)  # 16 rows or fewer are padded
    torch.testing.assert_close(few, Q.int8_matmul_fused(x[:3], w, bias, torch.float32),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="multiples of 8"):
        Q.int8_matmul(x, w[:510], None, torch.float32)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    """A din that is no multiple of 16 or too long for shared memory, or a
    float64 input, raises before any launch; no rows returns zeros without
    a launch.  Nothing falls back to the plain version on the card."""
    before = Q.int8_matmul_fused_cuda.launches
    w = torch.zeros(8, 24, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 16"):
        Q.int8_matmul_fused(torch.zeros(4, 24, device=cuda_device), w)
    with pytest.raises(ValueError, match="at most"):
        Q.int8_matmul_fused(torch.zeros(4, 8192, device=cuda_device),
                            torch.zeros(8, 8192, device=cuda_device))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        Q.int8_matmul_fused(torch.zeros(4, 32, device=cuda_device, dtype=torch.float64),
                            torch.zeros(8, 32, device=cuda_device))
    empty = Q.int8_matmul_fused(torch.zeros(0, 3, 32, device=cuda_device),
                                torch.zeros(8, 32, device=cuda_device))
    assert empty.shape == (0, 3, 8) and empty.dtype == torch.bfloat16
    assert Q.int8_matmul_fused_cuda.launches == before
