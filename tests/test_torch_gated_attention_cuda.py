# -*- coding: utf-8 -*-
"""The gated-attention CUDA kernel against its plain version, on the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine, where JAX is absent and the tests'
conftest.py (which imports JAX) has to be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_gated_attention_cuda.py
"""
import pytest
import torch

from fddm_asr_tpu_torch.ops import flash_attention as FA


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [65, 128, 129, 203, 1000, 1024, 4224, 5120])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_on_card(cuda_device, L, dtype, atol):
    """Ragged masks plus one all-masked row, on both sides of the TPU
    kernels' 4096 split, at the edges of the bf16 kernel's 128-query blocks
    and 64-key steps (65, 128, 129, 1000), and at an L that is no multiple
    of 8 (tails of every tile, bias rows not 16-byte aligned); the
    tolerances are those of unit-scale inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, H = 2, 16

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    q, k, v = randn(B, L, H * 64), randn(B, L, H * 64), randn(B, L, H * 64)
    bias = randn(H, L, L)
    gate = torch.rand(B, H, L, device=cuda_device, generator=g) + 1.0
    mask = torch.ones(B, L, dtype=torch.bool, device=cuda_device)
    mask[0, L // 3:] = False
    mask[1] = False
    before = FA.wavlm_gated_attention_cuda.launches
    out = FA.wavlm_gated_attention_heads_packed(q, k, v, bias, gate, mask, num_heads=H)
    torch.cuda.synchronize()
    assert FA.wavlm_gated_attention_cuda.launches == before + 1
    ref = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_at_the_whole_file_shape(cuda_device, dtype, atol):
    """A 100 s recording transcribed whole: one row of 4999 frames padded to
    5120 (the CLI's longest single-file shape, past the TPU kernels' 4096
    split), tolerances as above."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, L, H, valid = 1, 5120, 16, 4999

    def randn(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(dtype)

    q, k, v = randn(B, L, H * 64), randn(B, L, H * 64), randn(B, L, H * 64)
    bias = randn(H, L, L)
    gate = torch.rand(B, H, L, device=cuda_device, generator=g) + 1.0
    mask = torch.zeros(B, L, dtype=torch.bool, device=cuda_device)
    mask[:, :valid] = True
    out = FA.wavlm_gated_attention_heads_packed(q, k, v, bias, gate, mask, num_heads=H)
    ref = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    """A head dim other than 64, or a gate not in float32, raises before any
    launch: on the card nothing falls back to the plain version."""
    B, L, H = 1, 64, 8
    q = torch.zeros(B, L, H * 128, device=cuda_device)
    bias = torch.zeros(H, L, L, device=cuda_device)
    gate = torch.ones(B, H, L, device=cuda_device)
    before = FA.wavlm_gated_attention_cuda.launches
    with pytest.raises(ValueError, match="head dim"):
        FA.wavlm_gated_attention_heads_packed(q, q, q, bias, gate, None, num_heads=H)
    q = torch.zeros(B, L, H * 64, device=cuda_device)
    with pytest.raises(ValueError, match="gate"):
        FA.wavlm_gated_attention_heads_packed(q, q, q, bias, gate.double(), None, num_heads=H)
    assert FA.wavlm_gated_attention_cuda.launches == before
