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
    kernels' 4096 split, at the edges of both kernels' 128-query blocks
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


def _inputs(device, B, L, H, dtype, seed, valid):
    """Unit-scale operands, gates in [1, 2), row b keeping its first valid[b] keys."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=g).to(dtype)

    q, k, v = randn(B, L, H * 64), randn(B, L, H * 64), randn(B, L, H * 64)
    bias = randn(H, L, L)
    gate = torch.rand(B, H, L, device=device, generator=g) + 1.0
    mask = torch.arange(L, device=device)[None, :] < torch.tensor(valid, device=device)[:, None]
    return q, k, v, bias, gate, mask


# (L, each row's valid keys) of the model paths' long and mixed shapes: a
# 100 s recording transcribed whole (4999 frames padded to 5120, the CLI's
# longest single-file shape, past the TPU kernels' 4096 split); a served
# batch in the 20 s bucket (12 requests of 2-20 s and 4 pad rows of 0.1 s);
# the four 30 s windows the server cuts a 100 s recording into
PATH_SHAPES = {
    "whole_file_B1_L5120": (5120, [4999]),
    "served_B16_L1024": (1024, [609, 487, 184, 413, 659, 119, 886, 868, 139, 821, 266, 725,
                                4, 4, 4, 4]),
    "served_B4_L1536": (1536, [1464, 1467, 1467, 599]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PATH_SHAPES))
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_at_path_shapes(cuda_device, case, dtype, atol):
    """Rows of their own lengths, as the CLI and the server give them;
    tolerances as above."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    L, valid = PATH_SHAPES[case]
    H = 16
    q, k, v, bias, gate, mask = _inputs(cuda_device, len(valid), L, H, dtype, 1, valid)
    out = FA.wavlm_gated_attention_heads_packed(q, k, v, bias, gate, mask, num_heads=H)
    ref = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [63, 64, 65, 127, 128, 129])
def test_f32_kernel_at_its_tile_edges(cuda_device, L):
    """The float32 kernel (3xTF32) at the edges of its 128-query blocks and
    64-key steps, each +-1 (odd L: bias rows TMA cannot address), three rows
    (every key kept, a ragged one, none kept) through the lse launch: out
    within 1e-4 of the plain version, lse within 1e-3 and exactly f32-min at
    the all-masked row, and the inference launch's output equal to it bit
    for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    H = 16
    q, k, v, bias, gate, mask = _inputs(cuda_device, 3, L, H, torch.float32, L,
                                        [L, L // 2 + 1, 0])
    out, lse = FA.wavlm_gated_attention_fwd_lse_cuda(q, k, v, bias, gate, mask, num_heads=H)
    same = FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, num_heads=H)
    torch.cuda.synchronize()
    ref, ref_lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, num_heads=H)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert bool((lse[2] == torch.finfo(torch.float32).min).all())
    assert torch.equal(same, out)


@pytest.mark.cuda
def test_f32_kernel_two_long_rows_past_4096(cuda_device):
    """B = 2 past the TPU kernels' 4096 split, both rows with kept keys (one
    ragged inside a 64-key step), float32 within 1e-4 of the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L, H = 4224, 16
    q, k, v, bias, gate, mask = _inputs(cuda_device, 2, L, H, torch.float32, 2, [L, 4100])
    out = FA.wavlm_gated_attention_heads_packed(q, k, v, bias, gate, mask, num_heads=H)
    ref = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [203, 1024])
def test_f32_kernel_all_masked_row_lse_is_f32_min(cuda_device, L):
    """A row whose keys are all masked, beside a full row: its output is the
    mean of v over the L real keys (as the plain version) and its lse
    exactly f32-min, which the backward relies on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    H = 16
    q, k, v, bias, gate, mask = _inputs(cuda_device, 2, L, H, torch.float32, 3, [0, L])
    out, lse = FA.wavlm_gated_attention_fwd_lse_cuda(q, k, v, bias, gate, mask, num_heads=H)
    torch.cuda.synchronize()
    assert bool((lse[0] == torch.finfo(torch.float32).min).all())
    mean_v = v[0].view(L, H, 64).mean(0).reshape(1, H * 64).expand(L, -1)
    torch.testing.assert_close(out[0], mean_v, atol=1e-4, rtol=0)
    ref = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


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
