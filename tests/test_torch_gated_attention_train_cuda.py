# -*- coding: utf-8 -*-
"""The trainable gated-attention kernels (B3 forward + logsumexp, B4 dq/dgate,
B5 dk/dv/dbias) against their plain versions, on the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine (see test_torch_gated_attention_cuda.py):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_gated_attention_train_cuda.py

Inputs are unit-scale with ragged key masks and one all-masked row, at an L
that is no multiple of 8 (203), the tail-block length of the TPU kernels'
fault (384) and the training length (1024).  Tolerances, each a fraction of
the reference's largest magnitude: float32 1e-4 (summation order only);
bfloat16 2e-2 against the plain versions, which round P and dS where the
kernels do, and 5e-2 against autograd of the plain forward, which keeps dS
in f32 but rounds dP = dO V^T to bf16 instead.
"""
import pytest
import torch

from fddm_asr_tpu_torch.ops import flash_attention as FA

B, H = 2, 16
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REL_TOL_AUTOGRAD = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, L, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    q, k, v = randn(B, L, H * 64), randn(B, L, H * 64), randn(B, L, H * 64)
    bias = randn(H, L, L)
    gate = torch.rand(B, H, L, device=dev, generator=g) + 1.0
    mask = torch.ones(B, L, dtype=torch.bool, device=dev)
    mask[0, L // 3:] = False
    mask[1] = False  # an all-masked row
    dout = randn(B, L, H * 64)
    return q, k, v, bias, gate, mask, dout


def _assert_rel(name, got, want, rel):
    want = want.float()
    scale = max(want.abs().max().item(), 1e-6)
    err = (got.float() - want).abs().max().item()
    assert err <= rel * scale, f"{name}: max abs err {err} > {rel} x {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("L", [203, 384, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_match_plain_on_card(cuda_device, L, dtype):
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, L, dtype)
    counts = [f.launches for f in (FA.wavlm_gated_attention_fwd_lse_cuda,
                                   FA.wavlm_gated_attention_bwd_dq_cuda,
                                   FA.wavlm_gated_attention_bwd_dkv_cuda)]
    out, lse = FA.wavlm_gated_attention_fwd_lse_cuda(q, k, v, bias, gate, mask, H)
    ref_out, ref_lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, H)
    torch.cuda.synchronize()
    _assert_rel("out", out, ref_out, REL_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    # the inference kernel gives the same output as B3, bit for bit
    assert torch.equal(FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, H), out)

    delta = (dout.float() * out.float()).view(B, L, H, 64).sum(-1).transpose(1, 2).contiguous()
    dq, dgate = FA.wavlm_gated_attention_bwd_dq_cuda(q, k, v, bias, gate, mask, lse, delta,
                                                     dout, H)
    dk, dv, dbias = FA.wavlm_gated_attention_bwd_dkv_cuda(q, k, v, bias, gate, mask, lse,
                                                          delta, dout, H)
    torch.cuda.synchronize()
    assert dbias.dtype == torch.float32
    want = FA.wavlm_gated_attention_bwd_plain(q, k, v, bias, gate, mask, out, lse, dout, H)
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dgate"),
                          (dq, dk, dv, dbias, dgate), want):
        assert torch.isfinite(a).all(), name
        _assert_rel(name, a, b, REL_TOL[dtype])
    # the all-masked row: no gradient reaches q, k or the gate; v gets 1/L of sum(dO)
    assert dq[1].abs().max().item() == 0 and dk[1].abs().max().item() == 0
    assert dgate[1].abs().max().item() == 0
    _assert_rel("dv all-masked", dv[1], (dout[1].float().sum(0) / L).expand(L, -1),
                REL_TOL[dtype])
    assert [f.launches for f in (FA.wavlm_gated_attention_fwd_lse_cuda,
                                 FA.wavlm_gated_attention_bwd_dq_cuda,
                                 FA.wavlm_gated_attention_bwd_dkv_cuda)] == [
        c + 1 for c in counts]


@pytest.mark.cuda
@pytest.mark.parametrize("L", [203, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_function_matches_autograd_of_plain(cuda_device, L, dtype):
    """GatedAttentionTrain (B3 forward, B4 + B5 backward) against autograd of
    the plain forward: the exact gradient of the port's own forward."""
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, L, dtype, seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias, gate)]
    out = FA.wavlm_gated_attention_heads_packed_trainable(*leaves, mask, num_heads=H)
    got = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v, bias, gate)]
    ref_out = FA.wavlm_gated_attention_plain(*ref_leaves, mask, num_heads=H)
    want = torch.autograd.grad(ref_out, ref_leaves, dout)
    _assert_rel("out", out.detach(), ref_out.detach(), REL_TOL[dtype])
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dgate"), got, want):
        assert a.dtype == b.dtype, name
        _assert_rel(name, a, b, REL_TOL_AUTOGRAD[dtype])


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    """Wrong lse shape or dout type raises before any launch."""
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, 64, torch.bfloat16)
    lse = torch.zeros(B, H, 64, device=cuda_device)
    before = FA.wavlm_gated_attention_bwd_dq_cuda.launches
    with pytest.raises(ValueError, match="lse"):
        FA.wavlm_gated_attention_bwd_dq_cuda(q, k, v, bias, gate, mask, lse[:, :8], lse,
                                             dout, H)
    with pytest.raises(ValueError, match="dout"):
        FA.wavlm_gated_attention_bwd_dkv_cuda(q, k, v, bias, gate, mask, lse, lse,
                                              dout.float(), H)
    assert FA.wavlm_gated_attention_bwd_dq_cuda.launches == before
