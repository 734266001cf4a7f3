# -*- coding: utf-8 -*-
"""The trainable gated-attention kernels (B3 forward + logsumexp, B4 dq/dgate,
B5 dk/dv/dbias) against their plain versions, on the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine (see test_torch_gated_attention_cuda.py):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_gated_attention_train_cuda.py

Inputs are unit-scale with ragged key masks and one all-masked row, at an L
that is no multiple of 8 (203), the tail-block length of the TPU kernels'
fault (384) and the training length (1024); B4 (dq/dgate: 128-query blocks
walking key steps, 64 keys in bf16 and 32 in f32, those of 64-key tiles
without a kept key skipped) and B5 (dk/dv/dbias, two kernels: key blocks for
dk/dv, query x key blocks looping over the batch for dbias; 128 wide in
bf16, 64 in f32) also at the edges of those tiles (65, 127, 128, 129, 1000;
B4 also 31, 32, 33, 63, 64), with one and three batch rows and with the
fine-tune's 32, and twice in a row, where their outputs must agree bit for
bit (in f32 too).  Tolerances,
each a fraction of the reference's largest magnitude: float32 1e-4
(summation order only); bfloat16 2e-2 against the plain versions, which
round P and dS where the kernels do, and 5e-2 against autograd of the plain
forward, which keeps dS in f32 but rounds dP = dO V^T to bf16 instead.
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


def _inputs(dev, L, dtype, seed=0, batch=B):
    """Row 0 keeps its first L // 3 keys, rows 1 .. batch - 2 all but the
    last 29 i, and the last row of two or more none."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    q, k, v = randn(batch, L, H * 64), randn(batch, L, H * 64), randn(batch, L, H * 64)
    bias = randn(H, L, L)
    gate = torch.rand(batch, H, L, device=dev, generator=g) + 1.0
    mask = torch.ones(batch, L, dtype=torch.bool, device=dev)
    mask[0, L // 3:] = False
    for i in range(1, batch - 1):
        mask[i, max(1, L - 29 * i):] = False
    if batch > 1:
        mask[batch - 1] = False  # an all-masked row
    dout = randn(batch, L, H * 64)
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


def _backward(kernel, q, k, v, bias, gate, mask, dout):
    """B3's lse and the dispatcher's delta, then `kernel` (B4 or B5); with the
    plain backward's (dq, dk, dv, dbias, dgate)."""
    batch, L, _ = q.shape
    out, lse = FA.wavlm_gated_attention_fwd_lse_cuda(q, k, v, bias, gate, mask, H)
    delta = (dout.float() * out.float()).view(batch, L, H, 64).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    got = kernel(q, k, v, bias, gate, mask, lse, delta, dout, H)
    torch.cuda.synchronize()
    want = FA.wavlm_gated_attention_bwd_plain(q, k, v, bias, gate, mask, out, lse, dout, H)
    return got, want, (lse, delta)


def _dkv(q, k, v, bias, gate, mask, dout):
    """B5's outputs, the plain (dk, dv, dbias), and (lse, delta)."""
    got, want, rows = _backward(FA.wavlm_gated_attention_bwd_dkv_cuda, q, k, v, bias, gate, mask,
                                dout)
    return got, want[1:4], rows


def _dq(q, k, v, bias, gate, mask, dout):
    """B4's outputs, the plain (dq, dgate), and (lse, delta)."""
    got, want, rows = _backward(FA.wavlm_gated_attention_bwd_dq_cuda, q, k, v, bias, gate, mask,
                                dout)
    return got, (want[0], want[4]), rows


@pytest.mark.cuda
@pytest.mark.parametrize("L", [65, 127, 128, 129, 203, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dkv_kernel_at_its_tile_edges(cuda_device, L, dtype):
    """B5 against the plain backward at the edges of its blocks (bf16:
    128-key and 128-query blocks and 64-row tiles; f32: 64-key and 64-query
    blocks and 32-query steps); bias rows not 16-byte aligned at 127, 129
    and 203 (f32 also 65: loaded elementwise, not by TMA)."""
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, L, dtype, seed=2)
    (dk, dv, dbias), want, _ = _dkv(q, k, v, bias, gate, mask, dout)
    for name, a, b in zip(("dk", "dv", "dbias"), (dk, dv, dbias), want):
        assert torch.isfinite(a).all(), name
        _assert_rel(name, a, b, REL_TOL[dtype])
    assert dk[1].abs().max().item() == 0  # the all-masked row
    _assert_rel("dv all-masked", dv[1], (dout[1].float().sum(0) / L).expand(L, -1),
                REL_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dkv_kernel_batch_rows(cuda_device, batch, dtype):
    """dbias sums over the batch inside one block: one row, and the
    fine-tune's 32 (ragged rows and an all-masked one) at L = 1024."""
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, 1024, dtype, seed=3, batch=batch)
    (dk, dv, dbias), want, _ = _dkv(q, k, v, bias, gate, mask, dout)
    for name, a, b in zip(("dk", "dv", "dbias"), (dk, dv, dbias), want):
        assert torch.isfinite(a).all(), name
        _assert_rel(name, a, b, REL_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dkv_kernel_is_deterministic(cuda_device, dtype):
    """No atomics: two calls on the same inputs agree bit for bit."""
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, 1024, dtype, seed=4, batch=8)
    first, _, (lse, delta) = _dkv(q, k, v, bias, gate, mask, dout)
    again = FA.wavlm_gated_attention_bwd_dkv_cuda(q, k, v, bias, gate, mask, lse, delta, dout, H)
    for name, a, b in zip(("dk", "dv", "dbias"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("L", [31, 32, 33, 63, 64, 65, 127, 128, 129, 203, 1000, 1024])
def test_dq_kernel_at_its_tile_edges(cuda_device, L, batch, dtype):
    """B4 against the plain backward at the edges of its 128-query blocks
    and its key steps (bf16: 64-key tiles; f32: 32-key steps, both halves of
    each 64-key tile holding a kept key); bias rows not 16-byte aligned at
    127, 129 and 203 (f32 also 31, 33, 63 and 65: loaded elementwise, not by
    TMA), and in bf16 mask rows neither where L % 16 != 0.  With three rows
    the last one is all masked: no key step is visited, and its dq and
    dgate are exactly 0."""
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, L, dtype, seed=5, batch=batch)
    (dq, dgate), want, _ = _dq(q, k, v, bias, gate, mask, dout)
    for name, a, b in zip(("dq", "dgate"), (dq, dgate), want):
        assert torch.isfinite(a).all(), name
        _assert_rel(name, a, b, REL_TOL[dtype])
    if batch > 1:
        assert dq[-1].abs().max().item() == 0 and dgate[-1].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dq_kernel_at_the_fine_tune_batch(cuda_device, dtype):
    """B = 32 at L = 1024 with ragged rows (whole 64-key tiles masked, which
    B4 skips) and one all-masked row, whose dq and dgate are exactly 0."""
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, 1024, dtype, seed=6, batch=32)
    (dq, dgate), want, _ = _dq(q, k, v, bias, gate, mask, dout)
    for name, a, b in zip(("dq", "dgate"), (dq, dgate), want):
        assert torch.isfinite(a).all(), name
        _assert_rel(name, a, b, REL_TOL[dtype])
    assert dq[31].abs().max().item() == 0 and dgate[31].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dq_kernel_is_deterministic(cuda_device, dtype):
    """No atomics: two calls on the same inputs agree bit for bit."""
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, 1024, dtype, seed=7, batch=8)
    first, _, (lse, delta) = _dq(q, k, v, bias, gate, mask, dout)
    again = FA.wavlm_gated_attention_bwd_dq_cuda(q, k, v, bias, gate, mask, lse, delta, dout, H)
    for name, a, b in zip(("dq", "dgate"), first, again):
        assert torch.equal(a, b), name
