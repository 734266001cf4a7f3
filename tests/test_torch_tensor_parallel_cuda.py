# -*- coding: utf-8 -*-
"""The kernels at the shapes tensor parallelism gives them, on the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tensor_parallel_cuda.py

* A "model" rank of WavLM-large holds H = 16 / M heads: B1 (the inference
  kernel), B3 (forward with logsumexp), B4 (dQ, dgate) and B5 (dK, dV,
  dbias) at H = 8 and H = 4, float32 and bfloat16, L = 1024 with ragged
  key masks and an all-masked row, and L = 203, against their plain
  versions (the tolerances of tests/test_torch_gated_attention_train_cuda.py).
* B7 on a column slice (rank 1 of 2 of a 1024 x 1024 dense: dout 512), equal
  to its plain version bit for bit and to those columns of the whole
  layer's output; the row-parallel int8 layer of a model group of one (NCCL
  at world size 1) equal to the one-process int8 layer bit for bit.
* A world-size-1 mesh (data=1, model=1) over NCCL through `apply_mesh` and
  `enable_tensor_parallel`: the same encoder output and ids as no mesh, bit
  for bit.
"""
import socket

import numpy as np
import pytest
import torch

from fddm_asr_tpu_torch import parallel as P
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.ops import flash_attention as FA
from fddm_asr_tpu_torch.ops import quant as Q
from fddm_asr_tpu_torch.parallel import tensor as T
from fddm_asr_tpu_torch.pipeline import FDDMPipeline

pytestmark = pytest.mark.cuda
B = 3
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, L, H, dtype, seed=0):
    """Row 0 keeps its first L // 3 keys, row 1 all but the last 29, row 2
    none."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    q, k, v = randn(B, L, H * 64), randn(B, L, H * 64), randn(B, L, H * 64)
    bias = randn(H, L, L)
    gate = torch.rand(B, H, L, device=dev, generator=g) + 1.0
    mask = torch.ones(B, L, dtype=torch.bool, device=dev)
    mask[0, L // 3:] = False
    mask[1, L - 29:] = False
    mask[2] = False
    return q, k, v, bias, gate, mask, randn(B, L, H * 64)


def _assert_rel(name, got, want, rel):
    want = want.float()
    scale = max(want.abs().max().item(), 1e-6)
    err = (got.float() - want).abs().max().item()
    assert err <= rel * scale, f"{name}: max abs err {err} > {rel} x {scale}"


@pytest.mark.parametrize("H", [8, 4], ids=["H8", "H4"])
@pytest.mark.parametrize("L", [203, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b1_b3_b4_b5_at_a_ranks_heads(cuda_device, H, L, dtype):
    q, k, v, bias, gate, mask, dout = _inputs(cuda_device, L, H, dtype)
    kernels = (FA.wavlm_gated_attention_cuda, FA.wavlm_gated_attention_fwd_lse_cuda,
               FA.wavlm_gated_attention_bwd_dq_cuda, FA.wavlm_gated_attention_bwd_dkv_cuda)
    before = [f.launches for f in kernels]
    b1 = FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, H)
    plain = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H)
    _assert_rel("B1", b1, plain, REL_TOL[dtype])
    out, lse = FA.wavlm_gated_attention_fwd_lse_cuda(q, k, v, bias, gate, mask, H)
    ref_out, ref_lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, H)
    _assert_rel("B3", out, ref_out, REL_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    assert torch.equal(b1, out)  # B1 and B3 give the same output, bit for bit
    delta = (dout.float() * out.float()).view(B, L, H, 64).sum(-1).transpose(1, 2).contiguous()
    dq, dgate = FA.wavlm_gated_attention_bwd_dq_cuda(q, k, v, bias, gate, mask, lse, delta,
                                                     dout, H)
    dk, dv, dbias = FA.wavlm_gated_attention_bwd_dkv_cuda(q, k, v, bias, gate, mask, lse,
                                                          delta, dout, H)
    torch.cuda.synchronize()
    want = FA.wavlm_gated_attention_bwd_plain(q, k, v, bias, gate, mask, out, lse, dout, H)
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dgate"), (dq, dk, dv, dbias, dgate),
                          want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        _assert_rel(name, a, b, REL_TOL[dtype])
    assert [f.launches for f in kernels] == [c + 1 for c in before]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def nccl_world_of_one(cuda_device):
    P.initialize(P.DistributedConfig(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl"))
    try:
        yield P.make_mesh(P.MeshSpec(data=1, model=1))
    finally:
        P.shutdown()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_b7_on_a_column_slice(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(1024, 1024, device=cuda_device, generator=g).to(dtype)
    w = torch.randn(1024, 1024, device=cuda_device, generator=g)
    b = torch.randn(1024, device=cuda_device, generator=g)
    w1, b1 = T.local_tensor(w, T.COLUMN, 1, 2), T.local_tensor(b, T.COLUMN, 1, 2)
    wq, sw = Q.quantized_weight({}, "w", w1)
    before = Q.int8_matmul_fused_cuda.launches
    got = Q.int8_matmul_fused_cuda(x, wq, sw, b1, dtype)
    assert Q.int8_matmul_fused_cuda.launches == before + 1
    want = Q.int8_matmul_fused_plain(x, None, b1, dtype, wq_sw=(wq, sw))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    whole = Q.int8_matmul_fused(x, w, b, dtype)
    torch.testing.assert_close(got, whole[:, 512:], rtol=0, atol=0)


def test_row_parallel_int8_over_a_group_of_one(nccl_world_of_one):
    mesh = nccl_world_of_one
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(8, 100, 1024, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(768, 1024, device="cuda", generator=g)
    b = torch.randn(768, device="cuda", generator=g)
    with torch.inference_mode():
        got = Q.quantized_linear_row_parallel({}, "w", x, w, b, torch.bfloat16,
                                              mesh.model_group)
        want = Q.int8_matmul(x, w, b, torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_world_size_one_mesh_is_the_bare_pipeline(nccl_world_of_one):
    mesh = nccl_world_of_one
    cfg = Config({"seed": 0, "data": {"vocab_size": 96, "tokenizer_path": None},
                  "model": {"d_model": 64, "nhead": 4, "num_layers": 2, "dim_ff": 128,
                            "dtype": "float32",
                            # 64-wide heads, as the kernels take them
                            "encoder": {"wavlm_name": "tiny", "wavlm_config": {
                                "hidden_size": 128, "num_attention_heads": 2,
                                "intermediate_size": 256}}},
                  "diffusion": {"T": 20, "beta_max": 0.2}})
    wave = np.random.default_rng(0).standard_normal((4, 16000)).astype(np.float32)
    x_init = torch.randint(0, 96, (4, 12), generator=torch.Generator().manual_seed(1)).cuda()
    out = {}
    for name in ("bare", "mesh"):
        pipe = FDDMPipeline.from_config(cfg, tokenizer=object(), device="cuda")
        if name == "mesh":
            pipe.apply_mesh(mesh)
            assert not pipe.enable_tensor_parallel(mesh) and not T.is_sharded(pipe.decoder)
        c, _ = pipe.encode_waveform(wave)
        ids, _ = pipe.sample(c, 12, generator=torch.Generator(device="cuda").manual_seed(0),
                             x_init=x_init, T_infer=4, r=2, greedy=True)
        out[name] = (c, ids)
    assert torch.equal(out["bare"][0], out["mesh"][0])
    assert torch.equal(out["bare"][1], out["mesh"][1])
