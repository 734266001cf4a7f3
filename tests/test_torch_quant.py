# -*- coding: utf-8 -*-
"""The port's dynamic int8 dense path against the JAX package's.

The same numpy inputs go through `fddm_asr_tpu/ops/quant.py` and the port's
`ops/quant.py`.  The quantized integers and scales must be identical (same
f32 multiply for the scale, same divide, same round-half-even).  The Pallas
kernel runs in interpret mode, as the JAX package's own tests run it; on
the CPU the port takes the kernel's plain version.  Products are exact
integers on both sides and the f32 epilogue has the same steps, so outputs
agree at rtol/atol 1e-6 (XLA may contract the bias add into an FMA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.ops import quant as JQ
from fddm_asr_tpu_torch.ops import quant as Q


def _half_way_rows(rng, dtype):
    """Rows with an all-zero row (the eps scale), a row whose scale is
    exactly 1 so that k + 0.5 values sit on a rounding tie, and noise."""
    x = rng.standard_normal((6, 32)).astype(np.float32) * 3.0
    x[1] = 0.0
    x[2] = np.arange(32, dtype=np.float32) * 0.5 - 4.0
    x[2, -1] = 127.0
    x[3] = -x[2]
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_row_and_column_quantization_identical_to_jax(rng, dtype):
    jx, tx = _half_way_rows(rng, dtype)
    jq, js = JQ.quantize_rows_int8(jx)
    tq, ts = Q.quantize_rows_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (6, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 0].item() == np.float32(1e-8) * np.float32(1.0 / 127.0)  # the eps row
    assert tq[2, 1].item() == -4 and tq[2, 9].item() == 0  # -3.5 -> -4, 0.5 -> 0: ties to even

    jq, js = JQ.quantize_cols_int8(jx)
    tq, ts = Q.quantize_cols_int8(tx)
    assert ts.shape == (1, 32)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # nn.Linear's [dout, din] weight quantized by rows is the [din, dout] kernel by columns
    wq, sw = Q.quantized_weight({}, "w", tx.float().t().contiguous())
    np.testing.assert_array_equal(wq.numpy(), tq.numpy().T)
    np.testing.assert_array_equal(sw.numpy(), ts.numpy()[0])


@pytest.mark.parametrize("lead,din,dout,x_dtype,with_bias", [
    ((96,), 128, 256, np.float32, True),      # tests/test_quant.py's exact case
    ((3, 17), 64, 136, "bfloat16", False),    # ragged rows and dout, no bias
    ((5,), 4096, 24, np.float32, True),       # din * 127^2 > 2^24: f32 sums would be inexact
], ids=["square", "ragged-nobias", "long-din"])
def test_fused_plain_matches_pallas_interpret_and_unfused(rng, lead, din, dout, x_dtype,
                                                          with_bias):
    x = rng.standard_normal((*lead, din)).astype(np.float32)
    if din == 4096:
        x = np.sign(x) * (1.0 + np.abs(x))  # every product near full scale
    kernel = (rng.standard_normal((din, dout)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((dout,)).astype(np.float32) if with_bias else None
    bf16 = x_dtype == "bfloat16"
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    weight = torch.from_numpy(kernel.T.copy())  # nn.Linear layout

    ref_fused = np.asarray(JQ.int8_matmul_fused(jx, jnp.asarray(kernel), jb, jnp.float32,
                                                block_m=32, block_n=128, interpret=True))
    ref_unfused = np.asarray(JQ.int8_matmul(jx, jnp.asarray(kernel), jb, jnp.float32))
    before = Q.int8_matmul_fused_cuda.launches
    fused = Q.int8_matmul_fused(tx, weight, tb, torch.float32).numpy()
    unfused = Q.int8_matmul(tx, weight, tb, torch.float32).numpy()
    assert Q.int8_matmul_fused_cuda.launches == before  # a CPU tensor takes the plain version
    assert fused.shape == (*lead, dout)
    np.testing.assert_array_equal(fused, unfused)
    np.testing.assert_allclose(fused, ref_fused, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fused, ref_unfused, rtol=1e-6, atol=1e-6)
    if bf16:  # the output cast
        out = Q.int8_matmul_fused(tx, weight, tb, torch.bfloat16)
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(),
                                      torch.from_numpy(fused).bfloat16().float().numpy())


def test_no_rows_returns_zeros_like_jax():
    x = np.zeros((0, 5, 32), np.float32)
    kernel = np.ones((32, 8), np.float32)
    ref = JQ.int8_matmul_fused(jnp.asarray(x), jnp.asarray(kernel), None, jnp.float32,
                               interpret=True)
    for fn in (Q.int8_matmul_fused, Q.int8_matmul):
        out = fn(torch.from_numpy(x), torch.from_numpy(kernel.T.copy()), None, torch.float32)
        assert out.shape == tuple(ref.shape) == (0, 5, 8) and out.dtype == torch.float32


def test_quantized_weight_cache_follows_the_weight(rng):
    """The per-module cache is reused while the weight is untouched and made
    anew after an in-place update; a row slice is quantized on its own."""
    w = torch.from_numpy(rng.standard_normal((12, 16)).astype(np.float32))
    cache = {}
    wq, sw = Q.quantized_weight(cache, "w", w)
    assert Q.quantized_weight(cache, "w", w)[0] is wq
    with torch.no_grad():
        w.mul_(2.0)
        w[0, 0] = 100.0
    wq2, sw2 = Q.quantized_weight(cache, "w", w)
    assert wq2 is not wq and sw2[0] == 100.0 * np.float32(1.0 / 127.0)
    part_q, part_s = Q.quantized_weight(cache, "rows", w, rows=slice(4, 8))
    np.testing.assert_array_equal(part_q.numpy(), wq2[4:8].numpy())
    np.testing.assert_array_equal(part_s.numpy(), sw2[4:8].numpy())


def test_quantized_linear_is_inference_only(rng):
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w = torch.nn.Parameter(torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)))
    with pytest.raises(RuntimeError, match="inference only"):
        Q.quantized_linear("int8_fused", {}, "w", x, w, None, torch.float32)
    with torch.no_grad():
        out = Q.quantized_linear("int8_fused", {}, "w", x, w, None, torch.float32)
    ref = x @ w.detach().t()
    assert 1e-6 < ((out - ref).norm() / ref.norm()).item() < 0.02
    with pytest.raises(ValueError, match="CUDA"):
        Q.int8_matmul_fused_cuda(x, *Q.quantized_weight({}, "w", w), None, torch.float32)
