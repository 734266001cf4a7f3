# -*- coding: utf-8 -*-
"""Dynamic int8 dense layers (inference): the fused Hopper kernel, the
library path and their plain version.

Counterpart of `fddm_asr_tpu/ops/quant.py`.  Symmetric dynamic quantization,
no calibration and no checkpoint change:

    scale = max(amax, 1e-8) * (1 / 127)        an f32 multiply, not a divide
    q     = clip(round_half_even(x / scale), -127, 127)     a divide
    y     = (int32(xq @ wq^T) * sx) * sw + bias             f32, then the cast

with `sx` per row of the activations (per token) and `sw` per output channel
of the weight.  The integers are those of the JAX package bit for bit
(`tests/test_torch_quant.py`).

Weights keep `nn.Linear`'s layout, [dout, din]: quantizing per output
channel is `quantize_rows_int8(weight)`, and checkpoints and `convert.py`
are those of the full-precision model.  (`quantize_cols_int8` takes the JAX
package's [din, dout] kernel and exists for that comparison.)

  * `int8_matmul_fused` is the TPU's Pallas path (`_fused_kernel`): on a
    CUDA tensor it launches `csrc/int8_matmul_fused.cu`, which quantizes the
    activations and multiplies in one launch (through a workspace this
    module allocates), or raises; on a CPU tensor it takes
    `int8_matmul_fused_plain`.  Routing is by the tensor's device alone.
  * `int8_matmul` is the TPU package's XLA path, which has no Pallas body:
    row quantization in plain torch, then an exact integer product (on the
    card the library's `torch._int_mm`), then the f32 epilogue.

Under tensor parallelism a column-parallel layer quantizes as in one
process (its input is whole, its scales per output channel) and launches
the fused kernel on its column slice; a row-parallel one takes
`quantized_linear_row_parallel` (maxima over "model" for both scales, int32
partial products summed over "model", the epilogue once), through the
library's product under "int8" and "int8_fused" alike.

Weight quantization happens outside the kernel, in plain torch, as in the
JAX package; `quantized_weight` keeps the result per module, keyed to the
weight's version counter, device and storage, so a frozen model quantizes
each weight once.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from fddm_asr_tpu_torch.ops import _build

EPS = 1e-8
# the longest din the fused kernel takes (its workspace, not its shared
# memory, grows with din; the limit stays where it was so that the kernel
# takes the inputs it always took)
MAX_FUSED_DIN = 5312
ROW_TILE = 128  # the kernel's output tile rows: one arrival counter per row tile

_build.register("fddm_int8_matmul_fused_weight_maps", "int8_matmul_fused",
                [_build.P] * 3 + [_build.I] * 2 + [_build.P])
_build.register("fddm_int8_matmul_fused", "int8_matmul_fused",
                [_build.P, _build.P, _build.I] + [_build.P] * 4 + [_build.I] * 5 + [_build.F])

# (device index, stream) -> the kernel's u32 counters: [blocks done, rows
# quantized per row tile...], zeroed once and left at 0 by every launch
_sync_buffers: Dict[Tuple[int, int], torch.Tensor] = {}


def fused_workspace_bytes(rows: int, din: int) -> int:
    """Device memory one fused launch borrows from the caching allocator:
    xq [rows, din] int8 and sx [rows] f32."""
    return rows * din + 4 * rows


def _sync_buffer(dev: torch.device, rows: int) -> torch.Tensor:
    """The counters for a launch of `rows` rows on `dev`'s current stream,
    the one `_build.launch` uses (one buffer per stream: launches on one
    stream run in turn)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    need = 1 + -(-rows // ROW_TILE)
    buf = _sync_buffers.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, device=dev, dtype=torch.int32)
        _sync_buffers[key] = buf
    return buf


def _fused_weight_maps(dev: torch.device, wq: torch.Tensor, sw: torch.Tensor,
                       bias: Optional[torch.Tensor]) -> ctypes.Array:
    """The tensor maps of wq, sw and bias, encoded on a weight's first call."""
    dout, din = wq.shape
    return _build.kept_tensor_maps("fddm_int8_matmul_fused_weight_maps", dev, 3, wq.data_ptr(),
                                   sw.data_ptr(), _build.ptr(bias), din, dout)


def _quantize(x: torch.Tensor, dim: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp(min=eps) * (1.0 / 127.0)
    xq = torch.round(xf / scale).clamp(-127.0, 127.0)  # torch.round: half to even
    return xq.to(torch.int8), scale


def quantize_rows_int8(x: torch.Tensor, eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along the last axis: (xq int8, scale f32
    with a size-1 last axis), xq * scale ~= x."""
    return _quantize(x, -1, eps)


def quantize_cols_int8(w: torch.Tensor, eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantization of a [din, dout] kernel (the JAX
    package's layout): (wq int8 [din, dout], scale f32 [1, dout])."""
    return _quantize(w, 0, eps)


def quantized_weight(cache: Dict[str, tuple], key: str, weight: torch.Tensor,
                     rows: Optional[slice] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wq [dout, din] int8, sw [dout] f32) of `weight[rows]` ([dout, din]),
    each output channel on its own.  `cache` is a dict the calling module
    owns; an entry is reused while the weight's version counter, device and
    storage stay what they were when it was made (an in-place update, a
    `load_state_dict` or a move to another device makes a new one).  Under
    a trace (`_build.tracing()`) the quantization is a step of the program,
    where the weight is an input, and nothing is cached."""
    tracing = _build.tracing()
    if not tracing:
        stamp = (weight._version, weight.device, weight.data_ptr())
        hit = cache.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1], hit[2]
    w = weight.detach() if rows is None else weight.detach()[rows]
    wq, sw = quantize_rows_int8(w)
    wq, sw = wq.contiguous(), sw.reshape(-1).contiguous()
    if not tracing:
        cache[key] = (stamp, wq, sw)
    return wq, sw


def _exact_int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, din] @ wq [dout, din]^T in exact integer arithmetic: int32 on
    the CPU, float64 on the card (which has no integer matmul outside
    `_int_mm`); |sum| <= din * 127^2 fits both.  float32 would be exact only
    while din * 127^2 < 2^24, which din = 4096 breaks."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ wq.to(torch.int32).t()
    return xq.double() @ wq.double().t()


def _int_mm_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The library's int8 product on the card.  `torch._int_mm` takes more
    than 16 rows and din, dout in multiples of 8: short inputs are padded
    with zero rows, other widths raise."""
    M, din = xq.shape
    dout = wq.shape[0]
    if din % 8 or dout % 8:
        raise ValueError(f"int8_matmul on CUDA needs din and dout in multiples of 8 "
                         f"(torch._int_mm), got din={din}, dout={dout}")
    if M <= 16:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, 32 - M))
    return torch._int_mm(xq, wq.t())[:M]


def _int8_linear(x, weight, bias, out_dtype, eps, wq_sw, product) -> torch.Tensor:
    """Row quantization, `product(xq, wq)` and the f32 epilogue
    `(acc * sx) * sw + bias`, cast to `out_dtype`."""
    wq, sw = wq_sw if wq_sw is not None else quantized_weight({}, "w", weight)
    lead, dout = x.shape[:-1], wq.shape[0]
    xq, sx = quantize_rows_int8(x.reshape(-1, x.shape[-1]), eps)
    if xq.shape[0] == 0:
        return x.new_zeros((*lead, dout), dtype=out_dtype)
    y = product(xq, wq).float() * sx * sw
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*lead, dout)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16, eps: float = EPS,
                wq_sw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """`x @ weight^T (+ bias)` through dynamic int8, unfused (the JAX
    package's XLA path): x [..., din] of any float type, weight [dout, din]
    full precision (or `wq_sw`, its quantization from `quantized_weight`).
    On the card the integer product is `torch._int_mm`."""
    product = _exact_int_product if x.device.type == "cpu" else _int_mm_product
    return _int8_linear(x, weight, bias, out_dtype, eps, wq_sw, product)


def int8_matmul_fused_plain(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            out_dtype: torch.dtype = torch.bfloat16, eps: float = EPS,
                            wq_sw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, on any device: the same
    integers (exact product) and the same f32 epilogue.  The CPU path, the
    tests' reference and `chip_smoke.py`'s comparison."""
    return _int8_linear(x, weight, bias, out_dtype, eps, wq_sw, _exact_int_product)


def int8_matmul_fused_cuda(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           out_dtype: torch.dtype = torch.bfloat16,
                           eps: float = EPS) -> torch.Tensor:
    """B7: launch the fused kernel on CUDA tensors (raises on anything else):
    x [..., din] float32 or bfloat16, wq [dout, din] int8, sw [dout] f32,
    bias [dout] f32 or None.  Allocates the workspace (`fused_workspace_bytes`)
    from the caching allocator; encodes wq's, sw's and bias's tensor maps
    once per weight (`_fused_weight_maps`), xq's every call.  Adds one to `int8_matmul_fused_cuda.launches`
    per launch; an input with no rows returns zeros without one."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused int8 kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _build.DTYPE_CODE or out_dtype not in _build.DTYPE_CODE:
        raise ValueError(f"the fused int8 kernel takes float32 or bfloat16 in and out, "
                         f"got {x.dtype} -> {out_dtype}")
    din = x.shape[-1]
    dout = wq.shape[0]
    if din % 16 or din > MAX_FUSED_DIN:
        raise ValueError(f"the fused int8 kernel needs din in multiples of 16, at most "
                         f"{MAX_FUSED_DIN}; got {din}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, din)
    M = x2.shape[0]
    if M == 0:
        return x.new_zeros((*lead, dout), dtype=out_dtype)
    dev = x.device
    _build.check_tensor("x", x2, (M, din), x.dtype, dev)
    _build.check_tensor("wq", wq, (dout, din), torch.int8, dev)
    _build.check_tensor("sw", sw, (dout,), torch.float32, dev)
    if bias is not None:
        _build.check_tensor("bias", bias, (dout,), torch.float32, dev)
    out = torch.empty(M, dout, device=dev, dtype=out_dtype)
    # xq [M, din] int8, then sx [M] f32 (16-byte aligned: din % 16 == 0)
    work = torch.empty(fused_workspace_bytes(M, din), device=dev, dtype=torch.uint8)
    maps = _fused_weight_maps(dev, wq, sw, bias)
    sync = _sync_buffer(dev, M)
    _build.launch("fddm_int8_matmul_fused", dev, x2.data_ptr(), maps, int(bias is not None),
                  out.data_ptr(), work.data_ptr(), work.data_ptr() + M * din, sync.data_ptr(),
                  M, din, dout, _build.DTYPE_CODE[x.dtype], _build.DTYPE_CODE[out_dtype], eps)
    int8_matmul_fused_cuda.launches += 1
    return out.reshape(*lead, dout)


int8_matmul_fused_cuda.launches = 0


def _fused(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, bias: Optional[torch.Tensor],
           out_dtype: torch.dtype, eps: float) -> torch.Tensor:
    """B7 on x's device: CPU -> the plain version, CUDA -> the kernel."""
    if x.device.type == "cpu":
        return int8_matmul_fused_plain(x, None, bias, out_dtype, eps, (wq, sw))
    bias = None if bias is None else bias.float().contiguous()
    return int8_matmul_fused_cuda(x.contiguous(), wq, sw, bias, out_dtype, eps)


# the op a trace records; eager calls skip its dispatch
torch.library.custom_op("fddm::int8_matmul_fused", _fused, mutates_args=()).register_fake(
    lambda x, wq, sw, bias, out_dtype, eps: x.new_empty((*x.shape[:-1], wq.shape[0]),
                                                         dtype=out_dtype))


def int8_matmul_fused(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.bfloat16, eps: float = EPS,
                      wq_sw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """Fused-quantization variant of `int8_matmul` (same numerics), routed
    by x's device: CPU -> `int8_matmul_fused_plain`, CUDA -> the kernel or
    raise; a trace records `torch.ops.fddm.int8_matmul_fused`.  weight
    [dout, din] full precision, or `wq_sw` its quantization."""
    wq, sw = wq_sw if wq_sw is not None else quantized_weight({}, "w", weight)
    if _build.tracing():
        return torch.ops.fddm.int8_matmul_fused(x, wq, sw, bias, out_dtype, eps)
    return _fused(x, wq, sw, bias, out_dtype, eps)


def quantized_linear(mode: str, cache: Dict[str, tuple], key: str, x: torch.Tensor,
                     weight: torch.Tensor, bias: Optional[torch.Tensor],
                     out_dtype: torch.dtype, rows: Optional[slice] = None) -> torch.Tensor:
    """`F.linear(x, weight[rows], bias[rows])` through int8: `mode` "int8"
    (unfused) or "int8_fused" (the kernel).  Inference only: no gradient is
    defined through the rounding, so it raises where autograd records."""
    if torch.is_grad_enabled():
        raise RuntimeError("quant_dense is inference only: call the model under "
                           "torch.no_grad() or torch.inference_mode(), or set quant_dense: none")
    wq_sw = quantized_weight(cache, key, weight, rows)
    if bias is not None and rows is not None:
        bias = bias[rows]
    fn = int8_matmul_fused if mode == "int8_fused" else int8_matmul
    return fn(x, weight, bias, out_dtype, wq_sw=wq_sw)


def quantized_linear_row_parallel(cache: Dict[str, tuple], key: str, x: torch.Tensor,
                                  weight: torch.Tensor, bias: Optional[torch.Tensor],
                                  out_dtype: torch.dtype, group) -> torch.Tensor:
    """A row-parallel layer through int8 (tensor parallelism,
    `parallel/tensor.py`): `x` [..., din / M] and `weight` [dout, din / M]
    are this rank's input features.  The per-channel weight amax and the
    per-row activation amax are maxima over "model" (`group`), so every
    rank quantizes its slice with the scales of the whole row; the int32
    partial products are summed over "model" (exact), and the f32 epilogue
    `(acc * sx) * sw + bias` runs once on the sum: the integers and the
    result of one process.  The product is the library's (`int8` mode) under
    "int8" and "int8_fused" alike: the fused kernel finds each row's scale
    inside one launch, from the rank's slice alone.  Inference only, as
    `quantized_linear`."""
    from fddm_asr_tpu_torch.parallel.distributed import _all_reduce_flat

    if torch.is_grad_enabled():
        raise RuntimeError("quant_dense is inference only: call the model under "
                           "torch.no_grad() or torch.inference_mode(), or set quant_dense: none")
    MAX, SUM = torch.distributed.ReduceOp.MAX, torch.distributed.ReduceOp.SUM
    stamp = (weight._version, weight.device, weight.data_ptr())
    hit = cache.get(key)
    if hit is not None and hit[0] == stamp:
        wq, sw = hit[1], hit[2]
    else:
        w = weight.detach().float()
        amax = _all_reduce_flat(w.abs().amax(dim=-1).contiguous(), group, MAX)
        sw = amax.clamp(min=EPS) * (1.0 / 127.0)
        wq = torch.round(w / sw[:, None]).clamp(-127.0, 127.0).to(torch.int8).contiguous()
        cache[key] = (stamp, wq, sw)
    lead, dout = x.shape[:-1], wq.shape[0]
    xf = x.reshape(-1, x.shape[-1]).float()
    if xf.shape[0] == 0:  # the same on every rank: no collective is skipped alone
        return x.new_zeros((*lead, dout), dtype=out_dtype)
    amax = _all_reduce_flat(xf.abs().amax(dim=-1).contiguous(), group, MAX)
    sx = amax.clamp(min=EPS)[:, None] * (1.0 / 127.0)
    xq = torch.round(xf / sx).clamp(-127.0, 127.0).to(torch.int8)
    product = _exact_int_product if x.device.type == "cpu" else _int_mm_product
    acc = product(xq, wq)
    acc = _all_reduce_flat(acc.to(torch.int32).contiguous(), group, SUM)
    y = acc.float() * sx * sw
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*lead, dout)

