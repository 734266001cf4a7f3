# -*- coding: utf-8 -*-
"""Fused conv1d + LayerNorm + GELU of the WavLM feature extractor ("layer"
norm): the Hopper kernel and its plain version.

Counterpart of `fddm_asr_tpu/ops/conv_frontend.py`.  Operands keep the JAX
package's layout: x [B, T, Cin] channels-last, w [k, Cin, Cout], conv bias
`b` [Cout] or None, `ln_scale` and `ln_bias` [Cout]; out [B, T_out, Cout]
in x's dtype with T_out = (T - k) // stride + 1 (VALID), empty when T < k.

    y   = patches(x) @ w.reshape(k * Cin, Cout) + b       f32 accumulate
    out = gelu(layer_norm(y) * ln_scale + ln_bias)        f32, one cast at the end

`conv_ln_gelu_plain` is that arithmetic in plain PyTorch (w rounded to x's
dtype, as the kernel's operand is).  The unfused layer (`F.conv1d`, then
LayerNorm, then GELU; the JAX package's `conv_ln_gelu_xla`) rounds the conv
output to x's dtype before the LayerNorm, so in bfloat16 the fused and the
unfused front-end differ by that rounding, in JAX as here; in float32 they
agree to summation order.

`conv_ln_gelu` routes by x's device and nothing else: CPU -> the plain
version, CUDA -> `csrc/conv_ln_gelu.cu` or raise.  The kernel is forward
only, as the Pallas call is: where autograd records, it raises.  It takes
Cin and Cout in multiples of 8, Cout up to 512 and, in bfloat16, kernel
widths up to `MAX_TAPS` (a tensor map a tap, over x's rows j, j + s, ...);
the waveform layer (Cin = 1) is outside that, as it is outside the TPU kernel
on hardware (Cin % 128 != 0 goes to XLA there), and stays on `F.conv1d` +
LayerNorm + GELU in `models/wavlm.py`.

In float32 every shape it takes runs as 3xTF32 on the tensor cores: the
kernel reads the weight as `tf32_split_weight` lays it out (K-major, split
into tf32 hi and lo), which `kernel_weight_tf32` makes once per version of
a layer's weight; a call without it splits `w` itself.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from fddm_asr_tpu_torch.ops import _build

MAX_COUT = 512  # a 2-CTA cluster owns a whole row of channels (LayerNorm)
MAX_TAPS = 16   # the bf16 kernel's tensor maps, one a tap, in its parameters

_build.register("fddm_conv_ln_gelu_bf16", "conv_ln_gelu",
                [_build.P] * 6 + [_build.I] * 7 + [_build.F])
_build.register("fddm_conv_ln_gelu_f32", "conv_ln_gelu",
                [_build.P] * 6 + [_build.I] * 7 + [_build.F])
_build.register("fddm_conv_ln_gelu_tf32_weight_map", "conv_ln_gelu",
                [_build.P, _build.I, _build.I, _build.P])


def kernel_takes(cin: int, cout: int) -> bool:
    """Whether the CUDA kernel takes a layer of these channel counts."""
    return cin % 8 == 0 and cout % 8 == 0 and 0 < cout <= MAX_COUT


def _out_length(T: int, k: int, stride: int) -> int:
    return (T - k) // stride + 1 if T >= k else 0


def _kept(cache: Dict[str, tuple], key: str, weight: torch.Tensor, dtype: torch.dtype,
          make) -> torch.Tensor:
    """`make()`, kept in `cache[key]` while the weight's version counter,
    device and storage stay what they were when it was made; under a trace
    (`_build.tracing()`) a step of the program, where the weight is an
    input, and not kept."""
    if _build.tracing():
        return make()
    stamp = (weight._version, weight.device, weight.data_ptr(), dtype)
    hit = cache.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    out = make()
    cache[key] = (stamp, out)
    return out


def kernel_weight(cache: Dict[str, tuple], weight: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """An `nn.Conv1d` weight [Cout, Cin, k] as the kernel's operand: w [k,
    Cin, Cout] in `dtype`, contiguous.  `cache` is a dict the calling module
    owns; the copy is reused while the weight's version counter, device and
    storage stay what they were when it was made, so a call casts nothing.
    Under a trace (`_build.tracing()`) the cast is a step of the program,
    where the weight is an input, and nothing is cached."""
    return _kept(cache, "w", weight, dtype,
                 lambda: weight.detach().permute(2, 1, 0).to(dtype).contiguous())


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to tf32, 10 mantissa bits, ties away from zero:
    the kernel's (bits + 0x1000) & 0xffffe000 on the bit pattern (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_weight(w: torch.Tensor) -> torch.Tensor:
    """w [k, Cin, Cout] as the float32 kernel reads it: K-major [Cout, k *
    Cin] (column j * Cin + ci, the order of a patch row), split into tf32 hi
    = rna(w) and lo = rna(w - hi), stacked as [2, Cout, k * Cin] float32."""
    k, cin, cout = w.shape
    wt = w.detach().float().permute(2, 0, 1).reshape(cout, k * cin)
    hi = tf32_rna(wt)
    return torch.stack([hi, tf32_rna(wt - hi)])


def kernel_weight_tf32(cache: Dict[str, tuple], weight: torch.Tensor) -> torch.Tensor:
    """An `nn.Conv1d` weight [Cout, Cin, k] as the float32 kernel's operand
    (`tf32_split_weight`), made once per version of the weight and kept in
    `cache` as `kernel_weight` keeps its copy."""
    return _kept(cache, "w_tf32", weight, torch.float32,
                 lambda: tf32_split_weight(weight.permute(2, 1, 0)))


def conv_ln_gelu_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                       ln_scale: torch.Tensor, ln_bias: torch.Tensor, stride: int,
                       eps: float = 1e-5, gelu_tanh: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: f32 product of the
    patches with w (rounded to x's dtype), + bias, f32 LayerNorm (two-pass
    variance), f32 GELU, one cast.  The CPU path, the tests' reference and
    `chip_smoke.py`'s comparison."""
    B, T, Cin = x.shape
    k, _, Cout = w.shape
    T_out = _out_length(T, k, stride)
    if T_out == 0:
        return x.new_zeros((B, 0, Cout))
    # [B, T_out, Cin, k] -> [B, T_out, k * Cin]: the contiguous span from row t * stride
    patches = x.unfold(1, k, stride).permute(0, 1, 3, 2).reshape(B, T_out, k * Cin)
    y = patches.float() @ w.to(x.dtype).float().reshape(k * Cin, Cout)
    if b is not None:
        y = y + b.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + eps)
    y = y * ln_scale.float() + ln_bias.float()
    return F.gelu(y, approximate="tanh" if gelu_tanh else "none").to(x.dtype)


def conv_ln_gelu_cuda(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                      ln_scale: torch.Tensor, ln_bias: torch.Tensor, stride: int,
                      eps: float = 1e-5, gelu_tanh: bool = False,
                      w_tf32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B8: launch the fused kernel on CUDA tensors (raises on anything else).
    Adds one to `conv_ln_gelu_cuda.launches` per launch; an input shorter
    than the kernel width returns an empty tensor without one.  In float32
    the kernel reads `w_tf32`, `tf32_split_weight(w)` (made here when it is
    None), whose tensor map is encoded on its first call and kept."""
    if x.device.type != "cuda":
        raise ValueError(f"the conv+LayerNorm+GELU kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"the conv+LayerNorm+GELU kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"expected x [B, T, Cin] and w [k, Cin, Cout], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, T, Cin = x.shape
    k, _, Cout = w.shape
    if not kernel_takes(Cin, Cout):
        raise ValueError(f"the conv+LayerNorm+GELU kernel takes Cin and Cout in multiples of "
                         f"8 and Cout <= {MAX_COUT}; got Cin={Cin}, Cout={Cout}")
    if stride < 1:
        raise ValueError(f"stride must be positive, got {stride}")
    if x.dtype == torch.bfloat16 and k > MAX_TAPS:
        raise ValueError(f"the bfloat16 conv+LayerNorm+GELU kernel takes kernel widths up to "
                         f"{MAX_TAPS}; got {k}")
    T_out = _out_length(T, k, stride)
    if B == 0 or T_out == 0:
        return x.new_zeros((B, T_out, Cout))
    dev = x.device
    params = [None if p is None else p.float().contiguous() for p in (b, ln_scale, ln_bias)]
    _build.check_tensor("x", x, (B, T, Cin), x.dtype, dev)
    for name, p in zip(("b", "ln_scale", "ln_bias"), params):
        if p is not None:
            _build.check_tensor(name, p, (Cout,), torch.float32, dev)
    if x.dtype == torch.float32:
        if w_tf32 is None:
            w_tf32 = tf32_split_weight(w)
        _build.check_tensor("w_tf32", w_tf32, (2, Cout, k * Cin), torch.float32, dev)
        fn, w_arg = "fddm_conv_ln_gelu_f32", _build.kept_tensor_maps(
            "fddm_conv_ln_gelu_tf32_weight_map", dev, 1, w_tf32.data_ptr(), Cout, k * Cin)
    else:
        w2 = w.to(x.dtype).reshape(k * Cin, Cout).contiguous()
        _build.check_tensor("w", w2, (k * Cin, Cout), x.dtype, dev)
        fn, w_arg = "fddm_conv_ln_gelu_bf16", w2.data_ptr()
    out = torch.empty(B, T_out, Cout, device=dev, dtype=x.dtype)
    _build.launch(fn, dev, x.data_ptr(), w_arg, _build.ptr(params[0]), params[1].data_ptr(),
                  params[2].data_ptr(), out.data_ptr(), B, T, Cin, Cout, k, stride,
                  int(gelu_tanh), eps)
    conv_ln_gelu_cuda.launches += 1
    return out


conv_ln_gelu_cuda.launches = 0


def _routed(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], ln_scale: torch.Tensor,
            ln_bias: torch.Tensor, stride: int, eps: float, gelu_tanh: bool,
            w_tf32: Optional[torch.Tensor]) -> torch.Tensor:
    """B8 on x's device: CPU -> the plain version, CUDA -> the kernel."""
    if x.device.type == "cpu":
        return conv_ln_gelu_plain(x, w, b, ln_scale, ln_bias, stride, eps, gelu_tanh)
    return conv_ln_gelu_cuda(x.contiguous(), w, b, ln_scale, ln_bias, stride, eps, gelu_tanh,
                             w_tf32)


# the op a trace records; eager calls skip its dispatch
torch.library.custom_op("fddm::conv_ln_gelu", _routed, mutates_args=()).register_fake(
    lambda x, w, b, ln_scale, ln_bias, stride, eps, gelu_tanh, w_tf32: x.new_empty(
        (x.shape[0], _out_length(x.shape[1], w.shape[0], stride), w.shape[2])))


def conv_ln_gelu(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 ln_scale: torch.Tensor, ln_bias: torch.Tensor, stride: int,
                 eps: float = 1e-5, gelu_tanh: bool = False,
                 w_tf32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on x's device: CPU -> plain version, CUDA -> kernel or raise;
    a trace records `torch.ops.fddm.conv_ln_gelu`.  Forward only: raises
    where autograd records.  `w_tf32`: the float32 kernel's operand of w
    (`kernel_weight_tf32`), or None."""
    if torch.is_grad_enabled():
        raise RuntimeError("the fused conv front-end is forward only: call it under "
                           "torch.no_grad() or torch.inference_mode() (in training, with "
                           "freeze_feature_extractor), or set fused_frontend: false")
    if _build.tracing():
        return torch.ops.fddm.conv_ln_gelu(x, w, b, ln_scale, ln_bias, stride, eps, gelu_tanh,
                                           w_tf32)
    return _routed(x, w, b, ln_scale, ln_bias, stride, eps, gelu_tanh, w_tf32)
