# -*- coding: utf-8 -*-
"""Micro-benchmark of the WavLM conv front-end's variants.

    python -m fddm_asr_tpu_torch.scripts.profile_frontend [--batch 16] [--seconds 20] \\
        [--per-layer] [--device cpu]

Counterpart of `scripts/profile_frontend.py`: times the 7-layer conv stack
(WavLM-large's geometry, a --batch x --seconds waveform, bf16, random
weights from a seed) under LayerNorm statistics in f32 (as the model) or
bf16 and exact erf or tanh GELU, the convs alone, and the convs as sums of
strided per-tap matmuls (`conv_mm`; layer 1, one input channel, stays a
conv), and prints each variant's least time of 5 (CUDA events on the card)
and its max|Δ| and mean|Δ| against "f32stats_erf (current)".
`dispatch_overhead` times a near-empty op the same way; --per-layer times
each conv layer alone at its input shape, as a conv and as matmuls.  The
fused conv + LayerNorm + GELU kernel is timed by `chip_smoke.py`'s phase 8,
not here.  Runs on CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

__all__ = ["make_params", "layer", "frontend", "conv_mm", "layer_mm", "frontend_mm", "time_fn",
           "main"]

CONV_DIM = (512,) * 7
CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)
EPS = 1e-5
VARIANTS = {
    "conv_only": dict(stats_dtype=torch.float32, gelu_approx=False, with_ln=False,
                      with_gelu=False),
    "conv_gelu_only": dict(stats_dtype=torch.float32, gelu_approx=False, with_ln=False),
    "f32stats_erf (current)": dict(stats_dtype=torch.float32, gelu_approx=False),
    "f32stats_tanh": dict(stats_dtype=torch.float32, gelu_approx=True),
    "bf16stats_erf": dict(stats_dtype=torch.bfloat16, gelu_approx=False),
    "bf16stats_tanh": dict(stats_dtype=torch.bfloat16, gelu_approx=True),
}
Params = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


def make_params(generator: torch.Generator, device) -> Params:
    """(w [k, cin, cout], b, scale, shift) of each layer in bf16: w drawn
    0.05 N(0, 1), b and shift 0, scale 1."""
    params, cin = [], 1
    for dim, k in zip(CONV_DIM, CONV_KERNEL):
        w = (torch.randn(k, cin, dim, generator=generator, device=device) * 0.05
             ).to(torch.bfloat16)
        params.append((w, torch.zeros(dim, dtype=torch.bfloat16, device=device),
                       torch.ones(dim, dtype=torch.bfloat16, device=device),
                       torch.zeros(dim, dtype=torch.bfloat16, device=device)))
        cin = dim
    return params


def ln(x: torch.Tensor, scale, shift, stats_dtype) -> torch.Tensor:
    xs = x.to(stats_dtype)
    m = xs.mean(dim=-1, keepdim=True)
    var = (xs * xs).mean(dim=-1, keepdim=True) - m * m
    y = (xs - m) * torch.rsqrt(var + EPS)
    return (y * scale.to(stats_dtype) + shift.to(stats_dtype)).to(x.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """[B, L, cin] conv [k, cin, cout] (VALID) in bf16, then + b."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + b


def _gelu(x: torch.Tensor, approx: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approx else "none")


def layer(x: torch.Tensor, p, stride: int, *, stats_dtype, gelu_approx: bool,
          with_ln: bool = True, with_gelu: bool = True) -> torch.Tensor:
    """One layer of `frontend`: conv, LayerNorm, GELU (each optional)."""
    w, b, scale, shift = p
    x = _conv(x, w, b, stride)
    if with_ln:
        x = ln(x, scale, shift, stats_dtype)
    if with_gelu:
        x = _gelu(x, gelu_approx)
    return x


def frontend(params: Params, wave: torch.Tensor, **kw) -> torch.Tensor:
    """The stack on `wave` [B, T]; `kw`: `layer`'s variant flags."""
    x = wave[..., None].to(torch.bfloat16)
    for p, s in zip(params, CONV_STRIDE):
        x = layer(x, p, s, **kw)
    return x


def conv_mm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """The conv as a sum of strided matmuls, y = sum_j x[:, j::s] @ w[j]:
    each tap a plain [B*L, C] x [C, D] matmul over a strided view, its
    result rounded to bf16 before the sum."""
    k = w.shape[0]
    L_out = (x.shape[1] - k) // stride + 1
    y = None
    for j in range(k):
        t = torch.matmul(x[:, j:j + (L_out - 1) * stride + 1:stride], w[j])
        y = t if y is None else y + t
    return y + b


def layer_mm(x: torch.Tensor, p, stride: int, *, gelu_approx: bool,
             first: bool = False) -> torch.Tensor:
    """One layer of `frontend_mm`: the first (cin = 1: the conv moves few
    bytes) stays a conv, the others are `conv_mm`; f32 LayerNorm statistics."""
    w, b, scale, shift = p
    x = _conv(x, w, b, stride) if first else conv_mm(x, w, b, stride)
    return _gelu(ln(x, scale, shift, torch.float32), gelu_approx)


def frontend_mm(params: Params, wave: torch.Tensor, *, gelu_approx: bool) -> torch.Tensor:
    x = wave[..., None].to(torch.bfloat16)
    for i, (p, s) in enumerate(zip(params, CONV_STRIDE)):
        x = layer_mm(x, p, s, gelu_approx=gelu_approx, first=i == 0)
    return x


@torch.inference_mode()
def time_fn(fn: Callable, *args, iters: int = 5):
    """(the least time of `iters` calls in seconds, the output of a first
    untimed call): CUDA events around each call on the card, the host's
    clock after each call elsewhere."""
    out = fn(*args)
    cuda = out.device.type == "cuda"
    times = []
    for _ in range(iters):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return min(times), out


def per_layer(params: Params, wave: torch.Tensor) -> None:
    """Time each conv layer alone on its real input shape."""
    x = wave[..., None].to(torch.bfloat16)
    for i, ((w, b, _, _), s) in enumerate(zip(params, CONV_STRIDE)):
        dt, out = time_fn(functools.partial(_conv, w=w, b=b, stride=s), x)
        dt_mm = float("nan") if i == 0 else time_fn(
            functools.partial(conv_mm, w=w, b=b, stride=s), x)[0]
        print(f"  conv{i} in={tuple(x.shape)} k={w.shape[0]} s={s}: "
              f"conv {dt * 1e3:7.2f} ms   mm {dt_mm * 1e3:7.2f} ms")
        x = out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--per-layer", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.config import resolve_device

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = make_params(gen, dev)
    wave = torch.randn(args.batch, int(args.seconds * 16000), generator=gen, device=dev) * 0.1
    times = {}

    # dispatch overhead: a near-empty op, timed the same way
    overhead, _ = time_fn(lambda x: x[:, :8, :] + 1.0, wave[..., None])
    times["dispatch_overhead"] = overhead
    print(f"{'dispatch_overhead':26s} {overhead * 1e3:8.2f} ms")
    if args.per_layer:
        per_layer(params, wave)
    for name, approx in (("mm_frontend_erf", False), ("mm_frontend_tanh", True)):
        dt, _ = time_fn(functools.partial(frontend_mm, gelu_approx=approx), params, wave)
        times[name] = dt
        print(f"{name:26s} {dt * 1e3:8.2f} ms")
    ref = None
    for name, kw in VARIANTS.items():
        dt, out = time_fn(functools.partial(frontend, **kw), params, wave)
        times[name] = dt
        if name == "f32stats_erf (current)":
            ref = out.float()
        err = ""
        if ref is not None and kw.get("with_ln", True) and kw.get("with_gelu", True):
            diff = (out.float() - ref).abs()
            err = f"  max|Δ|={diff.max().item():.3e} mean|Δ|={diff.mean().item():.3e}"
        print(f"{name:26s} {dt * 1e3:8.2f} ms{err}")
    return times


if __name__ == "__main__":
    main()
