#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""GPU smoke run of the PyTorch/CUDA port: builds the kernels, holds each
against its plain version, transcribes a batch (in full precision, and with
the int8 encoder and the fused conv front-end) and takes encoder fine-tune
steps at full model width.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernel is built for sm_90a) and nvcc; imports
only the port (`fddm_asr_tpu_torch`), torch, numpy and the standard library.
Phases, each fatal on failure:

  1. the card's name and power limit (nvidia-smi); build every kernel
     from `fddm_asr_tpu_torch/csrc/` with nvcc (one process per source, in
     parallel), timed;
  2. kernel vs plain version at B=8, H=16, dh=64 on both sides of the TPU
     kernels' 4096-frame split (L=1024, 4224), float32 and bfloat16, with
     ragged key masks and one all-masked row; the kernel's time beside the
     plain version's, one `scaled_dot_product_attention` call's (a yardstick
     the port never calls) and the card's least possible time (bound);
     then, untimed, at the edges of the bf16 kernel's 128-query blocks and
     64-key steps and at L=203 (bias rows not 16-byte aligned), with lse;
  3. a small float32 pipeline (64-wide WavLM heads) transcribes the same
     batch and x_T on the card and on the CPU from the same weights: the
     token ids must be identical; the same with the batch as int16 pcm16
     and as uint8 mu-law codes (decoded on the pipeline's device);
  4. full-width transcription: WavLM-large + the d768x6 decoder, K=8000,
     T=200, bf16, random weights from a seeded generator and a synthetic
     8000-piece tokenizer; 8 x 20 s of synthetic audio through
     `FDDMPipeline.transcribe_with_ids` (T_infer=20, r=5, exact, greedy,
     seq_len=64) with the kernel's launch count checked at 24 per encode;
     the encoder's output with the kernel held against the same encoder
     with the plain attention; one more transcribe under torch.profiler
     for the device time by kernel and the device's idle share;
  5. the training kernels (B3 forward + logsumexp, B4 dq/dgate, B5
     dk/dv/dbias) against their plain versions and against autograd of the
     plain forward: first at the shape phase 7 gives them (B=32, H=16,
     dh=64, L=1024 with 999 valid keys in every row, bfloat16), then at
     B=8, L=1024, 384, 203, float32 and bfloat16, ragged key masks and one
     all-masked row, then untimed at the edges of B5's tiles (L = 65, 127,
     128, 129, 203, 1000, 1024; B=1 and B=3, bfloat16); B5 is called twice
     each time and its outputs must agree bit for bit; at L=1024 each
     kernel's time beside the plain
     version's, a library yardstick (one `scaled_dot_product_attention`
     call, and autograd of it for the backward pair; the port calls
     neither) and the bound; the kernels line takes the B=32 numbers;
  6. a small float32 encoder fine-tune step (64-wide WavLM heads, so
     attention takes the kernels) on the card and on the CPU from the same
     weights and the same injected t, x_t and time mask: loss, pre-clip
     gradient norm, every gradient, the updated parameters and the
     kernels' launch counts;
  7. full-width encoder fine-tune (configs/fddm_zhTW_finetune.yaml over
     fddm_zhTW_base.yaml: WavLM-large trained with remat, SpecAugment time
     masks and a frozen conv front-end, d768x6 decoder, K=8000, T=200,
     bf16, AdamW in two groups, EMA, L_fd every 4 steps), random weights,
     32 x 20 s of synthetic audio with random 128-token targets: two
     warm-up steps (with and without L_fd), then one L_fd period of 4
     timed steps with the kernels' launches checked per step (B3 47, B4
     24, B5 24 with 23 of 24 layers recomputed), peak memory, one more
     step under torch.profiler (each port kernel's time per launch there
     beside phase 5's, B5's two kernels by name); the loss finite, encoder and decoder
     weights moved, the conv front-end's not;
  8. the fused int8 matmul (B7) against its plain version at M = 8192 rows
     for WavLM-large's three dense shapes (1024x1024, 1024x4096,
     4096x1024), bfloat16 and float32, with and without bias, and at a
     ragged size (51 rows, dout 136): the integers are exact in both, so the
     outputs must agree within one ulp of the output type; its time beside
     the plain version's, the library path's (row quantization in torch +
     `torch._int_mm` + epilogue, the port's own `int8` mode) and the bound;
  9. the fused conv+LayerNorm+GELU (B8) against its plain version at B = 8,
     512 channels, (k, s) = (3, 2) at T = 63999 and (2, 2) at T = 1999,
     bfloat16 (3e-2 abs + one bf16 ulp of the value: outputs reach past 4,
     where an ulp is 0.03125) and float32 (2e-4 abs + 1e-3 rel), erf and tanh,
     and at inputs that give no and one output row; its time beside the
     plain version's, `F.conv1d` + `F.layer_norm` + `F.gelu`'s and the bound;
 10. `wavlm_gated_attention` on [B, L, H, dh] operands (B6's entry point,
     which no model path reaches, as in the JAX package): driven once
     through the dispatcher with its count read, held against its plain
     version at B = 8, L = 1024, H = 16 in both types, and timed;
 11. a small float32 pipeline under `quant_dense: int8_fused`,
     `fused_frontend: true` and `model.quant_dense: int8` (128 conv
     channels, 64-wide heads) on the card and on the CPU from the same
     weights, with the launches of B1, B7 and B8 checked.  A value whose
     scaled size falls within f32 rounding of a half rounds to another
     integer on the card than on the CPU (sums run in another order), and
     one such step is 1/127 of a row's largest value; so the pass rule,
     fixed before the first run, is the encoder's output within 5e-2 max
     abs (unit-scale output; a fault gives O(1)); the token ids are
     compared and printed, with the CPU's top-two probability margin where
     they differ, and do not decide;
 12. full-width transcription as in phase 4 under `encoder.wavlm_config:
     {quant_dense: int8_fused, fused_frontend: true, gelu_approx_tanh:
     true}` with the launches checked (B1 24, B7 144, B8 6), wall median,
     RTFx, peak memory and one profiled run (`transcribe_int8_fused`), and
     the same under `quant_dense: int8` (the library path,
     `transcribe_int8`) and `quant_dense: none` (`transcribe_fused_frontend`:
     the front-end and tanh GELU alone), and phase 4's own configuration
     once more (`transcribe_repeat`: the wall times of this phase compare
     with it, not with phase 4's, because the host's share grows over the
     process); the encoder's output under int8_fused against that
     full-precision encoder: rel-L2 below 0.05 and above 1e-6 (the flag
     must change the output).

Phases 4 and 7 run at full depth with as many timed runs as before: the
whole takes well under half of its time limit, so nothing was cut.

Prints the kernels' JSON line, then the card line, then as the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                                 # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / f32 (no TF32)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}          # unit-scale inputs
ENCODER_REL_L2_TOL = 5e-2  # bf16 P rounding differs (kernel: before the 1/l, plain: after), 24 layers
# backward kernels, as a fraction of the reference's max-abs: against the
# plain backward (same rounding points) and against autograd of the plain
# forward (which keeps dS in f32 but rounds dO.V^T to bf16)
BWD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
AUTOGRAD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
LSE_TOL = 1e-3             # the row logsumexp, f32 in both
EDGE_LENGTHS = (65, 128, 129, 203, 1000)  # phase 2's untimed block-edge lengths
# phase 5's: the edges of B5's 128-key, 128-query and 64-row tiles, and bias
# rows that are not 16-byte aligned (127, 129, 203)
B5_EDGE_LENGTHS = (65, 127, 128, 129, 203, 1000, 1024)
SMALL_STEP_REL_TOL = 1e-4  # f32 fine-tune step, card vs CPU, of the largest gradient
FINETUNE_B, FINETUNE_SECONDS, FINETUNE_TOKENS = 32, 20.0, 128
TIMED_STEPS = 4            # one L_fd period
REPEATS = 5                # timed transcribes after the counted one; their median is reported
SMALL_ENCODER_TOL = 1e-3   # float32, two layers; card and CPU sum in different orders
INT8_PEAK_OPS = 1979e12    # H100 SXM dense int8
# (abs, rel); bfloat16: 3e-2 plus one bf16 ulp of the reference, whose values reach past 4
CONV_TOL = {torch.float32: (2e-4, 1e-3), torch.bfloat16: (3e-2, 2.0 ** -7)}
SMALL_QUANT_ENCODER_TOL = 5e-2  # phase 11: int8 steps flip at f32 rounding of a half
QUANT_REL_L2 = (1e-6, 5e-2)     # int8 encoder vs full precision: must differ, and little
WAVLM_DENSE_SHAPES = ((1024, 1024), (1024, 4096), (4096, 1024))  # (din, dout): 4 + 1 + 1 a layer
FUSED_WAVLM_CONFIG = {"quant_dense": "int8_fused", "fused_frontend": True,
                      "gelu_approx_tanh": True}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def seconds_of(fn, n: int) -> list:
    """Host wall seconds of `n` calls of `fn`, each ended by a synchronize."""
    out = []
    for _ in range(n):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        out.append(time.time() - t0)
    return out


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_inputs(B, L, H, dtype, gen, ragged=True, valid=None):
    """Unit-scale q/k/v/bias, gates in [1, 2) and a key mask: ragged (row b
    keeps L - 97 b keys, the last row none) or, with `valid`, the first
    `valid` keys of every row, as a batch of equal-length utterances padded
    to L."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    q, k, v = randn(B, L, H * 64), randn(B, L, H * 64), randn(B, L, H * 64)
    bias = randn(H, L, L)
    gate = torch.rand(B, H, L, device=dev, generator=gen) + 1.0
    mask = torch.ones(B, L, dtype=torch.bool, device=dev)
    if valid is not None:
        mask[:, valid:] = False
    elif ragged:
        for b in range(B - 1):
            mask[b, L - 97 * b:] = False
        mask[B - 1] = False  # an all-masked row
    return q, k, v, bias, gate, mask


def attention_bound_ms(q, bias, gate, mask, H) -> tuple:
    """The least time on the card: each input read once and the output
    written once over HBM, or the products the inputs need (a row with
    kept keys needs q.k and p.v over them; an all-masked row only the mean
    of v, once) at the dense peak of q's type; the larger of the two."""
    B, L, HD = q.shape
    es = q.element_size()
    nbytes = 4 * B * L * HD * es + bias.numel() * es + gate.numel() * 4 + mask.numel()
    kept = mask.sum(dim=1).tolist()
    ops = sum(4 * H * L * 64 * n if n else L * HD for n in kept)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_vs_plain(FA, L: int, dtype, gen) -> dict:
    B, H = 8, 16
    q, k, v, bias, gate, mask = attention_inputs(B, L, H, dtype, gen)
    out = FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, num_heads=H)
    torch.cuda.synchronize()
    ref = FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, num_heads=H)
    err = (out.float() - ref.float()).abs()
    del out, ref
    if not torch.isfinite(err).all():
        fail(f"kernel output not finite at L={L} {dtype}")
    row = {"L": L, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
           "tol": TOL[dtype]}
    del err
    reps = 20 if L <= 1024 else 5
    row["ms"] = time_ms(lambda: FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, H), reps)
    row["plain_ms"] = time_ms(
        lambda: FA.wavlm_gated_attention_plain(q, k, v, bias, gate, mask, H), max(2, reps // 4), 1)
    # yardstick: one library call over the same function (mask built outside the timing)
    float_mask = (gate[..., None] * bias[None].float()).masked_fill(
        ~mask[:, None, None, :], torch.finfo(torch.float32).min).to(dtype)
    heads = [x.view(B, L, H, 64).transpose(1, 2) for x in (q, k, v)]
    row["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(*heads, attn_mask=float_mask),
        max(2, reps // 4), 1)
    del float_mask
    row["bound_ms"], row["bound_by"] = attention_bound_ms(q, bias, gate, mask, H)
    print(json.dumps({"kernel_vs_plain": row}), flush=True)
    if not row["max_abs_err"] <= TOL[dtype]:
        fail(f"kernel disagrees with its plain version at L={L} {dtype}: {row}")
    torch.cuda.empty_cache()
    return row


def edge_lengths_match_plain(FA, gen) -> list:
    """Phase 2, untimed: the forward kernel at the edges of the bf16 kernel's
    128-query blocks and 64-key steps (65, 128, 129, 1000) and at an L whose
    bias rows are not 16-byte aligned (203), B=3 (a ragged, a full and an
    all-masked row), both types: out within TOL, lse within LSE_TOL and
    exactly f32-min at the all-masked row, and the inference launch's output
    bit-identical to the lse launch's."""
    rows = []
    for L in EDGE_LENGTHS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias, gate, mask = attention_inputs(3, L, 16, dtype, gen)
            out, lse = FA.wavlm_gated_attention_fwd_lse_cuda(q, k, v, bias, gate, mask, 16)
            same = torch.equal(FA.wavlm_gated_attention_cuda(q, k, v, bias, gate, mask, 16), out)
            ref, ref_lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, 16)
            row = {"L": L, "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                   "lse_err": (lse - ref_lse).abs().max().item(), "outputs_identical": same,
                   "lse_all_masked_is_f32_min": bool(
                       (lse[2] == torch.finfo(torch.float32).min).all())}
            rows.append(row)
            if not (row["max_abs_err"] <= TOL[dtype] and row["lse_err"] <= LSE_TOL and same
                    and row["lse_all_masked_is_f32_min"]):
                fail(f"kernel disagrees with its plain version at an edge length: {row}")
    print(json.dumps({"edge_lengths_vs_plain": rows}), flush=True)
    return rows


def synthetic_tokenizer(directory: str, vocab_size: int) -> str:
    """4 specials + single-ideograph pieces (U+4E00..), with the vocab.json
    sidecar that names the special ids."""
    path = os.path.join(directory, "spm_synth.vocab")
    with open(path, "w", encoding="utf-8") as f:
        f.write("<unk>\t0\n<s>\t0\n</s>\t0\n<pad>\t0\n")
        for i in range(vocab_size - 4):
            f.write(f"{chr(0x4E00 + i)}\t{-(i + 1)}\n")
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({"special_token_ids": {"unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": 3}}, f)
    return path


def flagship_config(tokenizer_path: str, wavlm_config: dict = None):
    """configs/fddm_zhTW_base.yaml's model, data and diffusion blocks, in
    code; `wavlm_config` goes under encoder.wavlm_config."""
    from fddm_asr_tpu_torch.config import Config

    cfg = Config({
        "seed": 1337,
        "data": {"vocab_size": 8000, "pad_id": 0, "tokenizer_path": tokenizer_path},
        "model": {"d_model": 768, "nhead": 12, "num_layers": 6, "dim_ff": 2048,
                  "dtype": "bfloat16",
                  "encoder": {"wavlm_name": "microsoft/wavlm-large", "freeze": True,
                              "proj": "linear", "pooling": "none"}},
        "diffusion": {"T": 200, "beta_max": 0.2},
    }).to_dict()
    if wavlm_config:
        cfg["model"]["encoder"]["wavlm_config"] = dict(wavlm_config)
    return Config(cfg)


def synthetic_audio(B: int, seconds: float, seed: int) -> np.ndarray:
    """Voiced-like bursts: harmonic tones under a syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds), dtype=np.float32) / 16000.0
    f0 = rng.uniform(90.0, 250.0, (B, 1)).astype(np.float32)
    wav = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3, 4))
    envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 5.0, (B, 1)) * t))
    wav = 0.1 * wav * envelope + 0.01 * rng.standard_normal((B, t.size))
    return wav.astype(np.float32)


def wire_codes(wav: np.ndarray) -> dict:
    """The batch in the serving path's wire dtypes: int16 pcm16 (x * 32768)
    and uint8 mu-law (mu = 255, u8 = round(127.5 + 127.5 sign(x) ln(1 +
    255|x|) / ln 256)), which the pipeline decodes on its device."""
    x = np.clip(wav, -1.0, 1.0)
    mu = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log(256.0)
    return {"int16": np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16),
            "uint8": np.clip(np.round(127.5 + 127.5 * mu), 0, 255).astype(np.uint8)}


def small_pipeline_matches_cpu(FA, tokenizer_dir: str) -> dict:
    """A small float32 pipeline whose WavLM heads are 64 wide (so attention
    takes the kernel) transcribes the same batch and x_T on the card and on
    the CPU (plain attention, the path the CPU tests hold against the JAX
    package), from the same weights: token ids must be identical; the same
    for the batch as int16 and as uint8 mu-law codes."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    K, B, seq_len = 64, 2, 16
    cfg = Config({
        "seed": 0,
        "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
        "model": {"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192,
                  "dtype": "float32",
                  "encoder": {"wavlm_name": "tiny", "proj": "linear", "wavlm_config": {
                      "hidden_size": 128, "num_attention_heads": 2,
                      "intermediate_size": 256}}},
        "diffusion": {"T": 200, "beta_max": 0.2},
    })
    tok = load_tokenizer(synthetic_tokenizer(tokenizer_dir, K))
    cpu = FDDMPipeline.from_config(cfg, tokenizer=tok, device="cpu")
    gpu = FDDMPipeline.from_config(cfg, tokenizer=tok, device="cuda")
    gpu.decoder.load_state_dict(cpu.decoder.state_dict())
    gpu.encoder.load_state_dict(cpu.encoder.state_dict())
    wav = synthetic_audio(B, 1.0, seed=1)
    wav[1, 8000:] = 0.0
    x_init = np.random.default_rng(2).integers(0, K, (B, seq_len))
    sampling = dict(T_infer=20, r=5, greedy=True, x_init=x_init)
    before = FA.wavlm_gated_attention_cuda.launches
    got = gpu.transcribe_with_ids(wav, seq_len=seq_len, **sampling)
    torch.cuda.synchronize()
    launched = FA.wavlm_gated_attention_cuda.launches - before
    want = cpu.transcribe_with_ids(wav, seq_len=seq_len, **sampling)
    feat_err = (gpu.encode_waveform(wav)[0].cpu() - cpu.encode_waveform(wav)[0]).abs().max().item()
    result = {"frames": gpu.encoder.config.feat_extract_output_length(wav.shape[1]),
              "kernel_launches": launched, "encoder_max_abs_err": feat_err,
              "encoder_tol": SMALL_ENCODER_TOL,
              "ids_equal": [r[1] for r in got] == [r[1] for r in want], "wire": {}}
    for name, codes in wire_codes(wav).items():
        got_w = gpu.transcribe_with_ids(codes, seq_len=seq_len, **sampling)
        want_w = cpu.transcribe_with_ids(codes, seq_len=seq_len, **sampling)
        err_w = (gpu.encode_waveform(codes)[0].cpu() - cpu.encode_waveform(codes)[0]).abs().max()
        result["wire"][name] = {"encoder_max_abs_err": err_w.item(),
                                "ids_equal": [r[1] for r in got_w] == [r[1] for r in want_w]}
    print(json.dumps({"small_pipeline_card_vs_cpu": result}), flush=True)
    for name, row in result["wire"].items():
        if not (row["encoder_max_abs_err"] <= SMALL_ENCODER_TOL and row["ids_equal"]):
            fail(f"small pipeline fed {name} codes, card vs CPU: {row}")
    if launched != 2:
        fail(f"small pipeline launched the kernel {launched} times, expected 2")
    if not feat_err <= SMALL_ENCODER_TOL:
        fail(f"small pipeline encoder, card vs CPU: max abs err {feat_err}")
    if not result["ids_equal"]:
        fail(f"small pipeline token ids differ, card {got} vs CPU {want}")
    return result


def device_time_breakdown(run, wall_s: float) -> dict:
    """One more run under torch.profiler: device time by event name, and the
    device's busy time against the host wall time of the unprofiled run
    (`idle_share`) and of the profiled run itself (`idle_share_profiled`),
    both unclamped.  Busy time is the union of the device events' intervals,
    so time that two events share (a duplicate, an annotation spanning
    kernels, a second stream) counts once; `overlap_ms` is the plain sum of
    event times less the union, `nested_ms` the events that lie wholly
    inside an earlier one, by name, and `containers` the names that hold
    them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        profiled_ms = (time.time() - t0) * 1e3
    spans = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        fail("the profiler saw no device event")
    per_kernel, nested, containers = {}, {}, {}
    busy_us = sum_us = 0.0
    holder = None  # the event reaching furthest so far: (end, name)
    cover_start = cover_end = None
    for start, neg_end, name in spans:
        end = -neg_end
        sum_us += end - start
        per_kernel[name] = per_kernel.get(name, 0.0) + (end - start) / 1e3
        if holder is not None and end <= holder[0]:  # inside an earlier event
            nested[name] = nested.get(name, 0.0) + (end - start) / 1e3
            containers[holder[1]] = containers.get(holder[1], 0) + 1
        else:
            holder = (end, name)
        if cover_end is None or start > cover_end:
            if cover_end is not None:
                busy_us += cover_end - cover_start
            cover_start, cover_end = start, end
        else:
            cover_end = max(cover_end, end)
    busy_us += cover_end - cover_start
    busy_ms = busy_us / 1e3
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return {"device_busy_ms": busy_ms, "event_sum_ms": sum_us / 1e3,
            "overlap_ms": (sum_us - busy_us) / 1e3,
            "nested_ms": dict(sorted(nested.items(), key=lambda kv: -kv[1])[:8]),
            "containers": dict(sorted(containers.items(), key=lambda kv: -kv[1])[:8]),
            "wall_ms": wall_s * 1e3, "idle_share": 1.0 - busy_ms / (wall_s * 1e3),
            "profiled_wall_ms": profiled_ms, "idle_share_profiled": 1.0 - busy_ms / profiled_ms,
            "kernels": len(per_kernel),
            "top": [{"name": n[:90], "ms": ms, "share": ms / busy_ms} for n, ms in ranked[:12]],
            "all": [{"name": n, "ms": ms} for n, ms in ranked]}


def port_kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its launches are
    reported under; each carries a `.launches` count."""
    from fddm_asr_tpu_torch.ops import conv_frontend as CF
    from fddm_asr_tpu_torch.ops import flash_attention as FA
    from fddm_asr_tpu_torch.ops import quant as Q

    return {"fwd": FA.wavlm_gated_attention_cuda, **_training_wrappers(FA),
            "bhld": FA.wavlm_gated_attention_bhld_cuda,
            "int8_matmul_fused": Q.int8_matmul_fused_cuda, "conv_ln_gelu": CF.conv_ln_gelu_cuda}


def transcribe_full_width(FA, tokenizer_dir: str, card: str, name: str = "transcribe",
                          wavlm_config: dict = None, expect: dict = None) -> dict:
    """Phase 4, and under `wavlm_config` phase 12: 8 x 20 s through
    `transcribe_with_ids` at full width; `expect` gives the launches of one
    transcribe for the kernels it runs (every other kernel: none).  Returns
    the result with the pipeline's encoder output under "feats" (not
    printed)."""
    import fddm_asr_tpu_torch.models.wavlm as W
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    B, seconds = 8, 20.0
    cfg = flagship_config(synthetic_tokenizer(tokenizer_dir, 8000), wavlm_config)
    t0 = time.time()
    pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(cfg.data.tokenizer_path))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    n_layers = pipe.encoder.config.num_hidden_layers
    wav = synthetic_audio(B, seconds, seed=0)
    sampling = dict(T_infer=20, r=5, greedy=True, posterior_mode="map", sampling_mode="exact")

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = pipe.transcribe_with_ids(wav, seq_len=64, generator=gen, with_confidence=True,
                                        **sampling)
        torch.cuda.synchronize()
        return rows

    gc.collect()  # the earlier phases' pipelines: not collected during the timed runs
    run()  # warm-up: lazy CUDA/cuBLAS/cuDNN initialisation
    torch.cuda.reset_peak_memory_stats()  # the peak of the transcribe alone, not of phase 2
    wrappers = port_kernel_wrappers()
    for f in wrappers.values():
        f.launches = 0
    rows = run()  # the main path's run: its kernel launches are counted
    counts = {k: f.launches for k, f in wrappers.items()}
    launches = counts["fwd"]
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 0 for k in wrappers}
    want.update(expect or {"fwd": n_layers})
    if counts != want:
        fail(f"kernel launches in one {name} {counts}, expected {want}")
    step_samples = seconds_of(run, REPEATS)

    # where the time goes: encode and sample apart
    encode_samples = seconds_of(lambda: pipe.encode_waveform(wav), REPEATS)
    feats, _ = pipe.encode_waveform(wav)
    sample_samples = seconds_of(lambda: pipe.sample(
        feats, 64, generator=torch.Generator(device="cuda").manual_seed(0), **sampling), REPEATS)
    ids, p = pipe.sample(feats, 64, generator=torch.Generator(device="cuda").manual_seed(0),
                         **sampling)

    S = pipe.encoder.config.feat_extract_output_length(wav.shape[1])
    if tuple(feats.shape) != (B, S, 768) or not torch.isfinite(feats.float()).all():
        fail(f"encoder output {tuple(feats.shape)} not finite or not [{B}, {S}, 768]")
    if len(rows) != B or any(len(r[1]) != 64 for r in rows):
        fail("transcripts are not 8 rows of 64 ids")
    if not all(0 <= i < 8000 for r in rows for i in r[1]) or not torch.isfinite(p).all():
        fail("ids out of range or p_x0 not finite")
    if [r[1] for r in rows] != ids.cpu().tolist():
        fail("transcribe_with_ids and encode_waveform + sample disagree")

    rel_l2 = None
    if not wavlm_config:  # phase 4: the same encoder with the plain attention on the card
        kernel_route = W.wavlm_gated_attention_heads_packed
        W.wavlm_gated_attention_heads_packed = FA.wavlm_gated_attention_plain
        try:
            plain_feats, _ = pipe.encode_waveform(wav)
        finally:
            W.wavlm_gated_attention_heads_packed = kernel_route
        rel_l2 = ((feats.float() - plain_feats.float()).norm()
                  / plain_feats.float().norm()).item()
        if not rel_l2 <= ENCODER_REL_L2_TOL:
            fail(f"encoder with kernel vs plain attention: rel L2 {rel_l2} > {ENCODER_REL_L2_TOL}")

    step_s = statistics.median(step_samples)
    breakdown = device_time_breakdown(run, step_s)
    port_names = {"fwd": "gated_attention_bf16_kernel",
                  "int8_matmul_fused": "int8_matmul_fused_kernel",
                  "conv_ln_gelu": "conv_ln_gelu_bf16_kernel"}
    breakdown["port_kernels_ms"] = {k: sum(t["ms"] for t in breakdown["all"] if n in t["name"])
                                    for k, n in port_names.items() if want[k]}
    del breakdown["all"]
    print(json.dumps({f"{name}_device_time": breakdown}), flush=True)

    result = {
        "card": card, "transcripts": len(rows), "audio_s": B * seconds, "frames": S,
        "step_s": step_s, "rtfx": B * seconds / step_s, "step_s_samples": step_samples,
        "encode_s": statistics.median(encode_samples),
        "sample_s": statistics.median(sample_samples), "repeats": REPEATS,
        "pipeline_build_s": build_s, "kernel_launches": launches,
        "launches": {k: n for k, n in counts.items() if n},
        "wavlm_config": wavlm_config or {},
        "encoder_rel_l2_kernel_vs_plain": rel_l2, "encoder_rel_l2_tol": ENCODER_REL_L2_TOL,
        "example_text": rows[0][0][:16], "example_confidence": rows[0][2],
        "peak_mem_gb": peak_mem_gb,
    }
    print(json.dumps({name: result}, ensure_ascii=False), flush=True)
    result["feats"] = feats
    return result


# ------------------------------------------------------------ training path
TRAIN_KERNELS = ("fwd_lse", "bwd_dq", "bwd_dkv")


def _training_wrappers(FA):
    return {"fwd_lse": FA.wavlm_gated_attention_fwd_lse_cuda,
            "bwd_dq": FA.wavlm_gated_attention_bwd_dq_cuda,
            "bwd_dkv": FA.wavlm_gated_attention_bwd_dkv_cuda}


def _rel_err(got, want) -> tuple:
    """(max abs err, reference max-abs), in float32."""
    want = want.float()
    return (got.float() - want).abs().max().item(), max(want.abs().max().item(), 1e-30)


def training_bounds(q, bias, gate, mask, H) -> dict:
    """The least time of each training kernel at these inputs: bytes (each
    input read once, each output written once) over HBM, or the products
    the data needs (per (query, kept key) pair and head: B3 4*64 for q.k
    and p.v, B4 6*64 for q.k, dO.v and dS.k, B5 8*64 for q.k, dO.v, P^T.dO
    and dS^T.q; a row whose keys are all masked needs no product but B5's
    column sum of dO) at the dense peak of q's type; the larger of the two."""
    B, L, HD = q.shape
    es = q.element_size()
    act = B * L * HD * es                       # one of q, k, v, dO, out, dq, dk, dv
    small = gate.numel() * 4                    # gate, lse, delta, dgate: [B, H, L] f32
    common = bias.numel() * es + mask.numel()
    kept = mask.sum(dim=1).tolist()
    pairs = sum(L * n for n in kept)
    masked_rows = sum(1 for n in kept if n == 0)
    work = {"fwd_lse": (4 * act + common + 2 * small, 4 * 64 * H * pairs),
            "bwd_dq": (5 * act + common + 4 * small, 6 * 64 * H * pairs),
            "bwd_dkv": (6 * act + common + 3 * small + H * L * L * 4,
                        8 * 64 * H * pairs + masked_rows * L * HD)}
    out = {}
    for key, (nbytes, ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS[q.dtype] * 1e3
        out[key] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def training_kernels_vs_plain(FA, L: int, dtype, gen, timed: bool, B: int = 8,
                              valid=None) -> dict:
    """B3, B4, B5 against their plain versions and against autograd of the
    plain forward, with ragged key masks or `valid` keys in every row;
    `timed`: each kernel's time beside the plain version's, a library
    yardstick's and the bound."""
    H = 16
    q, k, v, bias, gate, mask = attention_inputs(B, L, H, dtype, gen, valid=valid)
    dout = torch.randn(B, L, H * 64, device="cuda", generator=gen).to(dtype)
    wrap = _training_wrappers(FA)
    out, lse = wrap["fwd_lse"](q, k, v, bias, gate, mask, H)
    delta = (dout.float() * out.float()).view(B, L, H, 64).sum(-1).transpose(1, 2).contiguous()
    dq, dgate = wrap["bwd_dq"](q, k, v, bias, gate, mask, lse, delta, dout, H)
    dk, dv, dbias = wrap["bwd_dkv"](q, k, v, bias, gate, mask, lse, delta, dout, H)
    again = wrap["bwd_dkv"](q, k, v, bias, gate, mask, lse, delta, dout, H)
    torch.cuda.synchronize()
    # B5 writes each output element once, from a fixed order of sums: bit for bit
    deterministic = all(torch.equal(a, b) for a, b in zip((dk, dv, dbias), again))
    del again
    got = {"dq": dq, "dk": dk, "dv": dv, "dbias": dbias, "dgate": dgate}
    ref_out, ref_lse = FA.wavlm_gated_attention_fwd_lse_plain(q, k, v, bias, gate, mask, H)
    plain = dict(zip(("dq", "dk", "dv", "dbias", "dgate"), FA.wavlm_gated_attention_bwd_plain(
        q, k, v, bias, gate, mask, out, lse, dout, H)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias, gate)]
    auto = dict(zip(("dq", "dk", "dv", "dbias", "dgate"), torch.autograd.grad(
        FA.wavlm_gated_attention_plain(*leaves, mask, num_heads=H), leaves, dout)))
    del leaves

    row = {"B": B, "L": L, "valid": valid, "dtype": str(dtype).replace("torch.", ""),
           "tol_out": TOL[dtype], "tol_lse": LSE_TOL, "tol_bwd_rel": BWD_REL_TOL[dtype],
           "tol_autograd_rel": AUTOGRAD_REL_TOL[dtype], "bwd_dkv_deterministic": deterministic,
           "errors": {}}
    failures = [] if deterministic else ["B5 outputs differ between two calls"]
    out_err, _ = _rel_err(out, ref_out)
    lse_err, _ = _rel_err(lse, ref_lse)
    row["errors"]["out"], row["errors"]["lse"] = out_err, lse_err
    if not out_err <= TOL[dtype] or not lse_err <= LSE_TOL:
        failures.append(f"fwd_lse out {out_err} lse {lse_err}")
    for name, g in got.items():
        if not torch.isfinite(g).all():
            failures.append(f"{name} not finite")
            continue
        e_plain, s_plain = _rel_err(g, plain[name])
        e_auto, s_auto = _rel_err(g, auto[name])
        row["errors"][name] = {"vs_plain": e_plain, "plain_max_abs": s_plain,
                               "vs_autograd": e_auto, "autograd_max_abs": s_auto}
        if not e_plain <= BWD_REL_TOL[dtype] * s_plain:
            failures.append(f"{name} vs plain {e_plain} > {BWD_REL_TOL[dtype]} x {s_plain}")
        if not e_auto <= AUTOGRAD_REL_TOL[dtype] * s_auto:
            failures.append(f"{name} vs autograd {e_auto} > {AUTOGRAD_REL_TOL[dtype]} x {s_auto}")
    row["fwd_lse"] = {"max_abs_err": out_err}
    row["bwd_dq"] = {"max_abs_err": max(row["errors"][n]["vs_plain"] for n in ("dq", "dgate"))}
    row["bwd_dkv"] = {"max_abs_err": max(row["errors"][n]["vs_plain"]
                                         for n in ("dk", "dv", "dbias"))}
    del plain, auto, ref_out, ref_lse

    if timed:
        reps = 10
        args = (q, k, v, bias, gate, mask)
        bwd_args = (*args, lse, delta, dout, H)
        row["fwd_lse"]["ms"] = time_ms(lambda: wrap["fwd_lse"](*args, H), reps)
        row["bwd_dq"]["ms"] = time_ms(lambda: wrap["bwd_dq"](*bwd_args), reps)
        row["bwd_dkv"]["ms"] = time_ms(lambda: wrap["bwd_dkv"](*bwd_args), reps)
        row["fwd_lse"]["plain_ms"] = time_ms(
            lambda: FA.wavlm_gated_attention_fwd_lse_plain(*args, H), 3, 1)
        bwd_plain_ms = time_ms(lambda: FA.wavlm_gated_attention_bwd_plain(
            *args, out, lse, dout, H), 3, 1)
        row["bwd_dq"]["plain_ms"] = row["bwd_dkv"]["plain_ms"] = bwd_plain_ms
        # yardsticks: one SDPA call with the gated float mask, and autograd
        # of it with respect to q, k, v and the mask (where a backend can)
        float_mask = (gate[..., None] * bias[None].float()).masked_fill(
            ~mask[:, None, None, :], torch.finfo(torch.float32).min).to(dtype)
        heads = [x.view(B, L, H, 64).transpose(1, 2) for x in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["fwd_lse"]["library_ms"] = time_ms(lambda: sdpa(*heads, attn_mask=float_mask), 3, 1)
        lib_leaves = [x.detach().clone().requires_grad_() for x in (*heads, float_mask)]
        try:
            lib_out = sdpa(*lib_leaves[:3], attn_mask=lib_leaves[3])
            lib_dout = dout.view(B, L, H, 64).transpose(1, 2)
            bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, lib_leaves, lib_dout, retain_graph=True), 3, 1)
        except RuntimeError as e:  # no backend differentiates the mask
            print(json.dumps({"library_backward": f"none: {str(e)[:200]}"}), flush=True)
            bwd_lib_ms = None
        row["bwd_dq"]["library_ms"] = row["bwd_dkv"]["library_ms"] = bwd_lib_ms
        del float_mask, heads, lib_leaves
        for key, (bound, by) in training_bounds(q, bias, gate, mask, H).items():
            row[key]["bound_ms"], row[key]["bound_by"] = bound, by
    print(json.dumps({"training_kernels_vs_plain": row}), flush=True)
    if failures:
        fail(f"training kernels disagree at B={B} L={L} {dtype}: {failures}")
    torch.cuda.empty_cache()
    return row


def finetune_config(tokenizer_path: str, small: bool = False):
    """configs/fddm_zhTW_finetune.yaml over fddm_zhTW_base.yaml, in code
    (the card's machine has no YAML reader); `small` is phase 6's float32
    version with 64-wide WavLM heads, no dropout and a tiny vocabulary."""
    from fddm_asr_tpu_torch.config import Config

    cfg = flagship_config(tokenizer_path).to_dict()
    cfg["data"]["max_len"] = FINETUNE_TOKENS
    cfg["model"]["dropout"] = 0.1
    cfg["model"]["projector"] = {"d_proj": 256}
    cfg["model"]["encoder"].update({
        "freeze": False, "mask_time_prob": 0.065, "mask_time_length": 10,
        "wavlm_config": {"scan_layers": True, "remat_layers": True,
                         "freeze_feature_extractor": True, "fused_attention": True,
                         "hidden_dropout": 0.0, "attention_dropout": 0.0,
                         "activation_dropout": 0.0, "feat_proj_dropout": 0.0}})
    cfg["optim"] = {"batch_size": FINETUNE_B, "lr": 2e-4, "weight_decay": 0.01,
                    "grad_accum_steps": 1, "warmup_steps": 500, "dtype": "bfloat16",
                    "encoder_lr": 1e-5, "ema_decay": 0.999, "lr_schedule": "cosine",
                    "decay_steps": 20000}
    cfg["lfd"] = {"lambda_offdiag": 5e-3, "n_step_fd": 4, "tau": 1.0}
    if small:
        cfg["seed"] = 0
        cfg["data"].update({"vocab_size": 64, "max_len": 16})
        cfg["model"].update({"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192,
                             "dtype": "float32", "dropout": 0.0, "projector": {"d_proj": 32}})
        cfg["model"]["encoder"].update({"wavlm_name": "tiny", "mask_time_prob": 0.2,
                                        "mask_time_length": 3})
        cfg["model"]["encoder"]["wavlm_config"].update(
            {"hidden_size": 128, "num_attention_heads": 2, "intermediate_size": 256})
        cfg["optim"].update({"lr": 1e-3, "encoder_lr": 3e-4, "warmup_steps": 0,
                             "dtype": "float32"})
    return Config(cfg)


def _launch_counts(FA) -> dict:
    return {"fwd": FA.wavlm_gated_attention_cuda.launches,
            **{k: f.launches for k, f in _training_wrappers(FA).items()}}


def _reset_launches(FA) -> None:
    FA.wavlm_gated_attention_cuda.launches = 0
    for f in _training_wrappers(FA).values():
        f.launches = 0


def small_finetune_step_matches_cpu(FA, tokenizer_dir: str) -> dict:
    """One float32 fine-tune step with L_fd on the card and on the CPU from
    the same weights and draws: the card runs B3/B4/B5, the CPU the plain
    versions the CPU tests hold against the JAX package."""
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    cfg = finetune_config(synthetic_tokenizer(tokenizer_dir, 64), small=True)
    tok = load_tokenizer(cfg.data.tokenizer_path)
    B, seq = 3, 16
    wav = synthetic_audio(B, 1.0, seed=3)
    rng = np.random.default_rng(4)
    x0 = rng.integers(4, 64, (B, seq))
    x0[1, 10:] = 3  # pad tail
    sides = {}
    for dev in ("cpu", "cuda"):
        pipe = FDDMPipeline.from_config(cfg, tokenizer=tok, device=dev)
        if dev == "cuda":
            pipe.decoder.load_state_dict(sides["cpu"][0].decoder.state_dict())
            pipe.encoder.load_state_dict(sides["cpu"][0].encoder.state_dict())
            heads = TL.make_projection_heads(cfg, dev, torch.float32)
            for h, ref in zip(heads, sides["cpu"][1].trained_modules()[1:4]):
                h.load_state_dict(ref.state_dict())
            state = TL.init_train_state(pipe, cfg, heads=heads)
        else:
            state = TL.init_train_state(pipe, cfg, generator=torch.Generator().manual_seed(5))
        sides[dev] = (pipe, state, TL.make_train_step(pipe, cfg, train_encoder=True))
    S = sides["cpu"][0].encoder.config.feat_extract_output_length(wav.shape[1])
    draws = {"t": rng.integers(1, 201, (B,)), "xt": rng.integers(0, 64, (B, seq)),
             "time_mask": rng.random((B, S)) < 0.2}

    grads = {}
    for dev, (pipe, state, step) in sides.items():
        loss, _ = step.forward(state, wav, x0, True, **draws)
        grads[dev] = [None if g is None else g.detach().cpu() for g in torch.autograd.grad(
            loss, state.optimizer.params, allow_unused=True)]
    _reset_launches(FA)
    metrics = {dev: step(state, wav, x0, True, **draws) for dev, (_, state, step) in sides.items()}
    torch.cuda.synchronize()
    launches = _launch_counts(FA)
    n_layers = sides["cuda"][0].encoder.config.num_hidden_layers
    want_launches = {"fwd": 0, "fwd_lse": 2 * n_layers - 1, "bwd_dq": n_layers,
                     "bwd_dkv": n_layers}

    scale = max(g.abs().max().item() for g in grads["cpu"] if g is not None)
    grad_err = max((a - b).abs().max().item() for a, b in zip(grads["cuda"], grads["cpu"])
                   if a is not None)
    # Adam's first update is +-lr wherever the gradient's sign is resolved
    # (|g| above twice the gradient tolerance); an element at the noise
    # level may take the other sign on the other side: up to 2 lr
    param_err = resolved_err = 0.0
    for a, b, g in zip(sides["cuda"][1].optimizer.params, sides["cpu"][1].optimizer.params,
                       grads["cpu"]):
        diff = (a.detach().cpu() - b.detach()).abs()
        param_err = max(param_err, diff.max().item())
        if g is not None:
            resolved = g.abs() > 2 * SMALL_STEP_REL_TOL * scale
            resolved_err = max(resolved_err, diff[resolved].max().item() if resolved.any() else 0.0)
    metric_err = {k: abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k]))
                  / max(abs(float(metrics["cpu"][k])), 1e-30) for k in metrics["cpu"]}
    result = {"launches": launches, "expected_launches": want_launches,
              "grad_max_abs_err": grad_err, "grad_scale": scale,
              "grad_tol": SMALL_STEP_REL_TOL * scale, "metric_rel_err": metric_err,
              "param_max_abs_err": param_err, "resolved_param_max_abs_err": resolved_err,
              "loss": float(metrics["cuda"]["total_loss"])}
    print(json.dumps({"small_finetune_card_vs_cpu": result}), flush=True)
    if launches != want_launches:
        fail(f"small fine-tune step launches {launches}, expected {want_launches}")
    if not grad_err <= SMALL_STEP_REL_TOL * scale:
        fail(f"small fine-tune gradients, card vs CPU: {grad_err} > {SMALL_STEP_REL_TOL} x {scale}")
    if not all(e <= 1e-4 for e in metric_err.values()):
        fail(f"small fine-tune metrics, card vs CPU: {metric_err}")
    if not param_err <= 2.1 * float(cfg.optim.lr) or not resolved_err <= 1e-5:
        fail(f"small fine-tune updated parameters, card vs CPU: {param_err}, "
             f"{resolved_err} where the gradient is resolved")
    return result


def finetune_full_width(FA, tokenizer_dir: str, card: str, isolated: dict) -> dict:
    """`isolated`: phase 5's row at this step's attention shape; each
    kernel's time per launch in the profiled step is printed beside its
    CUDA-event time there."""
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    B, seconds, Lt = FINETUNE_B, FINETUNE_SECONDS, FINETUNE_TOKENS
    cfg = finetune_config(synthetic_tokenizer(tokenizer_dir, 8000))
    t0 = time.time()
    pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(cfg.data.tokenizer_path))
    state = TL.init_train_state(pipe, cfg, generator=torch.Generator(device="cuda").manual_seed(7))
    step = TL.make_train_step(pipe, cfg, train_encoder=True)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    enc_cfg = pipe.encoder.config
    n_layers = enc_cfg.num_hidden_layers
    wav = synthetic_audio(B, seconds, seed=5)
    rng = np.random.default_rng(6)
    x0 = rng.integers(4, 8000, (B, Lt))
    for b, n in enumerate(rng.integers(Lt // 4, Lt + 1, B)):
        x0[b, n:] = pipe.pad_id
    gen = torch.Generator(device="cuda").manual_seed(8)

    backbone = pipe.encoder.backbone
    watched = {"encoder.layers.12.attention.q_proj.weight":
                   backbone.encoder.layers[12].attention.q_proj.weight,
               "encoder.layers.0.attention.rel_attn_embed.weight":
                   backbone.encoder.layers[0].attention.rel_attn_embed.weight,
               "masked_spec_embed": backbone.masked_spec_embed,
               "decoder.blocks.0.ff.0.weight": pipe.decoder.blocks[0].ff[0].weight,
               "s_proj": state.s_proj.proj.net[0].weight}
    before = {n: p.detach().clone() for n, p in watched.items()}
    frontend = [p.detach().clone() for p in backbone.feature_extractor.parameters()]

    def run(apply_lfd=None):
        m = step(state, wav, x0, apply_lfd, generator=gen)
        torch.cuda.synchronize()
        return m

    t0 = time.time()
    warm = [run(True), run(False)]  # lazy init, both step variants
    warm_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    step_s, per_step, metrics = [], [], []
    for _ in range(TIMED_STEPS):  # steps 3..6: L_fd on step 4 only
        _reset_launches(FA)
        t0 = time.time()
        metrics.append(run())
        step_s.append(time.time() - t0)
        per_step.append(_launch_counts(FA))
    peak_mem_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"fwd": 0, "fwd_lse": 2 * n_layers - 1, "bwd_dq": n_layers, "bwd_dkv": n_layers}
    if any(c != want for c in per_step):
        fail(f"kernel launches per fine-tune step {per_step}, expected {want}")
    lfd_steps = [i for i, m in enumerate(metrics) if "loss_fd" in m]
    if lfd_steps != [1]:
        fail(f"L_fd ran on timed steps {lfd_steps}, expected [1] (every 4th step)")
    losses = [float(m["total_loss"]) for m in warm + metrics]
    if not all(np.isfinite(losses)):
        fail(f"fine-tune loss not finite: {losses}")
    moved = {n: (p.detach() - before[n]).abs().max().item() for n, p in watched.items()}
    if not all(d > 0 for d in moved.values()):
        fail(f"fine-tune left parameters unchanged: {moved}")
    if not all(torch.equal(a, p)
               for a, p in zip(frontend, backbone.feature_extractor.parameters())):
        fail("the frozen conv front-end changed")

    breakdown = device_time_breakdown(run, statistics.median(step_s))
    names = {"fwd_lse": ("gated_attention_bf16_kernel",), "bwd_dq": ("bwd_dq_bf16_kernel",),
             "bwd_dkv": ("bwd_dkv_bf16_kernel", "bwd_dbias_bf16_kernel")}
    breakdown["port_kernels_by_name"] = {t["name"]: t["ms"] for t in breakdown["all"]
                                         if any(n in t["name"] for ns in names.values()
                                                for n in ns)}
    breakdown["port_kernels_ms"] = {k: sum(t["ms"] for t in breakdown["all"]
                                           if any(n in t["name"] for n in ns))
                                    for k, ns in names.items()}
    for k, ns in names.items():
        if not all(any(n in t["name"] for t in breakdown["all"]) for n in ns):
            fail(f"the profiled fine-tune step shows no {ns} kernel")
    breakdown["port_kernel_ms_per_launch"] = {
        k: {"profiled": ms / per_step[0][k], "isolated": isolated[k]["ms"]}
        for k, ms in breakdown["port_kernels_ms"].items()}
    del breakdown["all"]
    print(json.dumps({"finetune_device_time": breakdown}), flush=True)
    result = {
        "card": card, "batch": B, "audio_s_per_example": seconds,
        "frames": enc_cfg.feat_extract_output_length(wav.shape[1]), "tokens": Lt,
        "step_s": statistics.median(step_s), "step_s_samples": step_s,
        "examples_per_s": B / statistics.median(step_s), "warmup_s": warm_s,
        "build_s": build_s, "peak_mem_gb": peak_mem_gb,
        "kernel_launches_per_step": per_step[0], "lfd_on_timed_step": lfd_steps,
        "metrics": [{k: float(v) for k, v in m.items()} for m in warm + metrics],
        "param_max_change": moved, "frontend_unchanged": True,
    }
    print(json.dumps({"finetune": result}), flush=True)
    return result


# -------------------------------------------- int8 and fused front-end path
def _bound(nbytes: float, ops: float, peak: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def int8_matmul_vs_plain(Q, M: int, din: int, dout: int, dtype, with_bias: bool, gen,
                         timed: bool) -> dict:
    """B7 against its plain version on x [M, din] (values up to a few units,
    so the row scales differ) and a weight of nn.Linear's init scale; output
    type = input type, as WavLM calls it.  Both hold the same exact integers
    and round the same f32 steps, so they agree within one ulp of the output
    type (f32: of each value; in practice bit for bit)."""
    dev = torch.device("cuda")
    x = (torch.randn(M, din, device=dev, generator=gen)
         * (0.5 + 2.0 * torch.rand(M, 1, device=dev, generator=gen))).to(dtype)
    weight = (torch.rand(dout, din, device=dev, generator=gen) * 2 - 1) / din ** 0.5
    bias = torch.randn(dout, device=dev, generator=gen) if with_bias else None
    wq_sw = Q.quantized_weight({}, "w", weight)
    out = Q.int8_matmul_fused_cuda(x, *wq_sw, bias, dtype)
    torch.cuda.synchronize()
    ref = Q.int8_matmul_fused_plain(x, weight, bias, dtype, wq_sw=wq_sw)
    err = (out.float() - ref.float()).abs()
    ulp = torch.finfo(dtype).eps * ref.float().abs().clamp(min=torch.finfo(dtype).tiny)
    row = {"M": M, "din": din, "dout": dout, "dtype": str(dtype).replace("torch.", ""),
           "bias": with_bias, "max_abs_err": err.max().item(),
           "not_identical": int((err > 0).sum().item()),
           "beyond_one_ulp": int((err > ulp).sum().item())}
    del err, ulp
    if timed:
        es = x.element_size()
        row["ms"] = time_ms(lambda: Q.int8_matmul_fused_cuda(x, *wq_sw, bias, dtype), 20)
        row["plain_ms"] = time_ms(
            lambda: Q.int8_matmul_fused_plain(x, weight, bias, dtype, wq_sw=wq_sw), 3, 1)
        # yardstick: the port's own unfused `int8` mode on the same inputs
        lib = Q.int8_matmul(x, weight, bias, dtype, wq_sw=wq_sw)
        row["library_max_abs_diff"] = (lib.float() - out.float()).abs().max().item()
        row["library_ms"] = time_ms(
            lambda: Q.int8_matmul(x, weight, bias, dtype, wq_sw=wq_sw), 10)
        row["bf16_matmul_ms"] = time_ms(lambda: torch.nn.functional.linear(
            x.bfloat16(), weight.bfloat16()), 10) if dtype == torch.bfloat16 else None
        nbytes = M * din * es + din * dout + dout * 4 * (2 if with_bias else 1) + M * dout * es
        row["bound_ms"], row["bound_by"] = _bound(nbytes, 2.0 * M * din * dout, INT8_PEAK_OPS)
        # the weight's quantization, done once per weight and kept (ops/quant.quantized_weight)
        row["weight_quant_ms"] = time_ms(lambda: Q.quantized_weight({}, "w", weight), 5)
    print(json.dumps({"int8_matmul_vs_plain": row}), flush=True)
    if row["beyond_one_ulp"] or not torch.isfinite(out.float()).all():
        fail(f"fused int8 matmul disagrees with its plain version: {row}")
    return row


def conv_vs_plain(CF, T: int, k: int, s: int, dtype, gelu_tanh: bool, gen, timed: bool) -> dict:
    """B8 against its plain version at B = 8, Cin = Cout = 512."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    B, C = 8, 512
    x = torch.randn(B, T, C, device=dev, generator=gen).to(dtype)
    w = (torch.rand(k, C, C, device=dev, generator=gen) * 2 - 1) / (k * C) ** 0.5
    b = torch.randn(C, device=dev, generator=gen) * 0.1
    ln_scale = torch.rand(C, device=dev, generator=gen) + 0.5
    ln_bias = torch.randn(C, device=dev, generator=gen) * 0.1
    with torch.no_grad():
        out = CF.conv_ln_gelu_cuda(x, w, b, ln_scale, ln_bias, s, gelu_tanh=gelu_tanh)
        torch.cuda.synchronize()
        ref = CF.conv_ln_gelu_plain(x, w, b, ln_scale, ln_bias, s, gelu_tanh=gelu_tanh)
    T_out = (T - k) // s + 1 if T >= k else 0
    atol, rtol = CONV_TOL[dtype]
    row = {"T": T, "T_out": T_out, "k": k, "s": s, "dtype": str(dtype).replace("torch.", ""),
           "gelu": "tanh" if gelu_tanh else "erf", "atol": atol, "rtol": rtol}
    if tuple(out.shape) != (B, T_out, C) or out.shape != ref.shape:
        fail(f"conv+LN+GELU output shape {tuple(out.shape)}, expected {(B, T_out, C)}")
    if T_out:
        err = (out.float() - ref.float()).abs()
        row["max_abs_err"] = err.max().item()
        row["beyond_tol"] = int((err > atol + rtol * ref.float().abs()).sum().item())
        del err
        if row["beyond_tol"] or not torch.isfinite(out.float()).all():
            fail(f"conv+LN+GELU kernel disagrees with its plain version: {row}")
    del ref
    if timed:
        reps = 10 if dtype == torch.bfloat16 else 3
        with torch.no_grad():
            row["ms"] = time_ms(lambda: CF.conv_ln_gelu_cuda(
                x, w, b, ln_scale, ln_bias, s, gelu_tanh=gelu_tanh), reps)
            row["plain_ms"] = time_ms(lambda: CF.conv_ln_gelu_plain(
                x, w, b, ln_scale, ln_bias, s, gelu_tanh=gelu_tanh), 2, 1)
            # yardstick: the unfused layer's three library calls, as models/wavlm.py runs them
            wt, bt = w.permute(2, 1, 0).to(dtype).contiguous(), b.to(dtype)
            ls, lb = ln_scale.to(dtype), ln_bias.to(dtype)

            def library():
                y = F.conv1d(x.transpose(1, 2), wt, bt, stride=s).transpose(1, 2)
                return F.gelu(F.layer_norm(y, (C,), ls, lb, 1e-5),
                              approximate="tanh" if gelu_tanh else "none")

            row["library_max_abs_diff"] = (library().float() - out.float()).abs().max().item()
            row["library_ms"] = time_ms(library, reps)
        es = x.element_size()
        nbytes = x.numel() * es + w.numel() * es + 3 * C * 4 + out.numel() * es
        row["bound_ms"], row["bound_by"] = _bound(
            nbytes, 2.0 * B * T_out * k * C * C, PEAK_FLOPS[dtype])
    print(json.dumps({"conv_ln_gelu_vs_plain": row}), flush=True)
    torch.cuda.empty_cache()
    return row


def bhld_attention_vs_plain(FA, dtype, gen) -> dict:
    """B6's entry point, `wavlm_gated_attention` on [B, L, H, dh]: driven
    once through the dispatcher (its launch counted), held against its
    plain version, timed."""
    B, L, H = 8, 1024, 16
    q, k, v, bias, gate, mask = attention_inputs(B, L, H, dtype, gen)
    q4, k4, v4 = (x.view(B, L, H, 64) for x in (q, k, v))
    FA.wavlm_gated_attention_bhld_cuda.launches = 0
    out = FA.wavlm_gated_attention(q4, k4, v4, bias, gate, mask)
    torch.cuda.synchronize()
    launches = FA.wavlm_gated_attention_bhld_cuda.launches
    ref = FA.wavlm_gated_attention_bhld_plain(q4, k4, v4, bias, gate, mask)
    err = (out.float() - ref.float()).abs()
    row = {"L": L, "dtype": str(dtype).replace("torch.", ""), "launches": launches,
           "max_abs_err": err.max().item(), "tol": TOL[dtype]}
    if launches != 1 or tuple(out.shape) != (B, L, H, 64):
        fail(f"wavlm_gated_attention: {launches} launches, output {tuple(out.shape)}")
    del out, ref, err
    row["ms"] = time_ms(lambda: FA.wavlm_gated_attention_bhld_cuda(q4, k4, v4, bias, gate, mask), 20)
    row["plain_ms"] = time_ms(
        lambda: FA.wavlm_gated_attention_bhld_plain(q4, k4, v4, bias, gate, mask), 4, 1)
    float_mask = (gate[..., None] * bias[None].float()).masked_fill(
        ~mask[:, None, None, :], torch.finfo(torch.float32).min).to(dtype)
    heads = [x.transpose(1, 2) for x in (q4, k4, v4)]
    row["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(*heads, attn_mask=float_mask),
        4, 1)
    del float_mask
    row["bound_ms"], row["bound_by"] = attention_bound_ms(q, bias, gate, mask, H)
    print(json.dumps({"bhld_attention_vs_plain": row}), flush=True)
    if not row["max_abs_err"] <= TOL[dtype]:
        fail(f"wavlm_gated_attention disagrees with its plain version: {row}")
    torch.cuda.empty_cache()
    return row


def small_quant_pipeline_matches_cpu(tokenizer_dir: str) -> dict:
    """Phase 11: a small float32 pipeline with the int8 encoder (fused
    kernel), the fused conv front-end and the int8 decoder on the card and
    on the CPU (plain versions) from the same weights and x_T.  The
    encoder's output decides (see the module docstring); ids are printed."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    K, B, seq_len = 64, 2, 16
    cfg = Config({
        "seed": 0,
        "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
        "model": {"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192,
                  "dtype": "float32", "quant_dense": "int8",
                  "encoder": {"wavlm_name": "tiny", "proj": "linear", "wavlm_config": {
                      "hidden_size": 128, "num_attention_heads": 2, "intermediate_size": 256,
                      "conv_dim": [128] * 7, **FUSED_WAVLM_CONFIG}}},
        "diffusion": {"T": 200, "beta_max": 0.2},
    })
    tok = load_tokenizer(synthetic_tokenizer(tokenizer_dir, K))
    cpu = FDDMPipeline.from_config(cfg, tokenizer=tok, device="cpu")
    gpu = FDDMPipeline.from_config(cfg, tokenizer=tok, device="cuda")
    gpu.decoder.load_state_dict(cpu.decoder.state_dict())
    gpu.encoder.load_state_dict(cpu.encoder.state_dict())
    wav = synthetic_audio(B, 1.0, seed=1)
    wav[1, 8000:] = 0.0
    x_init = np.random.default_rng(2).integers(0, K, (B, seq_len))
    sampling = dict(T_infer=20, r=5, greedy=True, x_init=x_init)
    wrappers = port_kernel_wrappers()
    for f in wrappers.values():
        f.launches = 0
    got = gpu.transcribe_with_ids(wav, seq_len=seq_len, **sampling)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in wrappers.items() if f.launches}
    n_layers = gpu.encoder.config.num_hidden_layers
    want = {"fwd": n_layers, "int8_matmul_fused": 6 * n_layers, "conv_ln_gelu": 6}
    c_gpu, _ = gpu.encode_waveform(wav)
    c_cpu, _ = cpu.encode_waveform(wav)
    feat_err = (c_gpu.cpu() - c_cpu).abs().max().item()
    ids_cpu, p_cpu = cpu.sample(c_cpu, seq_len, **sampling)
    got_ids = torch.tensor([r[1] for r in got])
    differ = (got_ids != ids_cpu).nonzero().tolist()
    top2 = p_cpu.topk(2, dim=-1).values
    result = {"launches": counts, "expected_launches": want, "encoder_max_abs_err": feat_err,
              "encoder_tol": SMALL_QUANT_ENCODER_TOL, "ids_equal": not differ,
              "ids_card": got_ids.tolist(), "ids_cpu": ids_cpu.tolist(),
              "cpu_margin_where_ids_differ": [
                  {"at": [b, i], "margin": (top2[b, i, 0] - top2[b, i, 1]).item()}
                  for b, i in differ]}
    print(json.dumps({"small_quant_pipeline_card_vs_cpu": result}), flush=True)
    if counts != want:
        fail(f"small quantized pipeline launches {counts}, expected {want}")
    if not feat_err <= SMALL_QUANT_ENCODER_TOL or not torch.isfinite(c_gpu).all():
        fail(f"small quantized pipeline encoder, card vs CPU: max abs err {feat_err}")
    return result


def transcribe_quantized_full_width(FA, tokenizer_dir: str, card: str, base_feats) -> dict:
    """Phase 12: the int8_fused + fused front-end configuration, the same
    with the library's int8 product and with no int8 at all (`quant_dense:
    none`: what the front-end and the tanh GELU do alone), and the int8
    encoder's output against that full-precision one."""
    fused = transcribe_full_width(
        FA, tokenizer_dir, card, "transcribe_int8_fused", FUSED_WAVLM_CONFIG,
        {"fwd": 24, "int8_matmul_fused": 144, "conv_ln_gelu": 6})
    library = transcribe_full_width(
        FA, tokenizer_dir, card, "transcribe_int8", {**FUSED_WAVLM_CONFIG, "quant_dense": "int8"},
        {"fwd": 24, "conv_ln_gelu": 6})
    front = transcribe_full_width(
        FA, tokenizer_dir, card, "transcribe_fused_frontend",
        {**FUSED_WAVLM_CONFIG, "quant_dense": "none"}, {"fwd": 24, "conv_ln_gelu": 6})
    ref = front["feats"].float()
    # phase 4's configuration once more, late in the process: the host's share of the wall
    # time grows over the run, so walls compare only between neighbours
    transcribe_full_width(FA, tokenizer_dir, card, "transcribe_repeat")

    def rel_l2(a):
        return ((a.float() - ref).norm() / ref.norm()).item()

    result = {"int8_fused_vs_full_precision": rel_l2(fused["feats"]),
              "int8_vs_full_precision": rel_l2(library["feats"]),
              "int8_fused_vs_int8": ((fused["feats"].float() - library["feats"].float()).norm()
                                     / library["feats"].float().norm()).item(),
              "fused_frontend_tanh_vs_phase_4": rel_l2(base_feats),
              "bounds": list(QUANT_REL_L2)}
    print(json.dumps({"quantized_encoder_rel_l2": result}), flush=True)
    lo, hi = QUANT_REL_L2
    if not lo < result["int8_fused_vs_full_precision"] < hi:
        fail(f"int8_fused encoder vs full precision: rel L2 {result} outside ({lo}, {hi})")
    if not result["fused_frontend_tanh_vs_phase_4"] > lo:
        fail("fused_frontend + gelu_approx_tanh left the encoder's output unchanged")
    return fused


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fddm_asr_tpu_torch.ops import _build
    from fddm_asr_tpu_torch.ops import conv_frontend as CF
    from fddm_asr_tpu_torch.ops import flash_attention as FA
    from fddm_asr_tpu_torch.ops import quant as Q

    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.time()
    libs = _build.build_libraries(verbose=True)
    print(json.dumps({"build": {"libraries": [os.path.relpath(p) for p in libs.values()],
                                "seconds": time.time() - t0}}), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for L in (1024, 4224):
        for dtype in (torch.float32, torch.bfloat16):
            rows[(L, dtype)] = kernel_vs_plain(FA, L, dtype, gen)
    edge_lengths_match_plain(FA, gen)

    with tempfile.TemporaryDirectory() as tmp:
        small_pipeline_matches_cpu(FA, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        result = transcribe_full_width(FA, tmp, card)

    # the shape phase 7's fine-tune gives the training kernels: B=32
    # utterances of 20 s, 999 frames each, padded to a multiple of 128
    from fddm_asr_tpu_torch.models.wavlm import WavLMConfig

    frames = WavLMConfig.large().feat_extract_output_length(int(16000 * FINETUNE_SECONDS))
    step_L = -(-frames // 128) * 128
    step_row = training_kernels_vs_plain(FA, step_L, torch.bfloat16, gen, timed=True,
                                         B=FINETUNE_B, valid=frames)
    for L in (1024, 384, 203):
        for dtype in (torch.float32, torch.bfloat16):
            training_kernels_vs_plain(FA, L, dtype, gen, timed=L == 1024)
    for L in B5_EDGE_LENGTHS:  # untimed: the edges of B5's tiles, one batch row and three
        training_kernels_vs_plain(FA, L, torch.bfloat16, gen, timed=False, B=1, valid=L - 3)
        training_kernels_vs_plain(FA, L, torch.bfloat16, gen, timed=False, B=3)
    with tempfile.TemporaryDirectory() as tmp:
        small_finetune_step_matches_cpu(FA, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        finetune = finetune_full_width(FA, tmp, card, isolated=step_row)

    # phases 8-12: the int8 encoder and the fused conv front-end
    int8_rows = {}
    for din, dout in WAVLM_DENSE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for with_bias in (True, False):
                int8_rows[(din, dout, dtype, with_bias)] = int8_matmul_vs_plain(
                    Q, 8192, din, dout, dtype, with_bias, gen, timed=with_bias)
    for dtype in (torch.bfloat16, torch.float32):
        int8_matmul_vs_plain(Q, 51, 64, 136, dtype, False, gen, timed=False)
    conv_rows = {}
    for T, k, s in ((63999, 3, 2), (1999, 2, 2)):
        for dtype in (torch.bfloat16, torch.float32):
            for gelu_tanh in (True, False):
                conv_rows[(k, dtype, gelu_tanh)] = conv_vs_plain(
                    CF, T, k, s, dtype, gelu_tanh, gen, timed=True)
    for T in (2, 3):  # no output row, one output row
        for dtype in (torch.bfloat16, torch.float32):
            conv_vs_plain(CF, T, 3, 2, dtype, True, gen, timed=False)
    bhld_rows = {dtype: bhld_attention_vs_plain(FA, dtype, gen)
                 for dtype in (torch.float32, torch.bfloat16)}
    with tempfile.TemporaryDirectory() as tmp:
        small_quant_pipeline_matches_cpu(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        quantized = transcribe_quantized_full_width(FA, tmp, card, result["feats"])

    main_row = rows[(1024, torch.bfloat16)]  # the transcribe's shape and type
    kernels = [{
        "name": "wavlm_gated_attention",
        "route": "cuda",
        "source": "fddm_asr_tpu_torch/csrc/gated_attention.cu",
        "replaces": "fddm_asr_tpu/ops/flash_attention.py:164 (_kernel_packed), "
                    "fddm_asr_tpu/ops/flash_attention.py:255 (_kernel_packed_flash)",
        "launches": result["kernel_launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "B=8 L=1024 H=16 bf16, ragged key masks",
    }]
    for key, kernel, source, replaces in (
            ("fwd_lse", "wavlm_gated_attention_fwd_lse", "gated_attention.cu",
             "fddm_asr_tpu/ops/flash_attention.py:412 (_kernel_packed_fwd_lse)"),
            ("bwd_dq", "wavlm_gated_attention_bwd_dq", "gated_attention_bwd.cu",
             "fddm_asr_tpu/ops/flash_attention.py:441 (_kernel_packed_bwd_dq)"),
            ("bwd_dkv", "wavlm_gated_attention_bwd_dkv", "gated_attention_bwd.cu",
             "fddm_asr_tpu/ops/flash_attention.py:476 (_kernel_packed_bwd_dkv)")):
        row = step_row[key]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": f"fddm_asr_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": finetune["kernel_launches_per_step"][key],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": f"B={FINETUNE_B} L={step_L} H=16 bf16, {frames} valid keys per row",
            **({"plain_and_library_cover": "B4+B5"} if key != "fwd_lse" else {}),
        })
    bhld = bhld_rows[torch.bfloat16]
    kernels.append({
        "name": "wavlm_gated_attention_bhld", "route": "cuda",
        "source": "fddm_asr_tpu_torch/csrc/gated_attention.cu",
        "replaces": "fddm_asr_tpu/ops/flash_attention.py:80 (_kernel)",
        "launches": bhld["launches"], "max_abs_err": bhld["max_abs_err"], "ms": bhld["ms"],
        "plain_ms": bhld["plain_ms"], "bound_ms": bhld["bound_ms"],
        "bound_by": bhld["bound_by"], "library_ms": bhld["library_ms"],
        "shape": "B=8 L=1024 H=16 dh=64 bf16, ragged key masks",
        "path": "the wavlm_gated_attention dispatcher, driven once: no model path reaches "
                "this kernel's entry point, in the JAX package or here",
    })
    ffn = int8_rows[(1024, 4096, torch.bfloat16, True)]  # the largest of the path's shapes
    kernels.append({
        "name": "int8_matmul_fused", "route": "cuda",
        "source": "fddm_asr_tpu_torch/csrc/int8_matmul_fused.cu",
        "replaces": "fddm_asr_tpu/ops/quant.py:92 (_fused_kernel)",
        "launches": quantized["launches"]["int8_matmul_fused"],
        "max_abs_err": ffn["max_abs_err"], "ms": ffn["ms"], "plain_ms": ffn["plain_ms"],
        "bound_ms": ffn["bound_ms"], "bound_by": ffn["bound_by"],
        "library_ms": ffn["library_ms"],
        "shape": "M=8192 din=1024 dout=4096 bf16 in and out, with bias",
        "by_shape": [{"din": din, "dout": dout, "launches_per_layer": 4 if din == dout else 1,
                      **{k: int8_rows[(din, dout, torch.bfloat16, True)][k] for k in (
                          "ms", "plain_ms", "library_ms", "bf16_matmul_ms", "bound_ms",
                          "bound_by", "max_abs_err")}}
                     for din, dout in WAVLM_DENSE_SHAPES],
    })
    conv = conv_rows[(3, torch.bfloat16, True)]  # layers 1-4's geometry at layer 1's length
    kernels.append({
        "name": "conv_ln_gelu", "route": "cuda",
        "source": "fddm_asr_tpu_torch/csrc/conv_ln_gelu.cu",
        "replaces": "fddm_asr_tpu/ops/conv_frontend.py:108 (kernel, made by _make_kernel :98)",
        "launches": quantized["launches"]["conv_ln_gelu"],
        "max_abs_err": conv["max_abs_err"], "ms": conv["ms"], "plain_ms": conv["plain_ms"],
        "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
        "library_ms": conv["library_ms"],
        "shape": "B=8 T=63999 Cin=Cout=512 k=3 s=2 bf16, tanh GELU",
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
