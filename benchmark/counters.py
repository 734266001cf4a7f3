"""The benchmark's own work counts: model FLOPs for the MFU metrics and each
hand kernel's operations and bytes for its roofline.  Frozen here, apart
from the program, so they read the same work whatever implements it.

Conventions (the roofline's, see peaks.json):
  * a multiply-add is 2 FLOPs; elementwise work, norms and softmax are not
    counted (they are a few percent of this model);
  * the model counts valid frames and tokens, not padding; a trained part
    costs forward 1x + backward 2x, a frozen part forward only, and
    recomputation (remat) is not counted;
  * a kernel's bytes are each input read once and each output written once.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> Dict[str, float]:
    with open(os.path.join(HERE, "peaks.json"), encoding="utf-8") as f:
        return {k: float(v) for k, v in json.load(f)["h100_sxm"].items()}


def conv_frames(samples: int, wavlm: dict) -> list:
    """The output length of each conv layer of the front-end."""
    out, n = [], samples
    for k, s in zip(wavlm["conv_kernel"], wavlm["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def encoder_flops(samples: int, wavlm: dict, d_model: int) -> float:
    """Forward FLOPs of WavLM (+ the projection to d_model) on one
    utterance of `samples` samples: conv front-end, feature projection,
    positional conv, per layer q/k/v/out, gate, attention and FFN."""
    frames = conv_frames(samples, wavlm)
    S = frames[-1]
    dims = [1] + list(wavlm["conv_dim"])
    f = sum(2.0 * dims[i] * k * dims[i + 1] * frames[i]
            for i, k in enumerate(wavlm["conv_kernel"]))
    H, F = wavlm["hidden_size"], wavlm["intermediate_size"]
    heads = wavlm["num_attention_heads"]
    f += 2.0 * dims[-1] * H * S
    f += 2.0 * (H // wavlm["num_conv_pos_embedding_groups"]) * wavlm["num_conv_pos_embeddings"] * H * S
    per_layer = 8.0 * H * H * S + 4.0 * H * F * S + 2.0 * (H // heads) * 8 * heads * S
    per_layer += 4.0 * S * S * H
    f += wavlm["num_hidden_layers"] * per_layer
    if d_model != H:
        f += 2.0 * H * d_model * S
    return f


def decoder_flops(L: int, S: int, d: int, layers: int, dim_ff: int, vocab: int) -> float:
    """Forward FLOPs of one decoder call on one row of L tokens over S
    condition frames."""
    f = 2.0 * d * 4 * d * 2 + 2.0 * d * d  # time MLP and time_proj, once a row
    per_block = (8.0 * d * d * L + 4.0 * L * L * d          # self-attention
                 + 4.0 * d * d * L + 4.0 * d * d * S + 4.0 * L * S * d  # cross-attention
                 + 4.0 * d * d                               # FiLM, once a row
                 + 4.0 * d * dim_ff * L)                     # FFN
    return f + layers * per_block + 2.0 * d * vocab * L


def gated_attention(kind: str, rows: int, L: int, kept: int, heads: int, elem_bytes: int,
                    head_dim: int = 64) -> Dict[str, float]:
    """Operations and bytes of one gated-attention kernel call on `rows`
    batch rows of L frames of which `kept` are real (queries and keys
    past them are padding and are not counted as work).  Products a
    (query, key) pair, head and head dim: forward 2 (q.k, p.v), B4 3
    (q.k, dO.v, dS.k), B5 4 (q.k, dO.v, P^T.dO, dS^T.q); 2 FLOPs each.
    Bytes (operands at `elem_bytes`, gate, lse and delta float32):
      fwd / fwd_lse: q, k, v, bias [H, L, L], gate, mask in; out (+ lse) out;
      bwd_dq: q, k, v, bias, gate, mask, lse, delta, dO in; dq, dgate out;
      bwd_dkv: q, k, v, bias, gate, mask, lse, delta, dO in; dk, dv,
      dbias [H, L, L] float32 out."""
    products = {"fwd": 2, "fwd_lse": 2, "bwd_dq": 3, "bwd_dkv": 4}[kind]
    ops = 2.0 * products * rows * heads * kept * kept * head_dim
    act = rows * L * heads * head_dim * elem_bytes
    bias = heads * L * L * elem_bytes
    row_f32 = rows * heads * L * 4
    mask = rows * L
    if kind in ("fwd", "fwd_lse"):
        nbytes = 3 * act + bias + row_f32 + mask + act + (row_f32 if kind == "fwd_lse" else 0)
    elif kind == "bwd_dq":
        nbytes = 4 * act + bias + 3 * row_f32 + mask + act + row_f32
    else:
        nbytes = 4 * act + bias + 3 * row_f32 + mask + 2 * act + heads * L * L * 4
    return {"ops": ops, "bytes": float(nbytes)}


def bound_seconds(ops: float, nbytes: float, flops_peak: float, bytes_peak: float) -> tuple:
    """(the least time the chip could take, "ops" or "bytes": which bound)."""
    t_ops, t_bytes = ops / flops_peak, nbytes / bytes_peak
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def sum_work(calls: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {"ops": sum(c["ops"] for c in calls), "bytes": sum(c["bytes"] for c in calls)}
