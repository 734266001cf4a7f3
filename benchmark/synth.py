"""Inputs the benchmark makes from `--seed`: weights, audio, token ids and a
tokenizer.  The same tensors go to the program and to the reference.

Weights are drawn on the device from one `torch.Generator` in two large
calls (one uniform, one normal buffer) and cut into the parameters of the
reference's modules, whose names are the program's state_dict names.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict

import torch
from torch import nn

SAMPLE_RATE = 16000
# the synthetic tokenizer's special ids (its vocab.json sidecar says so)
SPECIAL_IDS = {"unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": 3}


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for one stream of draws of a run: weights,
    audio, token ids ... each from their own, so adding one leaves the
    others' numbers alone.  Seeds of any size map into 63 bits."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + 7919 * stream) % (1 << 63))


def _kind(module: nn.Module, pname: str) -> str:
    if isinstance(module, nn.LayerNorm):
        return "norm_" + pname
    if isinstance(module, nn.Embedding):
        return "normal"
    if pname == "masked_spec_embed":
        return "unit"
    if pname == "gru_rel_pos_const":
        return "norm_weight"
    if pname == "in_proj_weight":
        return "xavier"
    return "fan_in"


@torch.no_grad()
def make_weights(model: nn.Module, seed: int, device, stream: int = 1,
                 buffers: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A float32 state_dict for `model` (built on any device, its values
    unused): linear and conv weights and biases uniform in +-1/sqrt(fan_in),
    packed attention in-projections xavier-uniform with biases in
    +-1/sqrt(d), embeddings N(0, 1) with the token embedding's pad row zero,
    LayerNorm weights 1 + U(-0.1, 0.1) and biases U(-0.1, 0.1) (so a norm's
    parameters matter to the output), WavLM's gate constants like a norm
    weight, `masked_spec_embed` U(0, 1).  Persistent buffers are computed,
    not drawn: `buffers` gives them by name (a module built on the meta
    device holds none), else they are copied from `model`."""
    params = []
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            params.append((f"{mname}.{pname}" if mname else pname, module, pname, p.shape))
    kinds = [(name, _kind(module, pname), shape, module, pname)
             for name, module, pname, shape in params]
    n_uniform = sum(math.prod(s) for _, k, s, _, _ in kinds if k != "normal")
    n_normal = sum(math.prod(s) for _, k, s, _, _ in kinds if k == "normal")
    g = generator(seed, device, stream)
    U = torch.rand(n_uniform, generator=g, device=device)
    N = torch.randn(n_normal, generator=g, device=device)
    out, iu, inn = {}, 0, 0
    for name, kind, shape, module, pname in kinds:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = N[inn:inn + n].view(shape).clone()
            inn += n
            continue
        u = U[iu:iu + n].view(shape)
        iu += n
        if kind == "unit":
            out[name] = u.clone()
        elif kind == "norm_weight":
            out[name] = 1.0 + 0.2 * (u - 0.5)
        elif kind == "norm_bias":
            out[name] = 0.2 * (u - 0.5)
        elif kind == "xavier":
            bound = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (2.0 * u - 1.0) * bound
        else:  # fan_in: a weight's own, a bias its weight's
            w = getattr(module, "weight", None)
            fan_in = (w[0].numel() if w is not None and pname == "bias" else
                      math.prod(shape[1:]) if len(shape) > 1 else shape[0])
            out[name] = (2.0 * u - 1.0) / math.sqrt(fan_in)
    if "tok_emb.weight" in out:
        out["tok_emb.weight"][SPECIAL_IDS["pad_id"]] = 0.0
    for name, buf in model.named_buffers():
        buf = (buffers or {}).get(name, buf)
        out[name] = buf.detach().to(device=device, dtype=torch.float32).clone()
    return out


def voiced_audio(rows: int, samples: int, g: torch.Generator, device) -> torch.Tensor:
    """[rows, samples] float32: harmonic tones on a random pitch under a
    syllable-rate envelope, plus noise (the program's smoke test's voice),
    drawn on `device`."""
    t = torch.arange(samples, device=device, dtype=torch.float64) / SAMPLE_RATE
    f0 = 90.0 + 160.0 * torch.rand(rows, 1, generator=g, device=device, dtype=torch.float64)
    rate = 2.0 + 3.0 * torch.rand(rows, 1, generator=g, device=device, dtype=torch.float64)
    # phases in float64, folded to a turn, so a 20 s tone keeps its pitch
    wav = sum(torch.sin(2 * math.pi * torch.frac(f0 * h * t)) / h for h in (1, 2, 3, 4))
    env = 0.5 * (1 + torch.sin(2 * math.pi * torch.frac(rate * t)))
    noise = torch.randn(rows, samples, generator=g, device=device)
    return (0.1 * wav * env).float() + 0.01 * noise


def write_tokenizer(directory: str, vocab_size: int) -> str:
    """A SentencePiece-style `.vocab`: 4 specials and single-ideograph
    pieces, with the `vocab.json` sidecar naming the special ids."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "bench.vocab")
    with open(path, "w", encoding="utf-8") as f:
        f.write("<unk>\t0\n<s>\t0\n</s>\t0\n<pad>\t0\n")
        for i in range(vocab_size - 4):
            f.write(f"{chr(0x4E00 + i)}\t{-(i + 1)}\n")
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({"special_token_ids": SPECIAL_IDS}, f)
    return path
