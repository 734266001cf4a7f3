# -*- coding: utf-8 -*-
"""Quantization gate: full precision against int8 and lossy wire inputs.

    python -m fddm_asr_tpu_torch.scripts.validate_quant --config cfg.yaml \\
        --ckpt ckpts/best_model.pt [--encoder-ckpt ckpts/best_model.encoder.pt] \\
        --manifest data/processed/test.json [--variants fp,int8,int8_fused,pcm16,mulaw8]

Counterpart of `scripts/validate_quant.py`: transcribes a manifest's clips
(one zero-padded batch, greedy jumpy sampling) under each variant and
prints one JSON report with each variant's CER, its transcript agreement
with the first variant and the first ten disagreements, in the JAX
script's keys.  Variants: fp (full precision), int8 and int8_fused (the
encoder's denses through `ops/quant.py`; int8_fused is the hand-written
kernel on the card), int8_all (encoder and decoder int8), pcm16 and mulaw8
(the fp pipeline fed the host's encode/decode round trip of the serving
wire encodings, `data/wire.py`).  Wire variants share the fp pipeline.
The evidence for enabling int8 on a deployment: it must not change the
transcripts, or change CER within a stated budget.

The checkpoint is a reference `.pt` (an orbax directory raises, naming
scripts/export_torch_encoder.py); it carries no encoder, which comes from
--wavlm-ckpt / --encoder-ckpt as the other CLIs take them, else from the
config's seed.  Runs on CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["VARIANTS", "variant_config", "wire_roundtrip", "validate", "main"]

VARIANTS = ("fp", "int8", "int8_fused", "int8_all", "pcm16", "mulaw8")
WIRE = ("pcm16", "mulaw8")


def variant_config(cfg, name: str):
    """(the config of variant `name`, its (encoder, decoder) quantization):
    fp and the wire variants quantize nothing, int8 / int8_fused the
    encoder's denses, int8_all the encoder's and the decoder's (int8)."""
    if name in WIRE or name == "fp":
        enc, dec = "none", "none"
    else:
        enc = "int8" if name == "int8_all" else name
        dec = "int8" if name == "int8_all" else "none"
    return cfg.updated({"model": {"quant_dense": dec,
                                  "encoder": {"wavlm_config": {"quant_dense": enc}}}}), (enc, dec)


def wire_roundtrip(wave: np.ndarray, encoding: str) -> np.ndarray:
    """float32 samples through the host's wire encode and decode."""
    from fddm_asr_tpu_torch.data.wire import encode_wire, mulaw_decode_np

    coded = encode_wire(wave, encoding)
    if encoding == "pcm16":
        return coded.astype(np.float32) / 32768.0
    return mulaw_decode_np(coded)


def load_batch(records: List[Dict]) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(the clips zero-padded into one float32 batch, their lengths, the
    reference texts) of manifest records."""
    from fddm_asr_tpu_torch.data.audio_io import load_audio

    waves = [load_audio(rec["processed_path"], target_sr=16000, mono=True)[0]
             for rec in records]
    refs = [rec.get("text") or rec.get("sentence") or "" for rec in records]
    batch = np.zeros((len(waves), max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        batch[i, :len(w)] = w
    return batch, np.asarray([len(w) for w in waves]), refs


def validate(cfg, ckpt_path: str, records: List[Dict], names: List[str], seq_len: int,
             T_infer: int, r: int, tokenizer=None, wavlm_state_dict=None,
             encoder_state_dict=None, device: Optional[str] = None, x_init=None,
             on_variant=None) -> Tuple[Dict, Dict[str, Dict]]:
    """(the report, {variant: {"texts", "cer"}}).  `x_init` [B, seq_len]
    (default: x_T drawn from a generator seeded 0 on the pipeline's
    device) starts every variant's sampler; `on_variant(name, pipeline)`
    is called before each variant transcribes."""
    from fddm_asr_tpu_torch.eval import calculate_cer
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline

    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown --variants {unknown}; allowed: {sorted(VARIANTS)}")
    batch, lengths, refs = load_batch(records)
    variants, pipes = {}, {}
    for name in names:
        vcfg, key = variant_config(cfg, name)
        if key not in pipes:  # the wire variants share the fp pipeline
            pipes[key] = FDDMPipeline.from_config(
                vcfg, ckpt_path=ckpt_path, wavlm_state_dict=wavlm_state_dict,
                encoder_state_dict=encoder_state_dict, tokenizer=tokenizer, device=device)
        feed = wire_roundtrip(batch, name) if name in WIRE else batch
        if on_variant is not None:
            on_variant(name, pipes[key])
        texts = pipes[key].transcribe(feed, lengths, seq_len=seq_len, T_infer=T_infer, r=r,
                                      greedy=True, x_init=x_init)
        cer = float(np.mean([calculate_cer(rf, hy) for rf, hy in zip(refs, texts)]))
        variants[name] = {"texts": texts, "cer": cer}

    first = variants[names[0]]
    report = {"n": len(refs), f"cer_{names[0]}": round(first["cer"], 4)}
    diffs = []
    for name in names[1:]:
        q = variants[name]
        agree = float(np.mean([a == b for a, b in zip(first["texts"], q["texts"])]))
        report[f"cer_{name}"] = round(q["cer"], 4)
        report[f"transcript_agreement_{name}" if len(names) > 2
               else "transcript_agreement"] = round(agree, 4)
        diffs += [{"ref": rf, names[0]: a, name: b}
                  for rf, a, b in zip(refs, first["texts"], q["texts"]) if a != b]
    report["disagreements"] = diffs[:10]
    report.update({"T_infer": T_infer, "r": r, "seq_len": seq_len})
    return report, variants


def main(argv=None) -> Dict:
    from fddm_asr_tpu_torch.convert import add_encoder_weight_args, load_encoder_weights

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="training config.yaml")
    ap.add_argument("--ckpt", required=True, help="reference .pt checkpoint")
    add_encoder_weight_args(ap)
    ap.add_argument("--manifest", required=True, help="manifest JSON with wav paths + text")
    ap.add_argument("--seq-len", type=int, default=None, help="default: data.max_len")
    ap.add_argument("--T-infer", type=int, default=None)
    ap.add_argument("--r", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--variants", default="fp,int8",
                    help="comma list; the first is the baseline "
                         "(fp|int8|int8_fused|int8_all|pcm16|mulaw8)")
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.config import load_config
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    cfg = load_config(args.config)
    inference = cfg.get("inference", {})
    names = [v.strip() for v in args.variants.split(",") if v.strip()]
    with open(args.manifest, encoding="utf-8") as f:
        records = json.load(f)
    wavlm_sd, encoder_sd = load_encoder_weights(args.wavlm_ckpt, args.encoder_ckpt)
    report, _ = validate(cfg, args.ckpt, records, names,
                         seq_len=args.seq_len or cfg.data.get("max_len", 64),
                         T_infer=args.T_infer or inference.get("T_infer", 20),
                         r=args.r or inference.get("r", 5),
                         tokenizer=load_tokenizer(cfg.data.tokenizer_path),
                         wavlm_state_dict=wavlm_sd, encoder_state_dict=encoder_sd,
                         device=args.device)
    print(json.dumps(report, ensure_ascii=False))
    return report


if __name__ == "__main__":
    main()
