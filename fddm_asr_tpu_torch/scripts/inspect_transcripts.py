# -*- coding: utf-8 -*-
"""Decode a manifest with a trained checkpoint and show ref against hyp for
each utterance: the diagnosis of a convergence run's failure mode.

    python -m fddm_asr_tpu_torch.scripts.inspect_transcripts --config run.yaml \\
        --ckpt ckpts/best_model.pt [--encoder-ckpt ckpts/best_model.encoder.pt] \\
        [--manifest val.json] [--n 8] [--json out.json]

Counterpart of `scripts/inspect_transcripts.py`.  Two failure signatures
that look alike in aggregate CER differ here: constant-token collapse
(every hyp the same string, p_x0's entropy near ln K with a tiny argmax
margin) and an insertion floor (the right content, then inserted garbage).
Prints each row's CER, ref and hyp, then a JSON summary (`distinct_hyps`,
`constant_collapse`, `empty_hyps`, p_x0's mean entropy and argmax margin);
--json also writes the summary and the rows.

The checkpoint is a reference `.pt` (an orbax directory raises, naming
scripts/export_torch_encoder.py); the encoder comes from --wavlm-ckpt /
--encoder-ckpt as the other CLIs take them, else from the config's seed.
Runs on CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["inspect", "main"]


def inspect(pipe, records: List[Dict], seq_len: int, T_infer: int, r: int,
            x_init=None, echo: bool = True) -> Tuple[Dict, List[Dict]]:
    """(the summary without the run's settings, the rows) of decoding the
    manifest `records` as one zero-padded batch, greedy, from x_T drawn from
    a generator seeded 0 (or `x_init` [B, seq_len])."""
    import torch

    from fddm_asr_tpu_torch.eval import calculate_cer
    from fddm_asr_tpu_torch.scripts.validate_quant import load_batch

    batch, lengths, refs = load_batch(records)
    c, c_mask = pipe.encode_waveform(batch, lengths)
    ids, p = pipe.sample(c, seq_len, c_mask, x_init=x_init, T_infer=T_infer, r=r, greedy=True,
                         generator=torch.Generator(device=pipe.device).manual_seed(0))
    ids = ids.cpu().numpy()
    hyps = [pipe.ids_to_text(ids[i]) for i in range(ids.shape[0])]
    # a uniform collapse shows entropy ~ ln(K) and a tiny argmax margin; a
    # confidently wrong model a low entropy
    p = p.double().cpu().numpy()
    ent = float(np.mean(-(p * np.log(p + 1e-12)).sum(-1)))
    top2 = np.sort(p, axis=-1)[..., -2:]
    margin = float(np.mean(top2[..., 1] - top2[..., 0]))
    rows = []
    for ref, hyp in zip(refs, hyps):
        cer = calculate_cer(ref, hyp)
        rows.append({"ref": ref, "hyp": hyp, "cer": round(cer, 4)})
        if echo:
            print(f"CER {cer:6.3f} | ref: {ref!r}")
            print(f"           | hyp: {hyp!r}")
    distinct = len({row["hyp"] for row in rows})  # 1: every utterance the same string
    summary = {
        "n": len(rows), "mean_cer": round(float(np.mean([row["cer"] for row in rows])), 4),
        "distinct_hyps": distinct,
        "constant_collapse": distinct == 1,
        "empty_hyps": sum(1 for row in rows if not row["hyp"]),
        "p_x0_entropy": round(ent, 4),
        "p_x0_entropy_uniform": round(float(np.log(p.shape[-1])), 4),
        "p_x0_argmax_margin": round(margin, 6),
    }
    return summary, rows


def main(argv=None) -> Dict:
    from fddm_asr_tpu_torch.convert import add_encoder_weight_args, load_encoder_weights

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="training config.yaml")
    ap.add_argument("--ckpt", required=True, help="reference .pt checkpoint")
    add_encoder_weight_args(ap)
    ap.add_argument("--manifest", default=None, help="default: the config's data.val_json")
    ap.add_argument("--n", type=int, default=8, help="utterances to decode")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--T-infer", type=int, default=None)
    ap.add_argument("--r", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--json", default=None, help="also write a JSON artifact")
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.config import load_config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    cfg = load_config(args.config)
    manifest = args.manifest or cfg.data.get("val_json")
    if not manifest or not os.path.exists(manifest):
        sys.exit(f"manifest not found: {manifest!r}")
    inference = cfg.get("inference", {})
    T_infer = args.T_infer or inference.get("T_infer", 20)
    r = args.r or inference.get("r", 5)
    seq_len = args.seq_len or cfg.data.get("max_len", 64)
    with open(manifest, encoding="utf-8") as f:
        records = json.load(f)[:args.n]
    wavlm_sd, encoder_sd = load_encoder_weights(args.wavlm_ckpt, args.encoder_ckpt)
    pipe = FDDMPipeline.from_config(cfg, ckpt_path=args.ckpt, wavlm_state_dict=wavlm_sd,
                                    encoder_state_dict=encoder_sd,
                                    tokenizer=load_tokenizer(cfg.data.tokenizer_path),
                                    device=args.device)
    summary, rows = inspect(pipe, records, seq_len, T_infer, r)
    summary.update({"T_infer": T_infer, "r": r, "seq_len": seq_len, "ckpt": args.ckpt})
    print(json.dumps(summary, ensure_ascii=False))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"summary": summary, "rows": rows}, f, ensure_ascii=False, indent=1)
    return summary


if __name__ == "__main__":
    main()
