# -*- coding: utf-8 -*-
"""Build a long-form (multi-minute) test utterance from a manifest.

    python -m fddm_asr_tpu_torch.scripts.make_longform --manifest val.json \\
        --out long.wav --minutes 5 [--gap-ms 300] [--seed 0]

Counterpart of `scripts/make_longform.py`: manifest clips in a seeded
order, each followed by a silence gap, joined into one WAV (clips repeat
when the manifest is short; none is cut mid-clip, so audio and reference
agree), and the joined reference written beside it as `<out>.ref.json`.
The silences give the silence-aligned chunker (`inference --chunk-seconds`)
real cut points, as pauses between sentences do in a long recording.
Prints one JSON line with the WAV's path, duration and reference length.
Host only.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--out", required=True, help="output WAV path")
    ap.add_argument("--minutes", type=float, default=5.0,
                    help="target duration (clips repeat if needed)")
    ap.add_argument("--gap-ms", type=float, default=300.0, help="silence between clips")
    ap.add_argument("--seed", type=int, default=0, help="clip order shuffle seed")
    ap.add_argument("--sr", type=int, default=16000)
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.data.audio_io import load_audio, save_wav

    with open(args.manifest, encoding="utf-8") as f:
        records = json.load(f)
    order = np.random.default_rng(args.seed).permutation(len(records))
    target = int(args.minutes * 60 * args.sr)
    gap = np.zeros(int(args.gap_ms / 1e3 * args.sr), np.float32)
    pieces, texts, total, i = [], [], 0, 0
    while True:
        rec = records[int(order[i % len(order)])]
        wav, _ = load_audio(rec["processed_path"], target_sr=args.sr, mono=True)
        if pieces and total + len(wav) > target:
            break
        pieces += [wav.astype(np.float32), gap]
        texts.append(rec.get("text") or rec.get("sentence") or "")
        total += len(wav) + len(gap)
        i += 1
    long_wav = np.concatenate(pieces)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_wav(args.out, long_wav, args.sr)

    ref = "".join(texts)
    meta = {"wav": os.path.abspath(args.out), "seconds": round(len(long_wav) / args.sr, 1),
            "clips": i, "ref_text": ref, "manifest": args.manifest, "seed": args.seed}
    ref_path = args.out + ".ref.json"
    with open(ref_path, "w", encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)
    line = {k: v for k, v in meta.items() if k != "ref_text"} | {"ref_chars": len(ref),
                                                                 "ref_json": ref_path}
    print(json.dumps(line, ensure_ascii=False))
    return line


if __name__ == "__main__":
    main()
