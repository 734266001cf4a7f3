# -*- coding: utf-8 -*-
"""A tiny synthetic dataset, tokenizer and config for end-to-end smoke runs.

    python -m fddm_asr_tpu_torch.scripts.make_synth_data --out /tmp/synth --n 16

Counterpart of `scripts/make_synth_data.py`, with its flags and files (the
same bytes for the same flags), under --out (default ./synth):

  data/processed/{train,validation,test}.json/.csv  manifests
  data/processed/clips/*.wav                        sine/noise mixtures
  data/tokenizer/toy/spm_toy.{model,vocab} + vocab.json
  config.yaml                                       a tiny model over a tiny WavLM
  config_convergence.yaml (--style sentences) or config_flagship.yaml
      (--style words): recipes over config.yaml

`config.load_config` reads every config it writes.
"""
from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from fddm_asr_tpu_torch.data.audio_io import save_wav
from fddm_asr_tpu_torch.tokenizer.train_bpe import train_bpe, write_artifacts

__all__ = ["SENTENCES", "main"]

SENTENCES = [
    "我們可以一起交流",
    "台灣的高速公路很大",
    "我們在台灣交流",
    "高速公路可以交流",
    "我們的交流道很大",
    "沒有問題可以交流",
    "一個大的交流道",
    "我們有一個問題",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default="synth")
    ap.add_argument("--n", type=int, default=16, help="utterances per split")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--vocab-size", type=int, default=96)
    ap.add_argument("--style", choices=["sentences", "words"],
                    default="sentences",
                    help="sentences: the 8 fixed sentences, one tone per "
                         "utterance (whole-utterance classification).  "
                         "words: COMPOSITIONAL synthetic "
                         "speech — every character is its own tone segment, "
                         "utterances are random character sequences, and "
                         "validation/test use UNSEEN compositions, so the "
                         "model must transcribe segment-by-segment")
    ap.add_argument("--n-chars", type=int, default=40,
                    help="words style: distinct characters (= distinct "
                         "tones) in the synthetic language")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="words style: utterance durations are uniform in "
                         "[--seconds, --max-seconds] (default: fixed at "
                         "--seconds)")
    args = ap.parse_args(argv)
    if args.style == "words":
        return _main_words(args)

    out = os.path.abspath(args.out)
    clips = os.path.join(out, "data/processed/clips")
    tok_dir = os.path.join(out, "data/tokenizer/toy")
    os.makedirs(clips, exist_ok=True)
    os.makedirs(tok_dir, exist_ok=True)

    # tokenizer ------------------------------------------------------------
    # cap piece length so sentences tokenize to several tokens (a toy vocab
    # over 8 sentences would otherwise merge each whole sentence into one
    # piece, degenerating the sequence-modeling task)
    model = train_bpe(SENTENCES * 10, vocab_size=args.vocab_size, max_piece_length=2)
    prefix = os.path.join(tok_dir, "spm_toy")
    write_artifacts(model, prefix, vocab_json_path=os.path.join(tok_dir, "vocab.json"))

    # audio + manifests ----------------------------------------------------
    rng = np.random.default_rng(0)
    sr = 16000
    for split in ("train", "validation", "test"):
        records = []
        for i in range(args.n):
            text = SENTENCES[i % len(SENTENCES)]
            t = np.arange(int(args.seconds * sr)) / sr
            f0 = 200 + 50 * (i % 8)
            wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(len(t))
            path = os.path.join(clips, f"{split}_{i:03d}.wav")
            save_wav(path, wav.astype(np.float32), sr)
            records.append({
                "path": path, "sentence": text, "text": text,
                "duration": args.seconds, "processed_path": path,
                "language": "zh-TW", "dataset": "synth", "split": split,
                "audio_hash": None,
            })
        jpath = os.path.join(out, f"data/processed/{split}.json")
        json.dump(records, open(jpath, "w", encoding="utf-8"), ensure_ascii=False, indent=1)
        with open(jpath.replace(".json", ".csv"), "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(records[0].keys()))
            w.writeheader()
            w.writerows(records)

    # config ---------------------------------------------------------------
    config = f"""seed: 7
data:
  sample_rate: 16000
  max_seconds: {args.seconds}
  pad_id: 0
  max_len: 24
  train_json: {out}/data/processed/train.json
  val_json: {out}/data/processed/validation.json
  test_json: {out}/data/processed/test.json
  tokenizer_path: {prefix}.model
  vocab_size: {args.vocab_size}
model:
  d_model: 32
  nhead: 4
  num_layers: 2
  dim_ff: 64
  dropout: 0.1
  encoder:
    wavlm_name: tiny
    freeze: true
    proj: linear
    pooling: none
  projector:
    d_proj: 16
diffusion:
  T: 50
  beta_max: 0.2
inference:
  T_infer: 8
  r: 4
optim:
  batch_size: 4
  lr: 2.0e-4
  weight_decay: 0.01
  num_epochs: 1
  grad_accum_steps: 1
  warmup_steps: 0
  dtype: float32
lfd:
  lambda_offdiag: 5.0e-3
  n_step_fd: 2
  tau: 1.0
log:
  log_every: 2
  ckpt_dir: {out}/ckpts
"""
    with open(os.path.join(out, "config.yaml"), "w") as f:
        f.write(config)

    # convergence recipe --------------------------------------------------
    # The smoke config above runs 1 epoch; this variant is the recipe that
    # learns the toy corpus end to end (the JAX package's README gives its
    # curve).  The deltas matter:
    #   * eos_id set -> fixed-seq_len decoding terminates (without eos the
    #     decode never stops and CER floors on trailing insertions);
    #   * a strong schedule (T=20, beta_max=0.6) -> enough corrupted
    #     positions per step for the posterior-KL to carry signal at toy
    #     scale (the KL is x0hat-insensitive where x_t == x0);
    #   * T_infer == T_train -> exact-mode sampling (which walks the
    #     TRAINING beta table with inference-axis t, reference quirk #4)
    #     stays calibrated.
    convergence = f"""base_config: {out}/config.yaml
data:
  eos_id: 2
diffusion:
  T: 20
  beta_max: 0.6
inference:
  T_infer: 20
  r: 5
  greedy: true
  sampling_mode: exact
optim:
  lr: 1.0e-3
  num_epochs: 300
  mask_pad_loss: true
log:
  log_every: 20
"""
    with open(os.path.join(out, "config_convergence.yaml"), "w") as f:
        f.write(convergence)
    print(f"synthetic dataset ready under {out}")
    print(f"  smoke config:       {out}/config.yaml  (1 epoch)")
    print(f"  convergence recipe: {out}/config_convergence.yaml  "
          "(300 epochs; reaches val CER ~0.03 on the toy corpus)")


# ---------------------------------------------------------------------------
# words style: compositional synthetic speech (the flagship's convergence corpus)
# ---------------------------------------------------------------------------
_SEG_SECONDS = 0.5     # one character = 0.35 s tone + 0.15 s silence
_TONE_SECONDS = 0.35


def _render_chars(chars, char_index, rng, sr=16000):
    """Audio for a character sequence: per-character dual-harmonic tone on a
    semitone grid (220 Hz * 2^(i/12)), 10 ms raised-cosine edges, light
    noise — spectrally separable after any (even random-frozen) conv
    front-end, yet requiring per-segment decisions."""
    seg = int(_SEG_SECONDS * sr)
    tone_n = int(_TONE_SECONDS * sr)
    t = np.arange(tone_n) / sr
    ramp_n = int(0.01 * sr)
    env = np.ones(tone_n)
    env[:ramp_n] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp_n) / ramp_n)
    env[-ramp_n:] = env[:ramp_n][::-1]
    wav = np.zeros(seg * len(chars), np.float32)
    for k, ch in enumerate(chars):
        f0 = 220.0 * 2.0 ** (char_index[ch] / 12.0)
        tone = (0.30 * np.sin(2 * np.pi * f0 * t)
                + 0.12 * np.sin(2 * np.pi * 2 * f0 * t)) * env
        wav[k * seg: k * seg + tone_n] = tone
    wav += 0.02 * rng.standard_normal(len(wav)).astype(np.float32)
    return wav


def _main_words(args):
    out = os.path.abspath(args.out)
    clips = os.path.join(out, "data/processed/clips")
    tok_dir = os.path.join(out, "data/tokenizer/toy")
    os.makedirs(clips, exist_ok=True)
    os.makedirs(tok_dir, exist_ok=True)

    sr = 16000
    charset = [chr(0x4E00 + i) for i in range(args.n_chars)]
    char_index = {c: i for i, c in enumerate(charset)}
    lo = args.seconds
    hi = args.max_seconds or args.seconds
    rng = np.random.default_rng(0)

    # tokenizer: character-level (max_piece_length=1) so tokens == audio
    # segments and CER counts per-segment transcription errors directly
    model = train_bpe(["".join(charset)] * 4, vocab_size=args.vocab_size,
                      max_piece_length=1)
    prefix = os.path.join(tok_dir, "spm_toy")
    write_artifacts(model, prefix,
                    vocab_json_path=os.path.join(tok_dir, "vocab.json"))

    max_chars = 0
    # DISJOINT compositions per split: sequences already emitted by an
    # earlier split are re-drawn, so validation/test measure transcription
    # of genuinely unseen sequences, not recall of memorized ones
    seen = set()
    for split, seed in (("train", 1), ("validation", 2), ("test", 3)):
        srng = np.random.default_rng(seed)
        records = []
        for i in range(args.n):
            dur = float(srng.uniform(lo, hi))
            k = max(2, int(round(dur / _SEG_SECONDS)))
            for _ in range(100):
                chars = [charset[j]
                         for j in srng.integers(0, len(charset), k)]
                if tuple(chars) not in seen:
                    break
            seen.add(tuple(chars))
            max_chars = max(max_chars, k)
            wav = _render_chars(chars, char_index, srng, sr)
            path = os.path.join(clips, f"{split}_{i:03d}.wav")
            save_wav(path, wav, sr)
            text = "".join(chars)
            records.append({
                "path": path, "sentence": text, "text": text,
                "duration": len(wav) / sr, "processed_path": path,
                "language": "synth-words", "dataset": "synth",
                "split": split, "audio_hash": None,
            })
        jpath = os.path.join(out, f"data/processed/{split}.json")
        json.dump(records, open(jpath, "w", encoding="utf-8"),
                  ensure_ascii=False, indent=1)
        with open(jpath.replace(".json", ".csv"), "w", newline="",
                  encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(records[0].keys()))
            w.writeheader()
            w.writerows(records)

    max_len = max_chars + 4  # chars + eos + slack
    # segment-grid ceiling: a k-segment clip is 0.5*k seconds, which can
    # exceed the drawn duration by up to 0.25 s — max_seconds must cover
    # the longest RENDERED clip or the loader truncates its final tone
    # while the transcript keeps the character
    max_sec_cfg = _SEG_SECONDS * max_chars
    smoke = f"""seed: 7
data:
  sample_rate: 16000
  max_seconds: {max_sec_cfg}
  pad_id: 0
  eos_id: 2
  max_len: {max_len}
  train_json: {out}/data/processed/train.json
  val_json: {out}/data/processed/validation.json
  test_json: {out}/data/processed/test.json
  tokenizer_path: {prefix}.model
  vocab_size: {args.vocab_size}
  cache_features: {out}/feature_cache
model:
  d_model: 32
  nhead: 4
  num_layers: 2
  dim_ff: 64
  dropout: 0.1
  encoder:
    wavlm_name: tiny
    freeze: true
    proj: linear
    pooling: none
  projector:
    d_proj: 16
diffusion:
  T: 20
  beta_max: 0.6
inference:
  T_infer: 20
  r: 5
  greedy: true
  sampling_mode: exact
optim:
  batch_size: 8
  lr: 1.0e-3
  weight_decay: 0.01
  num_epochs: 1
  grad_accum_steps: 1
  warmup_steps: 0
  dtype: float32
  mask_pad_loss: true
lfd:
  lambda_offdiag: 5.0e-3
  n_step_fd: 2
  tau: 1.0
log:
  log_every: 20
  ckpt_dir: {out}/ckpts
"""
    with open(os.path.join(out, "config.yaml"), "w") as f:
        f.write(smoke)

    # flagship convergence recipe: the real wavlm-large + d768x6 geometry
    # over this corpus — frozen encoder + feature cache; the toy-calibrated
    # schedule (T=20, beta_max=0.6, eos, exact T_infer == T) carried over.
    # The YAML's comments are the JAX script's, byte for byte
    flagship = f"""base_config: {out}/config.yaml
# Corrected recipe (round-4/5 diagnosis): reference optimizer settings
# (lr 2e-4 + warmup 1000 + B=4 — post-LN stacks need warmup; the round-3
# lr 5e-4 / no-warmup / B=16 recipe cannot even fit 16 memorized
# utterances), dropout 0 (round-4 dropout-mode-dependent-fit pathology),
# pure KL (L_fd at reference defaults dominates the toy-scale loss).
model:
  d_model: 768
  nhead: 12
  num_layers: 6
  dim_ff: 2048
  dropout: 0.0
  # round-5 stall root cause: flax default init draws every weight sqrt(3)
  # larger than the reference torch init and the d768x6 decoder plateaus at
  # train KL ~1.2 indefinitely; the torch-matching init descends normally
  init_scheme: torch
  encoder:
    wavlm_name: microsoft/wavlm-large
    freeze: true
    proj: linear
    pooling: none
  projector:
    d_proj: 256
data:
  cache_device: true
optim:
  batch_size: 4
  lr: 2.0e-4
  warmup_steps: 1000
  num_epochs: 800
  dtype: bfloat16
lfd:
  enabled: false
log:
  log_every: 100
  eval_every: 20
  ckpt_every: 100
  ckpt_dir: {out}/ckpts_flagship
  metrics_jsonl: true
  val_kl: sampled
  val_loss: false
  train_cer_batches: 2
"""
    with open(os.path.join(out, "config_flagship.yaml"), "w") as f:
        f.write(flagship)
    print(f"compositional synthetic dataset under {out}: "
          f"{args.n}/split x [{lo:.0f},{hi:.0f}] s, {args.n_chars} chars, "
          f"max_len {max_len}")
    print(f"  smoke config:    {out}/config.yaml")
    print(f"  flagship recipe: {out}/config_flagship.yaml")


if __name__ == "__main__":
    main()
