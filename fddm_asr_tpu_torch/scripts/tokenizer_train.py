# -*- coding: utf-8 -*-
"""Tokenizer training CLI.

    python -m fddm_asr_tpu_torch.scripts.tokenizer_train --config configs/tokenizer_zhTW.yaml

Counterpart of `scripts/tokenizer_train.py`, with its config schema and
outputs: reads the corpus JSON manifests (merged train/validation/dev/test
.json preferred, else `{lang_prefix}_*.json`), takes the configured text
field with its length filter, trains a SentencePiece-compatible BPE
vocabulary with the fixed special ids (unk=0, bos=1, eos=2, pad=3), and
writes `<prefix>.model`, `<prefix>.vocab` and the `vocab.json` sidecar.

Training always uses the port's own trainer (`tokenizer.train_bpe`); the
JAX script switches to the sentencepiece wheel when it can import it.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Iterator, List, Optional

__all__ = ["discover_corpus_files", "corpus_lines", "main"]


def discover_corpus_files(base_path: str, lang_prefix: str) -> List[str]:
    """Merged {train,validation,dev,test}.json when present; else the
    `{lang_prefix}_*.json` files, sorted."""
    merged = [os.path.join(base_path, name)
              for name in ("train.json", "validation.json", "dev.json", "test.json")
              if os.path.exists(os.path.join(base_path, name))]
    if merged:
        return merged
    return sorted(glob.glob(os.path.join(base_path, f"{lang_prefix}_*.json")))


def corpus_lines(files: List[str], text_field: str, min_len: int,
                 max_len: Optional[int]) -> Iterator[str]:
    """Each record's text (`text_field`, else text, else sentence), stripped,
    within [min_len (at least 1), max_len] characters."""
    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            records = json.load(f)
        for rec in records:
            text = rec.get(text_field) or rec.get("text") or rec.get("sentence") or ""
            text = str(text).strip()
            if len(text) < (min_len or 1):
                continue
            if max_len and len(text) > max_len:
                continue
            yield text


def _export_vocab_json(sp, prefix: str, vocab_json: str) -> None:
    """The vocab.json sidecar of a loaded tokenizer, with the fixed special
    ids (the JAX script writes it so beside a sentencepiece-trained model)."""
    id2token = [sp.id_to_piece(i) for i in range(sp.vocab_size())]
    with open(vocab_json, "w", encoding="utf-8") as f:
        json.dump({
            "vocab_size": sp.vocab_size(),
            "special_token_ids": {"unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": 3},
            "id2token": id2token,
            "token2id": {t: i for i, t in enumerate(id2token)},
            "sp_model_path": prefix + ".model",
        }, f, ensure_ascii=False, indent=2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train a BPE tokenizer")
    ap.add_argument("--config", type=str, required=True)
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.config import load_yaml
    from fddm_asr_tpu_torch.tokenizer.train_bpe import train_bpe, write_artifacts

    cfg = load_yaml(args.config)
    corpus, tok, out = cfg["corpus"], cfg["tokenizer"], cfg["output"]
    files = discover_corpus_files(corpus["base_path"], corpus.get("lang_prefix", ""))
    if not files:
        print(f"no corpus JSON found under {corpus['base_path']}", file=sys.stderr)
        sys.exit(1)
    print(f"corpus files: {files}")
    lines = list(corpus_lines(files, corpus.get("text_field", "text"),
                              corpus.get("min_len", 1), corpus.get("max_len")))
    print(f"{len(lines)} sentences")

    out_dir = out["dir"]
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, tok["model_prefix"])
    vocab_json = os.path.join(out_dir, out.get("export_vocab_json", "vocab.json"))
    model = train_bpe(lines, vocab_size=tok["vocab_size"],
                      character_coverage=tok.get("character_coverage", 0.9995),
                      user_defined_symbols=tok.get("extra_user_symbols") or [])
    write_artifacts(model, prefix, vocab_json_path=vocab_json)
    print(f"wrote {prefix}.model / .vocab and {vocab_json}")


if __name__ == "__main__":
    main()
