# -*- coding: utf-8 -*-
"""Write a random-init checkpoint for a config, with no training.

    python -m fddm_asr_tpu_torch.scripts.init_random_ckpt \\
        --config configs/fddm_zhTW_base.yaml --out /tmp/random.pt [--make-tokenizer]

Counterpart of `scripts/init_random_ckpt.py`: deployment smoke tests,
serving and export benchmarks and load-path checks need a checkpoint at
the real model scale.  The pipeline and the three projection heads are
built as `train_lib.run_training` builds them at the config's seed
(default 1337; `train_lib.training_pipeline`, `training_heads`), so the
`.pt` (the reference format: decoder and heads) holds the port's epoch-0
weights.  They come from the port's `torch.Generator` draws, so they are
not the JAX script's weights for the same seed.  The encoder is not
written: the loaders rebuild it from the seed, or take --wavlm-ckpt /
--encoder-ckpt.

--make-tokenizer writes a synthetic SentencePiece model of exactly
data.vocab_size pieces beside --out (`spm_synth.model`, `.vocab` and
`vocab.json`: the four specials and single CJK ideographs from U+4E00),
the JAX script's bytes, and builds the pipeline with it.

Runs on CUDA unless given --device cpu (without a GPU it raises).  Prints
one JSON line: {"out": ..., "params": N, "bytes": N[, "tokenizer": ...]}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["make_synthetic_tokenizer", "main"]


def make_synthetic_tokenizer(prefix: str, vocab_size: int) -> str:
    """A SentencePiece model of exactly `vocab_size` pieces: the four
    specials and single CJK-ideograph NORMAL pieces (U+4E00 ..), scores
    -1, -2, ...; it encodes and decodes real text, its pieces mean
    nothing.  Returns `<prefix>.model`."""
    from fddm_asr_tpu_torch.tokenizer import model_proto as mp
    from fddm_asr_tpu_torch.tokenizer.train_bpe import write_artifacts

    n_normal = vocab_size - 4
    if n_normal <= 0:
        raise ValueError(f"vocab_size {vocab_size} too small")
    if n_normal > 0x9FFF - 0x4E00 + 1:
        raise ValueError(f"vocab_size {vocab_size} exceeds the synthetic CJK piece budget")
    pieces = [mp.Piece("<unk>", 0.0, mp.UNKNOWN), mp.Piece("<s>", 0.0, mp.CONTROL),
              mp.Piece("</s>", 0.0, mp.CONTROL), mp.Piece("<pad>", 0.0, mp.CONTROL)]
    pieces += [mp.Piece(chr(0x4E00 + i), -float(i + 1), mp.NORMAL) for i in range(n_normal)]
    model = mp.SPModel(pieces=pieces, unk_id=0, bos_id=1, eos_id=2, pad_id=3)
    write_artifacts(model, prefix,
                    vocab_json_path=os.path.join(os.path.dirname(prefix), "vocab.json"))
    return prefix + ".model"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="training config.yaml")
    ap.add_argument("--out", required=True, help="output .pt path")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--make-tokenizer", action="store_true",
                    help="also write a synthetic data.vocab_size-piece SentencePiece "
                         "tokenizer next to --out (spm_synth.model) and use it: for "
                         "benchmarks at the real vocabulary size when the config's "
                         "tokenizer is not at hand")
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch import checkpoint as C
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.config import load_config

    cfg = load_config(args.config)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    tokenizer = tok_path = None
    if args.make_tokenizer:
        from fddm_asr_tpu_torch.tokenizer import load_tokenizer

        tok_path = make_synthetic_tokenizer(os.path.join(out_dir, "spm_synth"),
                                            int(cfg.data.vocab_size))
        tokenizer = load_tokenizer(tok_path)
    pipeline = TL.training_pipeline(cfg, device=args.device, tokenizer=tokenizer)
    heads = TL.training_heads(cfg, pipeline)
    os.makedirs(out_dir, exist_ok=True)

    def host(module):
        return {k: v.detach().cpu() for k, v in module.state_dict().items()}

    C.save_reference_ckpt(args.out, host(pipeline.decoder), *(host(h) for h in heads),
                          epoch=0, step=0, config=cfg.to_dict())
    line = {"out": args.out,
            "params": sum(p.numel() for p in pipeline.decoder.parameters()),
            "bytes": os.path.getsize(args.out)}
    if tok_path:
        line["tokenizer"] = tok_path
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
