# -*- coding: utf-8 -*-
"""BPE tokenizer trainer producing SentencePiece-compatible artifacts.

Counterpart of `fddm_asr_tpu/tokenizer/train_bpe.py`: for the same lines it
gives the same pieces, scores and types, and `write_artifacts` the same
`.model`, `.vocab` and `vocab.json` bytes.

  * normalization as the codec's (NFKC, whitespace folded and collapsed);
  * pieces never cross word boundaries; every word carries the U+2581
    prefix (dummy prefix, escaped spaces);
  * character_coverage: the rarest characters past the coverage quantile
    leave the alphabet (they encode as <unk>);
  * merges by pair frequency, ties broken lexicographically (a heap of
    (-count, pair));
  * the vocabulary: the specials <unk>=0, <s>=1, </s>=2, <pad>=3, the
    user-defined symbols, the merged pieces with score -(merge rank), then
    the alphabet by frequency, continuing the ranks.
"""
from __future__ import annotations

import collections
import heapq
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

from fddm_asr_tpu_torch.tokenizer import model_proto as mp
from fddm_asr_tpu_torch.tokenizer.spm import WS, SentencePieceProcessor

__all__ = ["SPECIALS", "train_bpe", "write_artifacts", "train_from_files"]

SPECIALS = ("<unk>", "<s>", "</s>", "<pad>")
_SPACES = "\t\n\r\v\f "  # folded to " " after NFKC


def _normalize(text: str) -> str:
    text = unicodedata.normalize("NFKC", text)
    text = "".join(" " if ch in _SPACES else ch for ch in text)
    return " ".join(t for t in text.split(" ") if t)


def _word_counts(lines: Iterable[str]) -> collections.Counter:
    counts: collections.Counter = collections.Counter()
    for line in lines:
        line = _normalize(line)
        if line:
            for word in line.split(" "):
                counts[WS + word] += 1
    return counts


def _coverage_alphabet(word_counts: collections.Counter,
                       character_coverage: float) -> Dict[str, int]:
    char_freq: collections.Counter = collections.Counter()
    for word, c in word_counts.items():
        for ch in word:
            char_freq[ch] += c
    total = sum(char_freq.values())
    kept: Dict[str, int] = {}
    covered = 0
    for ch, c in char_freq.most_common():
        if total and covered / total >= character_coverage and ch != WS:
            break
        kept[ch] = c
        covered += c
    kept.setdefault(WS, char_freq.get(WS, 1))
    return kept


def _merge(words: List[Tuple[List[str], int]], pair_counts: collections.Counter,
           pair_words: Dict[Tuple[str, str], collections.Counter],
           pair: Tuple[str, str], new_sym: str) -> set:
    """Apply one merge to the words that hold `pair`, keeping the pair
    counts and their word index current; returns the pairs it changed."""
    changed = set()
    for wi in list(pair_words.get(pair, ())):
        syms, c = words[wi]
        i = 0
        while i < len(syms) - 1:
            if syms[i] != pair[0] or syms[i + 1] != pair[1]:
                i += 1
                continue
            if i > 0:
                left, newl = (syms[i - 1], syms[i]), (syms[i - 1], new_sym)
                pair_counts[left] -= c
                pair_words[left][wi] -= 1
                pair_counts[newl] += c
                pair_words[newl][wi] += 1
                changed.update((left, newl))
            if i + 2 < len(syms):
                right = (syms[i + 1], syms[i + 2])
                pair_counts[right] -= c
                pair_words[right][wi] -= 1
                changed.add(right)
            syms[i:i + 2] = [new_sym]
            if i < len(syms) - 1:  # the new right-neighbour pair
                newr = (new_sym, syms[i + 1])
                pair_counts[newr] += c
                pair_words[newr][wi] += 1
                changed.add(newr)
    return changed


def train_bpe(lines: Iterable[str], vocab_size: int, character_coverage: float = 0.9995,
              max_piece_length: int = 16,
              user_defined_symbols: Optional[List[str]] = None) -> mp.SPModel:
    """Train BPE over an iterable of sentences; returns an SPModel."""
    word_counts = _word_counts(lines)
    alphabet = _coverage_alphabet(word_counts, character_coverage)
    uds = [s for s in (user_defined_symbols or []) if s not in SPECIALS]
    # characters outside the alphabet are dropped from the words: they encode
    # as <unk> at run time, and kept they would leave unmergeable symbols
    words: List[Tuple[List[str], int]] = []
    for word, c in word_counts.items():
        syms = [ch for ch in word if ch in alphabet]
        if syms:
            words.append((syms, c))
    n_merges = max(0, vocab_size - len(SPECIALS) - len(uds) - len(alphabet))

    pair_counts: collections.Counter = collections.Counter()
    pair_words: Dict[Tuple[str, str], collections.Counter] = collections.defaultdict(
        collections.Counter)
    for wi, (syms, c) in enumerate(words):
        for a, b in zip(syms, syms[1:]):
            pair_counts[(a, b)] += c
            pair_words[(a, b)][wi] += 1
    heap = [(-cnt, pair) for pair, cnt in pair_counts.items()]
    heapq.heapify(heap)

    merges: List[str] = []
    merged = set()
    while len(merges) < n_merges and heap:
        negcnt, pair = heapq.heappop(heap)
        cnt = pair_counts.get(pair, 0)
        if cnt <= 0:
            continue
        if -negcnt != cnt:  # a stale entry: push it back at its count
            heapq.heappush(heap, (-cnt, pair))
            continue
        new_sym = pair[0] + pair[1]
        if len(new_sym) > max_piece_length or new_sym in merged:
            pair_counts.pop(pair, None)
            continue
        merges.append(new_sym)
        merged.add(new_sym)
        changed = _merge(words, pair_counts, pair_words, pair, new_sym)
        pair_counts.pop(pair, None)
        pair_words.pop(pair, None)
        for p in changed:
            if pair_counts.get(p, 0) > 0:
                heapq.heappush(heap, (-pair_counts[p], p))

    pieces = [mp.Piece("<unk>", 0.0, mp.UNKNOWN), mp.Piece("<s>", 0.0, mp.CONTROL),
              mp.Piece("</s>", 0.0, mp.CONTROL), mp.Piece("<pad>", 0.0, mp.CONTROL)]
    pieces += [mp.Piece(s, 0.0, mp.USER_DEFINED) for s in uds]
    pieces += [mp.Piece(sym, -float(rank)) for rank, sym in enumerate(merges)]
    rank = len(merges)
    for ch, _ in sorted(alphabet.items(), key=lambda kv: (-kv[1], kv[0])):
        if ch not in merged:
            pieces.append(mp.Piece(ch, -float(rank)))
            rank += 1
    return mp.SPModel(pieces=pieces[:vocab_size], character_coverage=character_coverage)


def _fmt_score(score: float) -> str:
    if score == 0:
        return "0"
    if float(score).is_integer():
        return f"-{abs(int(score))}"
    return str(score)


def write_artifacts(model: mp.SPModel, output_prefix: str,
                    vocab_json_path: Optional[str] = None) -> None:
    """Write <prefix>.model, <prefix>.vocab and the vocab.json sidecar."""
    os.makedirs(os.path.dirname(output_prefix) or ".", exist_ok=True)
    mp.save_model(model, output_prefix + ".model")
    with open(output_prefix + ".vocab", "w", encoding="utf-8") as f:
        for p in model.pieces:
            score = 0 if p.type in (mp.UNKNOWN, mp.CONTROL, mp.USER_DEFINED) else p.score
            f.write(f"{p.piece}\t{_fmt_score(score)}\n")
    if vocab_json_path:
        id2token = [p.piece for p in model.pieces]
        sidecar = {
            "vocab_size": len(model.pieces),
            "special_token_ids": {"unk_id": model.unk_id, "bos_id": model.bos_id,
                                  "eos_id": model.eos_id, "pad_id": model.pad_id},
            "id2token": id2token,
            "token2id": {t: i for i, t in enumerate(id2token)},
            "sp_model_path": output_prefix + ".model",
        }
        with open(vocab_json_path, "w", encoding="utf-8") as f:
            json.dump(sidecar, f, ensure_ascii=False, indent=2)


def train_from_files(input_files: List[str], output_prefix: str, vocab_size: int,
                     character_coverage: float = 0.9995,
                     user_defined_symbols: Optional[List[str]] = None,
                     vocab_json_path: Optional[str] = None) -> SentencePieceProcessor:
    """Train on the lines of text files, write the artifacts, return the codec."""
    def lines():
        for path in input_files:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    yield line.rstrip("\n")

    model = train_bpe(lines(), vocab_size, character_coverage,
                      user_defined_symbols=user_defined_symbols)
    write_artifacts(model, output_prefix, vocab_json_path)
    sp = SentencePieceProcessor()
    sp._init_from_model(model)
    return sp
