# -*- coding: utf-8 -*-
"""SentencePiece-compatible BPE vocabulary: load, encode and decode.

Counterpart of `fddm_asr_tpu/tokenizer/spm.py`: load a `.model` protobuf
or a `.vocab` tsv (piece<TAB>score), turn text into ids (`encode`) and ids
back into text (`DecodeIds` / `decode`).

Encoding: NFKC plus whitespace folding, optional collapse of extra
whitespace, a dummy-prefix space, spaces escaped to U+2581, then BPE by
greedy best-score adjacent merges (ties to the leftmost pair) over NORMAL
pieces, in a lazy heap.  A piece that is not a NORMAL vocabulary entry
falls back to per-character lookup, unknown characters to `unk_id`.  The
JAX package also has a C++ merge loop as a speed path; it gives the same
ids and is not ported.

Decoding: CONTROL pieces (<s>, </s>, <pad>) decode to nothing, UNKNOWN to
" ⁇ ", and U+2581 to a space, with the leading dummy-prefix space dropped.
"""
from __future__ import annotations

import heapq
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Union

from fddm_asr_tpu_torch.tokenizer import model_proto as mp

WS = "▁"
UNK_SURFACE = " ⁇ "

_DEFAULT_CONTROL = {"<s>", "</s>", "<pad>"}
_SPACES = "\t\n\r\v\f\u00a0\u202f\u2007"  # folded to " " (after NFKC)


class SentencePieceProcessor:
    def __init__(self, model_file: Optional[str] = None):
        """From a `.model` or `.vocab` file; with no file, empty until
        `_init_from_model` gives it an in-memory `SPModel` (the BPE
        trainer's)."""
        if model_file is None:
            model = mp.SPModel(pieces=[])
        elif model_file.endswith(".vocab") or not _looks_like_proto(model_file):
            model = mp.SPModel(pieces=_load_vocab_tsv(model_file))
        else:
            model = mp.load_model(model_file)
        self._init_from_model(model)

    def _init_from_model(self, model: mp.SPModel) -> None:
        self._pieces = model.pieces
        self._piece_to_id: Dict[str, int] = {p.piece: i for i, p in enumerate(self._pieces)}
        self._unk_id = model.unk_id
        self._add_dummy_prefix = model.add_dummy_prefix
        self._remove_extra_ws = model.remove_extra_whitespaces

    def vocab_size(self) -> int:
        return len(self._pieces)

    def __len__(self) -> int:
        return len(self._pieces)

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self._unk_id)

    PieceToId = piece_to_id

    def id_to_piece(self, idx: int) -> str:
        return self._pieces[idx].piece

    def unk_id(self) -> int:
        return self._unk_id

    # ---------------------------------------------------------------- encode
    def _normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = "".join(" " if ch in _SPACES else ch for ch in text)
        if self._remove_extra_ws:
            text = " ".join(t for t in text.split(" ") if t)
        return text

    def _pretokenize(self, text: str) -> str:
        """normalize + dummy prefix + U+2581 escaping: the merge loop's input."""
        text = self._normalize(text)
        if not text:
            return ""
        if self._add_dummy_prefix:
            text = " " + text
        return text.replace(" ", WS)

    def encode_as_pieces(self, text: str) -> List[str]:
        symbols = list(self._pretokenize(text))
        n = len(symbols)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap: List = []  # (-score of the merged piece, left position, left, right)

        def push(i: int) -> None:
            j = nxt[i]
            if j >= n:
                return
            mid = self._piece_to_id.get(symbols[i] + symbols[j])
            if mid is not None and self._pieces[mid].type == mp.NORMAL:
                heapq.heappush(heap, (-self._pieces[mid].score, i, symbols[i], symbols[j]))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, left, right = heapq.heappop(heap)
            if not alive[i] or symbols[i] != left:
                continue
            j = nxt[i]
            if j >= n or not alive[j] or symbols[j] != right:
                continue  # a stale entry: a neighbour merged since it was pushed
            symbols[i] = left + right
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prv[nxt[i]] = i
            push(i)
            if prv[i] >= 0:
                push(prv[i])
        return [symbols[i] for i in range(n) if alive[i]]

    EncodeAsPieces = encode_as_pieces

    def encode(self, text: str, out_type=int) -> List:
        if out_type is str:
            return self.encode_as_pieces(text)
        ids: List[int] = []
        for p in self.encode_as_pieces(text):
            pid = self._piece_to_id.get(p)
            if pid is None or self._pieces[pid].type in (mp.CONTROL, mp.UNKNOWN):
                ids.extend(self._piece_to_id.get(ch, self._unk_id) for ch in p)
            else:
                ids.append(pid)
        return ids

    Encode = encode
    EncodeAsIds = encode
    encode_as_ids = encode

    # ---------------------------------------------------------------- decode
    def decode(self, ids: Union[Sequence[int], Sequence[Sequence[int]]]) -> Union[str, List[str]]:
        if len(ids) and isinstance(ids[0], (list, tuple)):
            return [self._decode_one(x) for x in ids]
        return self._decode_one(ids)  # type: ignore[arg-type]

    DecodeIds = decode

    def _decode_one(self, ids: Sequence[int]) -> str:
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self._pieces):
                continue
            p = self._pieces[i]
            if p.type == mp.CONTROL:
                continue
            parts.append(UNK_SURFACE if p.type == mp.UNKNOWN else p.piece)
        text = "".join(parts).replace(WS, " ")
        return text[1:] if text.startswith(" ") else text


def _load_vocab_tsv(path: str) -> List[mp.Piece]:
    """`.vocab` tsv: the first <unk> is UNKNOWN, <s></s><pad> are CONTROL."""
    pieces: List[mp.Piece] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            piece, _, score = line.rpartition("\t")
            ptype = mp.NORMAL
            if piece == "<unk>":
                ptype = mp.UNKNOWN
            elif piece in _DEFAULT_CONTROL:
                ptype = mp.CONTROL
            pieces.append(mp.Piece(piece, float(score), ptype))
    return pieces


def _looks_like_proto(path: str) -> bool:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        head = f.read(2)
    return len(head) == 2 and head[0] == 0x0A  # field 1, wire type 2


def load_tokenizer(path: str) -> SentencePieceProcessor:
    """Load from `.model`, `.vocab`, or a directory holding one.

    A missing `.model` falls back to the `.vocab` beside it."""
    if os.path.isdir(path):
        for ext in (".model", ".vocab"):
            for name in sorted(os.listdir(path)):
                if name.endswith(ext):
                    return SentencePieceProcessor(os.path.join(path, name))
        raise FileNotFoundError(f"no .model/.vocab under {path}")
    if not os.path.exists(path) and path.endswith(".model"):
        alt = path[: -len(".model")] + ".vocab"
        if os.path.exists(alt):
            return SentencePieceProcessor(alt)
    return SentencePieceProcessor(path)
