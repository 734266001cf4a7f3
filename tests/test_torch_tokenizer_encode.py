# -*- coding: utf-8 -*-
"""The port's tokenizer encode side (`fddm_asr_tpu_torch.tokenizer.spm`)
against the JAX package's: ids and pieces identical to its pure-Python
merge loop (`_encode_ids_py`, `encode_as_pieces`) and to its `encode`
(which takes its C++ merge loop where that builds), on the toy tokenizer
`scripts/make_synth_data.py` trains (a `.model` protobuf with merges) and
on a synthetic 8000-piece `.vocab` with multi-character pieces.  Cases:
NFKC, runs of whitespace, unknown characters, the empty string, a lone
surrogate, and random strings over each vocabulary's characters."""
import numpy as np
import pytest

from fddm_asr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from fddm_asr_tpu_torch.tokenizer import load_tokenizer

CASES = [
    "",
    "   ",
    "我們可以一起交流",
    "  我們  可以\t\t一起\n\n交流  ",
    "高速公路 很大　台灣 的 交流道",
    "ＡＢＣ１２３ｶﾞ①",       # NFKC: full-width, half-width katakana, circled digit
    "hello world ЖЗИ 🙂",      # characters no piece holds
    "我們\ud800交流",          # a lone surrogate
    "交流道交流道交流",
    "一丁丂 七丄",
]


def _toy(tmp_path_factory):
    from scripts.make_synth_data import main as make

    out = str(tmp_path_factory.mktemp("toy"))
    make(["--out", out, "--n", "1", "--seconds", "0.05"])
    return f"{out}/data/tokenizer/toy/spm_toy.model"


def _synthetic_8000(tmp_path_factory):
    """4 specials, U+2581, 3000 single ideographs and 4995 merged pieces
    (pairs and triples of them, some with the U+2581 prefix), scores
    falling with the index so every merge has its own rank."""
    rng = np.random.default_rng(0)
    chars = [chr(0x4E00 + i) for i in range(3000)]
    # doubled pieces first (the best scores): in a run of three of one
    # character the leftmost pair must merge
    pieces = ["<unk>", "<s>", "</s>", "<pad>", "▁"] + [c + c for c in chars[:5]] + chars
    seen = set(pieces)
    while len(pieces) < 8000:
        n = int(rng.integers(2, 4))
        piece = "".join(chars[int(j)] for j in rng.integers(0, 60, n))
        if rng.random() < 0.2:
            piece = "▁" + piece
        if piece not in seen:
            seen.add(piece)
            pieces.append(piece)
    path = tmp_path_factory.mktemp("synth8000") / "spm_synth.vocab"
    path.write_text("".join(f"{p}\t{0 if i < 4 else -(i + 1)}\n" for i, p in enumerate(pieces)),
                    encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module", params=["toy", "synthetic_8000"])
def tokenizers(request, tmp_path_factory):
    path = _toy(tmp_path_factory) if request.param == "toy" else \
        _synthetic_8000(tmp_path_factory)
    return jax_load_tokenizer(path), load_tokenizer(path)


def _random_texts(jax_tok, n=200, seed=1):
    """Strings over the vocabulary's own characters with spaces between."""
    rng = np.random.default_rng(seed)
    chars = sorted({ch for i in range(jax_tok.vocab_size())
                    for ch in jax_tok.id_to_piece(i) if not ch.isspace()
                    and ch != "▁" and jax_tok.id_to_piece(i)[0] != "<"})
    chars = chars[:80] + [" ", " ", "▁"]
    return ["".join(chars[int(j)] for j in rng.integers(0, len(chars), int(rng.integers(0, 40))))
            for _ in range(n)]


@pytest.mark.parametrize("text", CASES, ids=range(len(CASES)))
def test_ids_and_pieces_equal_the_jax_codec(tokenizers, text):
    jt, tt = tokenizers
    want_ids = jt._encode_ids_py(text)
    assert tt.encode(text) == want_ids
    assert tt.encode_as_pieces(text) == jt.encode_as_pieces(text)
    assert jt.encode(text) == want_ids  # the JAX native path agrees as well


def test_random_strings_equal_the_jax_codec(tokenizers):
    jt, tt = tokenizers
    texts = _random_texts(jt)
    merged = 0
    for text in texts:
        ids = tt.encode(text)
        assert ids == jt._encode_ids_py(text), text
        assert tt.encode(text, out_type=str) == jt.encode_as_pieces(text), text
        merged += sum(len(p) > 1 for p in tt.encode_as_pieces(text) if p != "▁")
    assert merged > 0  # the vocabulary's merges ran, not only single characters


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    path = _synthetic_8000(tmp_path_factory)
    return jax_load_tokenizer(path), load_tokenizer(path)


def test_ties_merge_the_leftmost_pair(synthetic):
    """Equal scores (one piece at several positions) merge leftmost first:
    in a run of three of a character whose doubled piece exists, the pair
    merges before the single character is left (unless the dummy prefix's
    U+2581 takes the first one)."""
    jt, tt = synthetic
    doubled = [chr(0x4E00 + i) * 2 for i in range(5)]
    tails = []
    for p in doubled:
        for text in (p[0] * 3, p[0] * 5 + " " + p[0] * 3, "丁" + p[0] * 3):
            assert tt.encode_as_pieces(text) == jt.encode_as_pieces(text), text
            assert tt.encode(text) == jt._encode_ids_py(text), text
        tails.append(tt.encode_as_pieces(p[0] * 3)[-2:] == [p, p[0]]
                     or tt.encode_as_pieces(p[0] * 3) == ["▁" + p, p[0]])
    assert all(tails)


def test_aliases_unknown_id_and_round_trip(tokenizers):
    jt, tt = tokenizers
    text = "我們 交流"
    ids = tt.encode(text)
    for alias in (tt.Encode, tt.EncodeAsIds, tt.encode_as_ids):
        assert alias(text) == ids
    assert tt.EncodeAsPieces(text) == tt.encode_as_pieces(text)
    assert tt.unk_id() == jt.unk_id()
    for piece in ("<unk>", "<pad>", "▁", "no such piece"):
        assert tt.piece_to_id(piece) == tt.PieceToId(piece) == jt.piece_to_id(piece)
    assert tt.encode("🙂") == jt._encode_ids_py("🙂")
    assert tt.unk_id() in tt.encode("🙂")
    assert tt.encode("") == [] and tt.encode_as_pieces("   ") == []
    known = "".join(ch for ch in "我們可以一起交流" if jt.piece_to_id(ch) != jt.unk_id())
    assert tt.decode(tt.encode(known)) == jt.decode(jt.encode(known))
