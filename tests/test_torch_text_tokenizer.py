# -*- coding: utf-8 -*-
"""The port's text normalization, SentencePiece writer, BPE trainer and
tokenizer CLI against the JAX package's, on the same inputs (made from a
seed with numpy): `normalize_text` equal on hypothesis text and a fixed
list, `serialize_model` byte for byte, `train_bpe` piece for piece (score
and type too), and the `.model`, `.vocab` and `vocab.json` files of
`write_artifacts`, `scripts/tokenizer_train.py` and
`scripts/init_random_ckpt.py --make-tokenizer` byte for byte.  Each CLI
runs in a working directory of its own, with relative paths, so the paths
written into the files are the same on both sides.

Pinned difference: the JAX tokenizer CLI trains with the sentencepiece
wheel when it can import it; the port always uses its own trainer."""
import ast
import json
import os
import sys
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fddm_asr_tpu.data.text import normalize_text as jax_normalize
from fddm_asr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from fddm_asr_tpu.tokenizer import model_proto as JMP
from fddm_asr_tpu.tokenizer import train_bpe as JT
from fddm_asr_tpu_torch.data.text import normalize_text
from fddm_asr_tpu_torch.tokenizer import load_tokenizer
from fddm_asr_tpu_torch.tokenizer import model_proto as TMP
from fddm_asr_tpu_torch.tokenizer import train_bpe as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

ARTIFACTS = ("spm.model", "spm.vocab", "vocab.json")


def _files(root, names):
    return {n: (root / n).read_bytes() for n in names}


# ------------------------------------------------------------ normalize_text
_chars = st.sampled_from(list("abcXYZ 09_\t\n()（）,.!?;:'\"-我們的交流台灣ÉéßＡａ１　 "
                              "一鿿鿿一㐀😀"))


@settings(max_examples=400, deadline=None)
@given(st.text(_chars, max_size=40) | st.text(max_size=40))
def test_normalize_text_equals_the_jax_function(text):
    assert normalize_text(text) == jax_normalize(text)


@pytest.mark.parametrize("text", [
    "Hello (world) there", "(all parens)", "a (b (c) d) e", "（全形括號）留下", "我們 (附註) 交流",
    "Tabs\tand\nnewlines  and   spaces", "  leading and trailing  ", "a , b", "Punct!? ok.",
    "MiXeD CaSe ÉCOLE", "數字123和English混合", "under_score", "émoji 😀 here", "", "   ",
    None, 42, b"bytes", ["list"]])
def test_normalize_text_fixed_cases(text):
    assert normalize_text(text) == jax_normalize(text)


def test_normalize_text_quirks_are_kept():
    """Only ASCII parentheses go, and whitespace is not collapsed again
    after the last filter."""
    assert normalize_text("a (x) （y） b") == "a y b"  # the full-width pair stays, then goes
    assert normalize_text("a , b") == "a  b"
    assert normalize_text(3.5) == ""


# ----------------------------------------------------------- model_proto
def _random_model(rng, mod, **kw):
    types_ = [mod.UNKNOWN, mod.CONTROL, mod.CONTROL, mod.CONTROL]
    types_ += list(rng.choice([mod.NORMAL, mod.USER_DEFINED, mod.BYTE, mod.UNUSED], 20))
    pieces = [mod.Piece(f"▁p{i}{chr(0x4E00 + i)}", float(rng.normal()), int(t))
              for i, t in enumerate(types_)]
    return mod.SPModel(pieces=pieces, **kw)


@pytest.mark.parametrize("kw", [
    {}, {"pad_id": -1, "bos_id": -1}, {"add_dummy_prefix": False,
                                        "remove_extra_whitespaces": False,
                                        "escape_whitespaces": False,
                                        "normalizer_name": "identity"},
    {"unk_id": 7, "eos_id": 300, "model_type": 1}])
def test_serialize_model_bytes_equal_the_jax_writer(kw):
    ours = TMP.serialize_model(_random_model(np.random.default_rng(1), TMP, **kw))
    theirs = JMP.serialize_model(_random_model(np.random.default_rng(1), JMP, **kw))
    assert ours == theirs
    back, want = TMP.parse_model(ours), JMP.parse_model(theirs)
    for field in ("model_type", "unk_id", "bos_id", "eos_id", "pad_id", "add_dummy_prefix",
                  "remove_extra_whitespaces", "escape_whitespaces", "normalizer_name"):
        assert getattr(back, field) == getattr(want, field), field
    assert [(p.piece, p.score, p.type) for p in back.pieces] == [
        (p.piece, p.score, p.type) for p in want.pieces]


# ------------------------------------------------------------------ train_bpe
def _corpus(seed, n=400):
    rng = np.random.default_rng(seed)
    words = ["我們", "可以", "交流", "台灣", "高速", "公路", "hello", "there", "ok", "很大",
             "的", "問題", "ＡＢ", "x y"]
    return [" ".join(rng.choice(words, rng.integers(1, 8))) + ("\t" if i % 7 == 0 else "")
            for i in range(n)]


def _pieces(model):
    return [(p.piece, p.score, p.type) for p in model.pieces]


@pytest.mark.parametrize("kw", [
    {"vocab_size": 60}, {"vocab_size": 40, "character_coverage": 0.9},
    {"vocab_size": 200, "max_piece_length": 3},
    {"vocab_size": 64, "user_defined_symbols": ["<pad>", "[LAUGH]", "[NOISE]"]},
    {"vocab_size": 12}])
def test_train_bpe_equals_the_jax_trainer(kw):
    lines = _corpus(2)
    ours, theirs = TT.train_bpe(lines, **kw), JT.train_bpe(lines, **kw)
    assert _pieces(ours) == _pieces(theirs)
    assert len(ours.pieces) <= kw["vocab_size"]
    assert ours.character_coverage == theirs.character_coverage
    assert TMP.serialize_model(ours) == JMP.serialize_model(theirs)


def test_write_artifacts_and_train_from_files_equal_the_jax_files(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(_corpus(3)), encoding="utf-8")
    sides = {}
    for name, mod in (("jax", JT), ("port", TT)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        sides[name] = mod.train_from_files([str(corpus)], "tok/spm", 72,
                                           vocab_json_path="tok/vocab.json")
    files = {n: _files(tmp_path / n / "tok", ARTIFACTS) for n in sides}
    assert files["port"] == files["jax"]
    text = "我們可以 交流 hello there ok 台灣"
    assert sides["port"].encode(text) == sides["jax"].encode(text)
    written = load_tokenizer(str(tmp_path / "port/tok/spm.model"))
    assert written.encode(text) == sides["port"].encode(text)
    assert written.decode(written.encode(text)) == jax_load_tokenizer(
        str(tmp_path / "port/tok/spm.model")).decode(written.encode(text))


# ---------------------------------------------------------- tokenizer_train
def _two_language_corpus(root):
    rng = np.random.default_rng(4)
    zh = ["我們可以交流", "台灣的高速公路很大", "沒有問題", "一個大的交流道"]
    en = ["hello there", "the highway is wide", "no problem at all", "we can talk"]
    base = root / "corpus"
    base.mkdir()
    for lang, sentences in (("zh", zh), ("en", en)):
        records = [{"sentence": s, "text": s if lang == "zh" else "",
                    "normalized_sentence": s.upper()}
                   for s in rng.choice(sentences, 40)]
        records.append({"text": "x" * 90})       # over max_len
        records.append({"text": " "})            # under min_len
        (base / f"cv_{lang}_part.json").write_text(json.dumps(records, ensure_ascii=False),
                                                   encoding="utf-8")
    return base


def _tokenizer_config(root, base):
    cfg = {"corpus": {"lang_prefix": "cv", "base_path": os.path.relpath(base, root),
                      "text_field": "normalized_sentence", "min_len": 2, "max_len": 80},
           "tokenizer": {"model_prefix": "spm", "vocab_size": 70,
                         "character_coverage": 0.9995, "extra_user_symbols": ["[NOISE]"]},
           "output": {"dir": "tok", "export_vocab_json": "vocab.json"}}
    path = root / "tok.yaml"
    path.write_text(json.dumps(cfg, ensure_ascii=False), encoding="utf-8")  # JSON is YAML
    return path


def test_tokenizer_train_cli_writes_the_jax_scripts_files(tmp_path, monkeypatch):
    import tokenizer_train as jax_cli

    from fddm_asr_tpu_torch.scripts import tokenizer_train as cli

    files = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        root = tmp_path / name
        root.mkdir()
        cfg = _tokenizer_config(root, _two_language_corpus(root))
        monkeypatch.chdir(root)
        main(["--config", "tok.yaml"])
        files[name] = _files(root / "tok", ARTIFACTS)
        assert cfg.exists()
    assert files["port"] == files["jax"]
    sidecar = json.loads(files["port"]["vocab.json"])
    assert sidecar["vocab_size"] == 70 and "[NOISE]" in sidecar["token2id"]
    assert sidecar["special_token_ids"] == {"unk_id": 0, "bos_id": 1, "eos_id": 2, "pad_id": 3}
    assert jax_cli.discover_corpus_files("corpus", "cv") == cli.discover_corpus_files(
        "corpus", "cv") == ["corpus/cv_en_part.json", "corpus/cv_zh_part.json"]


def test_tokenizer_train_prefers_merged_manifests_and_filters_like_jax(tmp_path):
    import tokenizer_train as jax_cli

    from fddm_asr_tpu_torch.scripts import tokenizer_train as cli

    base = _two_language_corpus(tmp_path)
    for name in ("test.json", "train.json"):
        (base / name).write_text(json.dumps([{"sentence": "只有句子"}, {"text": 12345},
                                             {"text": None, "sentence": ""}]),
                                 encoding="utf-8")
    files = cli.discover_corpus_files(str(base), "cv")
    assert files == jax_cli.discover_corpus_files(str(base), "cv")
    assert [os.path.basename(f) for f in files] == ["train.json", "test.json"]
    for field, lo, hi in (("text", 1, None), ("missing", 5, 4), ("sentence", 0, 0)):
        assert list(cli.corpus_lines(files, field, lo, hi)) == list(
            jax_cli.corpus_lines(files, field, lo, hi))


def test_export_vocab_json_equals_the_jax_sidecar(tmp_path, monkeypatch):
    import tokenizer_train as jax_cli

    from fddm_asr_tpu_torch.scripts import tokenizer_train as cli

    monkeypatch.chdir(tmp_path)
    JT.write_artifacts(JT.train_bpe(_corpus(5), 50), "spm")
    cli._export_vocab_json(load_tokenizer("spm.model"), "spm", "port.json")
    jax_cli._export_vocab_json(jax_load_tokenizer("spm.model"), "spm", "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_the_port_never_trains_with_sentencepiece(tmp_path, monkeypatch):
    """A sentencepiece module that can be imported is not used: the port's
    own trainer writes the artifacts (the JAX script would call it)."""
    from fddm_asr_tpu_torch.scripts import tokenizer_train as cli

    fake = types.ModuleType("sentencepiece")

    class Trainer:
        @staticmethod
        def train(**kw):
            raise AssertionError("sentencepiece was called")

    fake.SentencePieceTrainer = Trainer
    monkeypatch.setitem(sys.modules, "sentencepiece", fake)
    cfg = _tokenizer_config(tmp_path, _two_language_corpus(tmp_path))
    monkeypatch.chdir(tmp_path)
    cli.main(["--config", str(cfg)])
    lines = list(cli.corpus_lines(cli.discover_corpus_files("corpus", "cv"),
                                  "normalized_sentence", 2, 80))
    model = JT.train_bpe(lines, 70, user_defined_symbols=["[NOISE]"])
    assert (tmp_path / "tok/spm.model").read_bytes() == JMP.serialize_model(model)
    for path in (cli.__file__, TT.__file__):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert "sentencepiece" not in imported


# ------------------------------------------------- init_random_ckpt's tokenizer
@pytest.mark.parametrize("vocab_size", [5, 40, 8000])
def test_synthetic_tokenizer_files_equal_the_jax_scripts(tmp_path, monkeypatch, vocab_size):
    import init_random_ckpt as jax_cli

    from fddm_asr_tpu_torch.scripts import init_random_ckpt as cli

    for name, make in (("jax", jax_cli._make_synthetic_tokenizer),
                       ("port", cli.make_synthetic_tokenizer)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert make(os.path.join("tok", "spm_synth"), vocab_size) == "tok/spm_synth.model"
    names = ("spm_synth.model", "spm_synth.vocab", "vocab.json")
    assert _files(tmp_path / "port/tok", names) == _files(tmp_path / "jax/tok", names)
    tok = load_tokenizer(str(tmp_path / "port/tok/spm_synth.model"))
    assert tok.vocab_size() == vocab_size


@pytest.mark.parametrize("vocab_size", [4, 0x9FFF - 0x4E00 + 6])
def test_synthetic_tokenizer_refuses_what_the_jax_script_refuses(tmp_path, vocab_size):
    import init_random_ckpt as jax_cli

    from fddm_asr_tpu_torch.scripts import init_random_ckpt as cli

    for make in (jax_cli._make_synthetic_tokenizer, cli.make_synthetic_tokenizer):
        with pytest.raises(ValueError, match="vocab_size"):
            make(str(tmp_path / "spm_synth"), vocab_size)
