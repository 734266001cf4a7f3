# -*- coding: utf-8 -*-
"""The port's Common Voice preprocessing (`python -m
fddm_asr_tpu_torch.scripts.preprocess`) against `scripts/preprocess.py` on
the same synthetic dump: two dataset versions, two languages, 48 kHz WAV
clips (made from a seed with numpy), exact and near-duplicate sentences, a
sentence that normalizes to nothing, a clip of 0.05 s and one of 31 s, a
missing clip, the same audio under two sentences, a TSV with `filename` /
`text` columns and a `validation.tsv` for the dev split.  Each side runs in
a working directory of its own (the scripts write relative paths), with
and without --enable_audio_hash; the manifests (.json, .csv), the clips,
duplicates_removed.json and merge_report.json (its timestamp aside) must
be byte for byte the JAX script's."""
import json
import os
import shutil
import sys

import numpy as np
import pytest

from fddm_asr_tpu_torch.data.audio_io import save_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

SR = 48000


def _dump(root):
    """data/raw/<version>/<lang>/{clips/, *.tsv} under `root`."""
    rng = np.random.default_rng(11)

    def clip(path, seconds, seed=None):
        r = rng if seed is None else np.random.default_rng(seed)
        save_wav(str(path), (0.1 * r.standard_normal(int(SR * seconds))).astype(np.float32), SR)

    zh = [("我們可以一起在台灣的高速公路上交流很多事情了", 0.6),
          ("我們可以一起在台灣的高速公路上交流很多事情呀", 0.5),   # a near duplicate
          ("台灣的高速公路（國道）很大", 0.7), ("(註記) 沒有問題!", 0.4),
          ("短", 0.05), ("很長的一句話", 31.0), ("()", 0.5), ("我們有一個問題", 0.3)]
    en = [("Hello there, General Kenobi.", 0.5), ("hello there general kenobi", 0.4),
          ("The highway is WIDE", 0.45), ("missing clip", None)]
    for version in ("cv-v1", "cv-v2"):
        for lang, rows in (("zh-TW", zh), ("en", en)):
            d = root / "data/raw" / version / lang
            (d / "clips").mkdir(parents=True)
            lines = []
            for i, (sentence, seconds) in enumerate(rows):
                name = f"{lang}_{version}_{i}.wav"
                if seconds is not None:
                    clip(d / "clips" / name, seconds)
                lines.append((name, sentence))
            # the same audio as the first clip under a sentence of its own
            shutil.copy(d / "clips" / lines[0][0], d / "clips" / "copy.wav")
            lines.append(("copy.wav", f"{version} {lang} 同一段聲音"))
            path_col, text_col = (("filename", "text") if version == "cv-v2" and lang == "en"
                                  else ("path", "sentence"))
            body = "\n".join([f"client_id\t{path_col}\t{text_col}\tup_votes"]
                             + [f"c{i}\t{p}\t{s}\t{i}" for i, (p, s) in enumerate(lines)])
            (d / "train.tsv").write_text(body + "\n\n", encoding="utf-8")
            # dev: two sentences of its own a version, one shared by both versions
            dev_rows = []
            for k, sentence in enumerate((f"開發{version}第一句", f"dev {version} two",
                                          "兩個版本都有的句子")):
                clip(d / "clips" / f"dev{k}.wav", 0.3 + 0.1 * k)
                dev_rows.append(f"d{k}\tdev{k}.wav\t{sentence}\t0")
            dev = "validation.tsv" if version == "cv-v2" else "dev.tsv"
            (d / dev).write_text("\n".join([body.split("\n")[0]] + dev_rows),
                                 encoding="utf-8")
    return root


OUTPUTS = ("train.json", "train.csv", "dev.json", "dev.csv", "duplicates_removed.json")


def _outputs(root):
    processed = root / "data/processed"
    files = {n: (processed / n).read_bytes() for n in OUTPUTS}
    files.update({f"clips/{n}": (processed / "clips" / n).read_bytes()
                  for n in sorted(os.listdir(processed / "clips"))})
    report = json.loads((processed / "merge_report.json").read_text(encoding="utf-8"))
    assert report["merge_summary"].pop("processing_timestamp")
    assert not [n for n in os.listdir(processed) if n.startswith("_tmp_")]
    return files, report


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    return _dump(tmp_path_factory.mktemp("dump"))


@pytest.mark.parametrize("flags", [[], ["--enable_audio_hash"],
                                   ["--language", "zh-TW", "--text_similarity_threshold", "0.8",
                                    "--dataset_names", "cv-v2,cv-v9"]],
                         ids=["text", "audio_hash", "one_language"])
def test_preprocess_writes_the_jax_scripts_files(template, tmp_path, monkeypatch, flags):
    import preprocess as jax_cli

    from fddm_asr_tpu_torch.scripts import preprocess as cli

    argv = ["--auto_merge", "--splits", "train,dev,test", "--batch_size", "2", *flags]
    out = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        shutil.copytree(template / "data", tmp_path / name / "data")
        monkeypatch.chdir(tmp_path / name)
        main(argv)
        out[name] = _outputs(tmp_path / name)
    (files, report), (want_files, want_report) = out["port"], out["jax"]
    assert sorted(files) == sorted(want_files)
    for n in want_files:
        assert files[n] == want_files[n], n
    assert report == want_report
    g = report["global_statistics"]
    assert g["total_processed"] > 0 and g["invalid_files"] > 0 and g["duplicates_removed"] > 0
    reasons = {d["reason"] for d in g["duplicates_detail"]}
    assert any(r.startswith("similar") for r in reasons)
    assert ("exact text match" in reasons) == ("--language" not in flags)  # across versions
    assert ("identical audio hash" in reasons) == ("--enable_audio_hash" in flags)
    train = json.loads(files["train.json"])
    assert all(0.1 <= r["duration"] <= 30.0 for r in train)
    assert {r["processed_path"] for r in train} <= {os.path.join("data/processed", n)
                                                    for n in files if n.startswith("clips/")}


def test_stale_temps_are_cleared_as_in_jax(template, tmp_path, monkeypatch):
    from fddm_asr_tpu_torch.scripts import preprocess as cli

    shutil.copytree(template / "data", tmp_path / "data")
    processed = tmp_path / "data/processed"
    processed.mkdir()
    ghost = [{"path": "ghost.wav", "sentence": "ghost", "text": "ghost", "duration": 1.0,
              "processed_path": "ghost16.wav", "language": "en", "dataset": "cv-v0",
              "split": "train", "audio_hash": None}]
    (processed / "_tmp_train_cv-v0_en_000000.json").write_text(json.dumps(ghost))
    monkeypatch.chdir(tmp_path)
    cli.main(["--auto_merge", "--splits", "train"])
    texts = [r["text"] for r in json.loads((processed / "train.json").read_text("utf-8"))]
    assert "ghost" not in texts and len(texts) == len(set(texts))


def test_tsv_reader_and_dedup_index_equal_the_jax_ones(template):
    import preprocess as jax_cli

    from fddm_asr_tpu_torch.scripts import preprocess as cli

    for version, lang in (("cv-v1", "zh-TW"), ("cv-v2", "en")):
        d = str(template / "data/raw" / version / lang)
        for split in ("train", "dev"):
            df = jax_cli.read_split_tsv(d, split)
            assert cli.read_split_tsv(d, split) == list(zip(df["path"], df["sentence"]))
        with pytest.raises(FileNotFoundError):
            cli.read_split_tsv(d, "test")
    rng = np.random.default_rng(12)
    alphabet = list("我們可以一起交流了呀台灣")
    texts = ["".join(rng.choice(alphabet, rng.integers(1, 12))) for _ in range(300)]
    for threshold in (0.8, 0.95, 1.0):
        ours, theirs = cli.DedupIndex(threshold), jax_cli.DedupIndex(threshold)
        for t in texts:
            got, want = ours.check(t), theirs.check(t)
            assert got == want, t
            if not got[0]:
                ours.add(t)
                theirs.add(t)


def test_a_tsv_without_the_columns_raises(tmp_path):
    from fddm_asr_tpu_torch.scripts import preprocess as cli

    (tmp_path / "train.tsv").write_text("client_id\tfile\tcaption\nc\ta.wav\thi\n")
    with pytest.raises(KeyError, match="'path'"):
        cli.read_split_tsv(str(tmp_path), "train")
