# -*- coding: utf-8 -*-
"""The port's CLI (`python -m fddm_asr_tpu_torch.inference`) on the CPU at
the tiny config of `test_torch_pipeline.py`, from a YAML config: every flag
of the JAX CLI that the port takes, and the JSON it prints, line by line and
field by field against the JAX CLI's (run in-process on the same tiny JAX
pipeline).  Ids are exact where both sides are given the same generator;
the schema comparison is of keys and JSON types."""
import csv
import json
import sys

import numpy as np
import pytest
import torch
import yaml

import inference as jax_cli
from fddm_asr_tpu import runtime as jax_runtime
from fddm_asr_tpu_torch import inference as cli
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import load_pretrained_wavlm
from fddm_asr_tpu_torch.data.audio_io import load_audio, save_wav
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from fddm_asr_tpu_torch.sampler import split_generator
from fddm_asr_tpu_torch.tokenizer import load_tokenizer
from test_torch_pipeline import CFG, pipelines  # noqa: F401  (module fixture)

SR, SEQ_LEN = 16000, 8
SECONDS = (0.42, 0.31, 0.55, 0.2, 0.47)


@pytest.fixture(scope="module")
def files(pipelines, tmp_path_factory):
    """YAML configs, five WAVs with a CSV (path, text, sentence, alt), a
    2.2 s WAV and an HF WavLM directory."""
    *_, ckpt, vocab = pipelines
    tmp = tmp_path_factory.mktemp("cli")
    (tmp / "main.yaml").write_text(yaml.safe_dump(CFG, default_flow_style=False))
    (tmp / "diffusion.yaml").write_text("diffusion:\n  T: 200\n  beta_max: 0.2\n")
    rng = np.random.default_rng(0)
    rows = []
    for i, s in enumerate(SECONDS):
        path = str(tmp / f"u{i}.wav")
        save_wav(path, 0.3 * rng.standard_normal(int(s * SR)).astype(np.float32), SR)
        rows.append({"path": path, "text": ["一丁", "", "七万", "007", "丈"][i],
                     "sentence": "三上", "alt": "下"})
    with open(tmp / "set.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["path", "text", "sentence", "alt"])
        w.writeheader()
        w.writerows(rows)
    long_path = str(tmp / "long.wav")
    x = 0.3 * rng.standard_normal(int(2.2 * SR)).astype(np.float32)
    x[12000:15000] *= 0.01
    save_wav(long_path, x, SR)

    from transformers import WavLMConfig as HFConfig
    from transformers import WavLMModel as HFModel

    torch.manual_seed(1)
    HFModel(HFConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=[16] * 7, conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
        num_buckets=32, max_bucket_distance=80, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4)).save_pretrained(str(tmp / "hf"))
    # a random decoder under model.init_scheme "torch": more sensitive to
    # x_t than the default flax init, so sampler options show in its ids
    torch_init = Config(CFG).updated({"model": {"init_scheme": "torch"}})
    torch.save(FDDMPipeline.from_config(torch_init, tokenizer=object(),
                                        device="cpu").decoder.state_dict(),
               str(tmp / "torch_init.pt"))
    base = ["--ckpt", ckpt, "--main-config", str(tmp / "main.yaml"),
            "--diffusion-config", str(tmp / "diffusion.yaml"), "--tokenizer", vocab,
            "--greedy", "--seq-len", str(SEQ_LEN), "--device", "cpu"]
    return {"dir": tmp, "csv": str(tmp / "set.csv"), "wavs": [r["path"] for r in rows],
            "long": long_path, "hf": str(tmp / "hf"), "base": base,
            "torch_init": str(tmp / "torch_init.pt")}


def _run(main, argv, capsys):
    """main(argv) -> the JSON values it printed (one per line, or one
    indented object)."""
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out.strip()
    if out.startswith("{\n"):
        return [json.loads(out)]
    return [json.loads(line) for line in out.splitlines()]


def _schema(v):
    if isinstance(v, dict):
        return {k: _schema(x) for k, x in v.items()}
    if isinstance(v, list):
        return ["list", _schema(v[0]) if v else None]
    return type(v).__name__


@pytest.fixture
def jax_main(pipelines, monkeypatch):
    """The JAX CLI's main on the tiny JAX pipeline (its mask flag restored
    after), without its on-disk compile cache."""
    jp, *_ = pipelines
    monkeypatch.setattr(jp, "use_condition_mask", jp.use_condition_mask)
    monkeypatch.setattr(jax_cli, "build_pipeline", lambda args: jp)
    monkeypatch.setattr(jax_runtime, "enable_compile_cache", lambda *a, **k: None)
    return jax_cli.main


def _csv_args(files, *extra):
    return ["--csv", files["csv"], *files["base"], "--batch-size", "3",
            "--bucket-seconds", "0.25", "--num-candidates", "2", "--confidence", *extra]


def test_csv_rows_and_summary_have_the_jax_schema(files, capsys, jax_main):
    got = _run(cli.main, _csv_args(files), capsys)
    want = _run(jax_main, _csv_args(files), capsys)
    assert len(got) == len(want) == len(SECONDS) + 1
    assert [_schema(r) for r in got] == [_schema(r) for r in want]
    assert set(got[0]) == {"wav", "text", "ids", "T_infer", "r", "greedy", "posterior_mode",
                           "confidence", "ref", "cer"}
    assert got[-1]["summary"] == "cer" and got[-1]["utterances"] == len(SECONDS)
    assert got[-1]["avg_cer"] == pytest.approx(np.mean([r["cer"] for r in got[:-1]]))
    assert [r["ref"] for r in got[:-1]] == ["一丁", "", "七万", "007", "丈"]
    assert [r["ref"] for r in want[:-1]] == [r["ref"] for r in got[:-1]]


def test_csv_cells_are_read_as_text(tmp_path):
    """Not copied from the JAX CLI: pandas reads a column of digits alone as
    numbers, so its references here would be "7.0", "12.0" and ""; the port
    keeps every cell's text."""
    path = tmp_path / "digits.csv"
    path.write_text("path,text\na.wav,007\nb.wav,12\nc.wav,\n", encoding="utf-8")
    assert cli.read_csv(str(path), None) == (["a.wav", "b.wav", "c.wav"], ["007", "12", ""])


def test_csv_ids_are_the_pipelines_with_a_split_generator_per_batch(files, capsys,
                                                                    monkeypatch):
    """Batches of three, padded to the next 0.25 s and to three rows (a
    dummy row of 400 samples in the last), the mask on, best-of-2, and per
    batch a step generator split off the seed's."""
    shapes = []
    original = FDDMPipeline.transcribe_with_ids

    def spy(self, wave, lengths=None, **kw):
        shapes.append((np.asarray(wave).shape, list(lengths)))
        return original(self, wave, lengths, **kw)

    monkeypatch.setattr(FDDMPipeline, "transcribe_with_ids", spy)
    got = _run(cli.main, _csv_args(files, "--seed", "3"), capsys)[:-1]
    assert [s for s, _ in shapes] == [(3, 12000), (3, 8000)]
    assert shapes[1][1][2] == 400

    args = cli.parse_args(_csv_args(files, "--seed", "3"))
    pipe = cli.build_pipeline(args)
    pipe.use_condition_mask = True
    root = torch.Generator().manual_seed(3)
    want = []
    for start, (shape, lengths) in zip((0, 3), shapes):
        batch = np.zeros(shape, np.float32)
        for j, p in enumerate(files["wavs"][start:start + 3]):
            w = load_audio(p, target_sr=SR)[0]
            batch[j, :len(w)] = w
        rows = original(pipe, batch, np.asarray(lengths), seq_len=SEQ_LEN,
                        generator=split_generator(root), with_confidence=True,
                        num_candidates=2, T_infer=20, r=5, greedy=True)
        want += rows[:len(files["wavs"][start:start + 3])]
    assert [r["ids"] for r in got] == [w[1] for w in want]
    assert [r["confidence"] for r in got] == [round(w[2], 6) for w in want]


@pytest.mark.parametrize("column,refs", [(None, None), ("alt", ["下"] * 5)])
def test_reference_column_and_its_fallback(files, capsys, tmp_path, column, refs):
    extra = [] if column is None else ["--ref-column", column]
    got = _run(cli.main, _csv_args(files, *extra), capsys)
    assert [r["ref"] for r in got[:-1]] == (refs or ["一丁", "", "七万", "007", "丈"])
    no_text = tmp_path / "no_text.csv"
    with open(files["csv"], encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    with open(no_text, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["path", "sentence"])
        w.writeheader()
        w.writerows({"path": r["path"], "sentence": r["sentence"]} for r in rows)
    got = _run(cli.main, ["--csv", str(no_text), *files["base"]], capsys)
    assert [r["ref"] for r in got[:-1]] == ["三上"] * 5 and got[-1]["summary"] == "cer"


@pytest.mark.parametrize("align", ["fixed", "silence"])
def test_chunked_wav_has_the_jax_schema(files, capsys, jax_main, align):
    argv = ["--wav", files["long"], *files["base"], "--chunk-seconds", "0.5",
            "--chunk-align", align, "--confidence", "--batch-size", "2"]
    (got,) = _run(cli.main, argv, capsys)
    (want,) = _run(jax_main, argv, capsys)
    assert _schema(got) == _schema(want)
    assert got["chunk_align"] == align and got["chunk_seconds"] == 0.5
    assert len(got["chunks"]) == len(got["ids"]) == len(want["chunks"])
    assert got["text"] == "".join(got["chunks"])


def test_wavlm_ckpt_reaches_the_encoder(files, capsys):
    argv = ["--wav", files["wavs"][0], *files["base"]]
    (plain,) = _run(cli.main, argv, capsys)
    (hf,) = _run(cli.main, [*argv, "--wavlm-ckpt", files["hf"]], capsys)
    pipe = FDDMPipeline.from_config(
        Config(CFG), ckpt_path=files["base"][1], tokenizer=load_tokenizer(files["base"][-6]),
        wavlm_state_dict=load_pretrained_wavlm(files["hf"])[1], device="cpu")
    wav = load_audio(files["wavs"][0], target_sr=SR)[0]
    want = pipe.transcribe_with_ids(wav, seq_len=SEQ_LEN, generator=torch.Generator().manual_seed(0),
                                    T_infer=20, r=5, greedy=True)
    assert hf["ids"] == want[0][1] and hf["ids"] != plain["ids"]


@pytest.mark.parametrize("flag,sampling", [
    (["--corrected-posterior"], {"ref_compat": False}),
    (["--repeat-penalty", "30"], {"repeat_penalty": 30.0}),
    (["--num-candidates", "3"], {"num_candidates": 3}),
])
def test_opt_in_sampling_flags_change_the_output(files, capsys, flag, sampling):
    """Each opt-in flag changes the result (the ids, or where the tiny random
    decoder's argmax does not move, the confidence: the last step's p_x0)
    and gives exactly the pipeline's result under the keyword it maps to.
    The decoder is the port's random one; two jumps from t = 100: where a_cum is not small beside b_cum, so the
    two posteriors differ (at t near T, a_cum ~ 0 and the b_cum scale
    cancels in the normalisation)."""
    argv = ["--wav", files["long"], *files["base"], "--seq-len", "24", "--T-infer", "100",
            "--r", "50", "--confidence", "--ckpt", files["torch_init"]]
    (base,) = _run(cli.main, argv, capsys)
    (got,) = _run(cli.main, [*argv, *flag], capsys)
    assert (got["ids"], got["confidence"]) != (base["ids"], base["confidence"])
    pipe = cli.build_pipeline(cli.parse_args(argv))
    wav = load_audio(files["long"], target_sr=SR)[0]
    want = pipe.transcribe_with_ids(wav, seq_len=24, generator=torch.Generator().manual_seed(0),
                                    with_confidence=True, T_infer=100, r=50, greedy=True,
                                    **sampling)
    assert got["ids"] == want[0][1] and got["confidence"] == round(want[0][2], 6)


def test_gpu_is_accepted_and_ignored(files, capsys):
    argv = ["--wav", files["wavs"][2], *files["base"]]
    assert _run(cli.main, [*argv, "--gpu", "3"], capsys) == _run(cli.main, argv, capsys)


@pytest.mark.parametrize("flag,error,match", [
    (["--mesh", "data=2"], ValueError, r"torchrun --nproc_per_node 2"),
    (["--mesh", "model=2"], ValueError, r"torchrun --nproc_per_node 2"),
], ids=["flag0", "flag1"])
def test_multi_device_flags_raise(files, flag, error, match):
    """In one process a two-rank mesh names the launcher that makes one
    process a GPU, over "data" and over "model" (tensor parallelism) alike
    (the multi-process runs: test_torch_parallel.py,
    test_torch_tensor_parallel.py)."""
    with pytest.raises(error, match=match):
        cli.main(["--wav", files["wavs"][0], *files["base"], *flag])


def test_stats_json_counts_the_run(files, capsys, tmp_path):
    stats = tmp_path / "stats.json"
    _run(cli.main, ["--wav", files["wavs"][0], *files["base"], "--stats-json", str(stats)],
         capsys)
    got = json.loads(stats.read_text())
    assert got["transcribe_s"] > 0 and got["build_s"] > 0
    assert set(got["launches"]) >= {"fwd", "int8_matmul_fused", "conv_ln_gelu"}
    assert not any(got["launches"].values())  # the CPU runs the plain versions
