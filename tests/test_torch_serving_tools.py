# -*- coding: utf-8 -*-
"""The port's serving tools and transcribe profilers against the
repository's JAX scripts, on the CPU at tiny sizes, over a corpus and a
random-init checkpoint the port's `make_synth_data` and `init_random_ckpt`
write (made from a seed):

  bench_serve          one window (--duration-s 1 --concurrency 2), --direct
                       and --stream, each printing the JAX script's keys,
                       against a tiny port server built in process;
  stream_post          the JAX script's socket code and the port's get the
                       same partials and final from the same server;
  stream_client        NDJSON partials and the final on stdout, the timing
                       summary on stderr;
  inspect_transcripts  at the JAX pipeline's weights (the encoder carried
                       across) and one injected x_init on both sides, the
                       summary and rows equal the JAX script's;
  profile_step         `build_transcribe`'s ids equal the JAX one's at
                       carried weights (WavLM-large's constructor giving the
                       test config on both sides) and one x_T, both built in
                       float32 (torch's CPU bf16 grouped conv is wrong at the
                       test config's positional conv: 32 channels, 4 groups,
                       an even kernel); a CPU profile's listing holds one
                       track, its ops sorted by time.

Every script that builds a model raises without a GPU unless given
--device cpu."""
import json
import os
import re
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu import pipeline as JP
from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu_torch import serve
from fddm_asr_tpu_torch.config import load_config
from fddm_asr_tpu_torch.convert import (acoustic_encoder_state_dict_from_jax_params,
                                        decoder_state_dict_from_jax_params)
from fddm_asr_tpu_torch.data.audio_io import save_wav
from fddm_asr_tpu_torch.scripts import bench_serve as BS
from fddm_asr_tpu_torch.scripts import init_random_ckpt as INIT
from fddm_asr_tpu_torch.scripts import inspect_transcripts as IT
from fddm_asr_tpu_torch.scripts import make_synth_data as SYNTH
from fddm_asr_tpu_torch.scripts import profile_step as PS
from fddm_asr_tpu_torch.scripts import stream_client as SC
from test_torch_host_tools import jax_script, tiny_wavlm  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


def jax_keys(pattern_start: str, pattern_end: str):
    """The keys of the dict literal the JAX bench_serve.py prints between
    two markers of its source."""
    with open(os.path.join(REPO, "scripts/bench_serve.py"), encoding="utf-8") as f:
        source = f.read()
    start = source.index(pattern_start)
    block = source[start:source.index(pattern_end, start)]
    keys = re.findall(r'^(\s*)"(\w+)":', block, re.M)
    return {k for indent, k in keys if indent == keys[0][0]}  # the top level only


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The smoke corpus, its config and tokenizer, and a random-init `.pt`."""
    out = tmp_path_factory.mktemp("synth")
    SYNTH.main(["--out", str(out), "--n", "4", "--seconds", "0.5"])
    INIT.main(["--config", str(out / "config.yaml"), "--out", str(out / "random.pt"),
               "--device", "cpu"])
    return out


def _server_argv(synth, *extra):
    return ["--config", str(synth / "config.yaml"), "--ckpt", str(synth / "random.pt"),
            "--device", "cpu", *extra]


# -------------------------------------------------------------- bench_serve
HTTP_KEYS = jax_keys('result = {\n            "metric": "serve_rtfx"', "}\n        print")
STREAM_KEYS = jax_keys('result = {\n        "metric": "serve_stream_rtfx"', "}\n    if errors")
DIRECT_KEYS = jax_keys('json.dumps({\n        "metric": "serve_direct_rtfx"', "}))")


@pytest.mark.parametrize("mode", ["http", "direct", "stream"])
def test_bench_serve_prints_the_jax_scripts_keys(synth, mode, capsys):
    assert {"serve_rtfx", "windows", "iqr", "engine_rtfx_device", "stage_ms", "latency_ms",
            "mean_batch_size", "cold_start_s"} <= HTTP_KEYS | {"serve_rtfx"}
    extra = {"http": [], "direct": ["--direct"],
             "stream": ["--stream", "--window-seconds", "0.4", "--pace", "0"]}[mode]
    results = BS.main([*_server_argv(synth), "--duration-s", "1", "--concurrency", "2",
                       "--audio-seconds", "1", "--max-batch", "2", *extra])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")
               and "metric" in x]
    assert printed == json.loads(json.dumps(results)) and len(printed) == 1
    line = printed[0]
    want = {"http": HTTP_KEYS, "direct": DIRECT_KEYS, "stream": STREAM_KEYS}[mode]
    assert len(want) > 10 and want <= set(line), sorted(want - set(line))
    assert line["errors"] == 0 and line["platform"] == "cpu"
    assert line[{"stream": "streams"}.get(mode, "requests")] > 0
    assert line["value"] > 0 and line["cold_start_s"]["build"] > 0
    if mode == "stream":
        assert line["partials_per_stream"] >= 1 and "first_error" not in line
    if mode == "http":
        assert line["serving"] == "live" and line["mean_batch_size"] >= 1


def test_bench_serve_refuses_what_the_jax_script_refuses(synth, capsys):
    for argv in (["--exported", "x", "--config", "c"], ["--config", "c"]):
        with pytest.raises(SystemExit) as e:
            BS.main(argv)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "mutually exclusive" in err and "either --exported or both --config and --ckpt" in err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BS.main(_server_argv(synth)[:-2] + ["--duration-s", "1"])


# ------------------------------------------------- stream_post, stream_client
@pytest.fixture(scope="module")
def server(synth):
    """A tiny port server on the CPU whose engine waits 0.4 s to fill a
    batch of up to 4, so a stream's windows meet in one batch."""
    srv = serve.build_server(serve.parse_args(_server_argv(
        synth, "--port", "0", "--max-batch", "4", "--max-wait-ms", "400")))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.engine.shutdown()


def _pcm(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(seconds * 16000)) * 3000
            ).astype("<i2")


def test_stream_post_gets_what_the_jax_scripts_socket_code_gets(server):
    jax_cli = jax_script("bench_serve")
    pcm = _pcm(1.2, 3).tobytes()
    got = {}
    for side, post in (("jax", jax_cli.stream_post), ("port", BS.stream_post)):
        server.engine._rng_counter = 0  # each stream's batch drawn from the same seed
        lines = []
        rec = post("127.0.0.1", server.server_address[1], pcm, window_seconds=0.4,
                   on_line=lines.append)
        got[side] = (lines, rec)
    (lines, rec), (jlines, jrec) = got["port"], got["jax"]
    assert lines == jlines and rec["final"] == jrec["final"] == lines[-1]
    assert rec["partials"] == jrec["partials"] == len(lines) - 1 >= 2
    assert len(rec["final"]["chunks"]) == rec["partials"]
    assert rec["first_partial_ms"] > 0 and rec["final_after_eos_ms"] >= 0
    with pytest.raises(RuntimeError, match="status=400"):
        BS.stream_post("127.0.0.1", server.server_address[1], pcm, fmt="pcm8")


def test_stream_client_prints_partials_then_the_final(server, tmp_path, capsys):
    wav = tmp_path / "clip.wav"
    save_wav(str(wav), _pcm(1.0, 4).astype(np.float32) / 32768.0, 16000)
    final = SC.main(["--url", f"http://127.0.0.1:{server.server_address[1]}", "--wav",
                     str(wav), "--pace", "0", "--window-seconds", "0.3"])
    captured = capsys.readouterr()
    lines = [json.loads(x) for x in captured.out.splitlines()]
    summary = json.loads(captured.err.strip().splitlines()[-1])
    assert lines[-1] == final and len(lines) >= 3
    assert all("chunk_index" in x for x in lines[:-1]) and "chunks" in final
    assert summary["partials"] == len(lines) - 1 and summary["audio_s"] == 1.0
    assert set(summary) == {"audio_s", "upload_s", "partials", "first_partial_ms",
                            "final_after_eos_ms"}


# ------------------------------------------------------- inspect_transcripts
def test_inspect_transcripts_equals_the_jax_script(synth, tmp_path, monkeypatch, capsys):
    jax_cli = jax_script("inspect_transcripts")
    from fddm_asr_tpu import runtime

    cfg_path, ckpt = str(synth / "config.yaml"), str(synth / "random.pt")
    cfg = load_config(cfg_path)
    manifest = str(synth / "data/processed/test.json")
    seq_len = int(cfg.data.max_len)
    x_init = np.random.default_rng(9).integers(0, cfg.data.vocab_size, (3, seq_len))
    built = []
    from_config = JP.FDDMPipeline.from_config.__func__

    def recording(cls, *a, **k):
        built.append(from_config(cls, *a, **k))
        return built[-1]

    def with_x_init(decoder_apply, sched, scfg):
        base = JS.make_sample_fn(decoder_apply, sched, scfg)
        return lambda params, rng, cond, seq_len, c_mask=None: base(
            params, rng, cond, seq_len, c_mask, jnp.asarray(x_init))

    monkeypatch.setattr(runtime, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(JP.FDDMPipeline, "from_config", classmethod(recording))
    monkeypatch.setattr(JP, "make_sample_fn", with_x_init)
    jax_cli.main(["--config", cfg_path, "--ckpt", ckpt, "--manifest", manifest, "--n", "3",
                  "--device", "cpu", "--json", str(tmp_path / "jax.json")])
    monkeypatch.undo()
    theirs = json.loads((tmp_path / "jax.json").read_text(encoding="utf-8"))
    jax_printed = capsys.readouterr().out

    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    params = jax.tree.map(np.asarray, built[0].encoder_params["params"])
    pipe = FDDMPipeline.from_config(cfg, ckpt_path=ckpt,
                                    encoder_state_dict=acoustic_encoder_state_dict_from_jax_params(
                                        params),
                                    tokenizer=load_tokenizer(cfg.data.tokenizer_path),
                                    device="cpu")
    records = json.load(open(manifest, encoding="utf-8"))[:3]
    summary, rows = IT.inspect(pipe, records, seq_len, cfg.inference.T_infer, cfg.inference.r,
                               x_init=x_init)
    port_printed = capsys.readouterr().out
    summary.update({"T_infer": cfg.inference.T_infer, "r": cfg.inference.r, "seq_len": seq_len,
                    "ckpt": ckpt})
    assert summary == theirs["summary"] and rows == theirs["rows"]
    assert port_printed in jax_printed  # the same ref / hyp lines before the summary
    assert set(summary) >= {"distinct_hyps", "constant_collapse", "empty_hyps",
                            "p_x0_entropy", "p_x0_argmax_margin"}
    # the CLI: a .pt, the seed's encoder, its JSON artifact
    out = IT.main(["--config", cfg_path, "--ckpt", ckpt, "--manifest", manifest, "--n", "2",
                   "--device", "cpu", "--json", str(tmp_path / "port.json")])
    written = json.loads((tmp_path / "port.json").read_text(encoding="utf-8"))
    assert written["summary"] == out and len(written["rows"]) == 2 == out["n"]


def test_inspect_transcripts_refuses_orbax_and_a_missing_manifest(synth, tmp_path):
    orbax = tmp_path / "ep001.orbax"
    orbax.mkdir()
    cfg_path = str(synth / "config.yaml")
    manifest = str(synth / "data/processed/test.json")
    with pytest.raises(NotImplementedError, match="export_torch_encoder.py"):
        IT.main(["--config", cfg_path, "--ckpt", str(orbax), "--manifest", manifest,
                 "--device", "cpu"])
    with pytest.raises(SystemExit, match="manifest not found"):
        IT.main(["--config", cfg_path, "--ckpt", str(orbax), "--manifest",
                 str(tmp_path / "none.json"), "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IT.main(["--config", cfg_path, "--ckpt", str(synth / "random.pt"), "--manifest",
                 manifest])


# -------------------------------------------------------------- profile_step
def test_profile_step_transcribes_as_the_jax_build(tiny_wavlm, monkeypatch):
    jax_cli = jax_script("profile_step")
    B, seconds, seq_len = 2, 0.25, 8
    x_init = np.random.default_rng(5).integers(0, PS.K, (B, seq_len))
    make_sample_fn = JS.make_sample_fn

    def with_x_init(decoder_apply, sched, scfg):
        base = make_sample_fn(decoder_apply, sched, scfg)
        return lambda params, rng, cond, seq_len, c_mask=None: base(
            params, rng, cond, seq_len, c_mask, jnp.asarray(x_init))

    monkeypatch.setattr(JS, "make_sample_fn", with_x_init)
    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)  # the modules' dtype, while they are built
    transcribe, (enc_params, dec_params, wave) = jax_cli.build_transcribe(
        B, seconds, seq_len, True, 1, quant="none")
    monkeypatch.undo()
    theirs = np.asarray(transcribe(enc_params, dec_params, wave, jax.random.key(1)))

    from fddm_asr_tpu_torch.models.wavlm import WavLMConfig

    monkeypatch.setattr(PS, "DTYPE", torch.float32)  # as the JAX side's, above
    ours, (encoder, decoder, own_wave) = PS.build_transcribe(
        B, seconds, seq_len, True, 1, wavlm_config=WavLMConfig.tiny_for_tests(), device="cpu")
    assert tuple(own_wave.shape) == (B, 4000) and encoder.config.gelu_approx_tanh
    p = lambda tree: jax.tree.map(np.asarray, tree["params"])  # noqa: E731
    encoder.load_state_dict(acoustic_encoder_state_dict_from_jax_params(p(enc_params)))
    decoder.load_state_dict(decoder_state_dict_from_jax_params(p(dec_params)))
    ids = ours(torch.from_numpy(np.array(wave)), torch.Generator().manual_seed(1),
               x_init=torch.from_numpy(x_init))
    assert ids.shape == (B, seq_len)
    np.testing.assert_array_equal(ids.numpy(), theirs)


def test_profile_step_cpu_listing_holds_one_track_sorted(tiny_wavlm, tmp_path, capsys):
    result = PS.main(["--device", "cpu", "--batch", "1", "--seconds", "0.25", "--seq-len", "4",
                      "--iters", "2", "--top", "6", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    tracks = re.findall(r"^== track '(.+)': ([\d.]+) ms total ==$", out, re.M)
    assert len(tracks) == 1 and tracks[0][0].startswith("cpu thread")
    times = [float(ms) for ms in re.findall(r"^\s+([\d.]+) ms  \S", out, re.M)]
    assert len(times) == 6 and times == sorted(times, reverse=True)
    line = json.loads(out.strip().splitlines()[-1])["profile_step"]
    assert line == json.loads(json.dumps(result))
    assert line["iters"] == 2 and line["launches"] == {} and line["kernel_events"] == {}
    assert os.path.isfile(line["trace"]) and line["wall_ms"] > 0
    with open(line["trace"], encoding="utf-8") as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.main(["--batch", "1"])
