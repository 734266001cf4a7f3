# -*- coding: utf-8 -*-
"""The port's batching HTTP server (`fddm_asr_tpu_torch/serve.py`) on the CPU.

1. The engine against the repository's `serve.py`: both engines, fed the
   same request sequences through the same recording fake pipeline, must
   dispatch identical padded batches (shape, dtype, bytes, lengths) and give
   identical request names, results and aggregates, in every wire dtype;
   `StreamingSession`, `_PcmStreamDecoder`, `_bucket_batch_size` and
   `stats_snapshot` likewise.
2. The port's own server at a tiny model with `--device cpu`, one case for
   each live case of `tests/test_serve.py`, and served ids equal to
   `transcribe_with_ids` at the engine's generator seed; with
   `--encoder-ckpt` or `--wavlm-ckpt`, the ids of the inference CLI's
   pipeline built from the same files (C8).
3. What the server needs below it: the C4 refusal of a batch under one conv
   receptive field, `model.init_scheme` (C5), the wire encoders, MP3
   decoding and the flags that are not ported (sharded artifacts) or need a
   process group (`--mesh`)."""
import http.client
import http.server
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve as jax_serve
from fddm_asr_tpu.data import audio_io as JA
from fddm_asr_tpu.data import mp3 as JM
from fddm_asr_tpu.data import wire as JW
from fddm_asr_tpu_torch import serve as S
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.data import audio_io as TA
from fddm_asr_tpu_torch.data import mp3 as TM
from fddm_asr_tpu_torch.data import wire as TW
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from test_torch_pipeline import CFG, _write_vocab, pipelines  # noqa: F401  (module fixture)

SR = 16000
WIRES = ("f32", "pcm16", "mulaw8")


# --------------------------------------------------------------- 1. engines
class FakePipeline:
    """What the engine reads of a pipeline besides its transcribe calls."""

    device = torch.device("cpu")
    input_encoding = "f32"


class Recorder(FakePipeline):
    """A fake pipeline: records every dispatched batch and answers each row
    with a text and ids derived from the row's bytes."""

    use_condition_mask = True

    def __init__(self, encoding="f32"):
        self.input_encoding = encoding
        self.calls = []

    def transcribe_with_ids_async(self, wave, lengths=None, seq_len=None,
                                  with_confidence=False, **kw):
        wave, lengths = np.asarray(wave), np.asarray(lengths)
        self.calls.append((wave.shape, wave.dtype.str, wave.tobytes(), lengths.tolist(),
                           seq_len, with_confidence,
                           sorted(k for k in kw if k not in ("rng", "generator"))))
        rows = [(f"t{zlib.crc32(w.tobytes()) % 997}", [int(n) for n in np.unique(w)[:3]], 0.5)
                for w in wave]
        return lambda: rows


def _engines(encoding, **kw):
    kw = {"max_batch": 8, "max_wait_ms": 50, **kw}
    sampling = {"T_infer": 4, "r": 2}
    return (jax_serve.BatchingEngine(Recorder(encoding), sampling, 8, **kw),
            S.BatchingEngine(Recorder(encoding), sampling, 8, **kw))


def _requests_audio():
    """320, 1600 and 8000 samples and 45 s (two windows at max-seconds 30),
    with quiet spans for the silence cuts to find."""
    rng = np.random.default_rng(7)
    out = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in (320, 1600, 8000, 45 * SR)]
    for s in (200_000, 470_000, 610_000):
        out[3][s:s + 900] *= 0.001
    return out


def _run_all_at_once(engine, waves):
    reqs = [engine._plan_requests(w, f"u{i}") for i, w in enumerate(waves)]
    engine._enqueue([r for rs in reqs for r in rs])
    for rs in reqs:
        for r in rs:
            assert r.done.wait(timeout=30)
    return ([[r.name for r in rs] for rs in reqs],
            [engine._aggregate(f"u{i}", [r.result for r in rs]) for i, rs in enumerate(reqs)])


@pytest.mark.parametrize("encoding", WIRES)
def test_engine_dispatches_as_the_jax_engine(encoding):
    waves = _requests_audio()
    jax_eng, eng = _engines(encoding)
    try:
        # all at once: one batch (five requests, 45 s windowed in two)
        assert _run_all_at_once(eng, waves) == _run_all_at_once(jax_eng, waves)
        # one at a time: one batch each
        for i, w in enumerate(waves):
            assert eng.submit(w, f"s{i}") == jax_eng.submit(w, f"s{i}")
        assert eng.pipeline.calls == jax_eng.pipeline.calls
        assert [c[0] for c in eng.pipeline.calls] == [
            (8, 480000), (1, 16000), (1, 16000), (1, 16000), (2, 480000)]
        assert {c[1] for c in eng.pipeline.calls} == {np.dtype(TW.wire_dtype(encoding)).str}
        assert eng._rng_counter == jax_eng._rng_counter == 5
        ours, theirs = eng.stats_snapshot(), jax_eng.stats_snapshot()
        assert ours.keys() == theirs.keys()
        assert ours["stage_ms"].keys() == theirs["stage_ms"].keys()
        assert ours["latency_ms"].keys() == theirs["latency_ms"].keys()
        for key in ("requests", "errors", "batches", "audio_seconds", "mean_batch_size"):
            assert ours[key] == theirs[key], key
    finally:
        eng.shutdown()
        jax_eng.shutdown()


def test_bucket_batch_size_as_the_jax_engine():
    for max_batch in (1, 4, 6, 16):
        jax_eng, eng = _engines("f32", max_batch=max_batch)
        try:
            assert [eng._bucket_batch_size(n) for n in range(1, 21)] == [
                jax_eng._bucket_batch_size(n) for n in range(1, 21)]
        finally:
            eng.shutdown()
            jax_eng.shutdown()


@pytest.mark.parametrize("encoding", WIRES)
@pytest.mark.parametrize("window_seconds", [None, 0.7])
def test_streaming_session_as_the_jax_session(encoding, window_seconds):
    rng = np.random.default_rng(1)
    wave = rng.uniform(-0.5, 0.5, 50_000).astype(np.float32)
    for s in (9_000, 21_500, 34_000, 44_800):
        wave[s:s + 700] *= 0.001
    jax_eng, eng = _engines(encoding, max_seconds=1.0, max_wait_ms=1)
    try:
        out = []
        for mod, engine in ((S, eng), (jax_serve, jax_eng)):
            sess = mod.StreamingSession(engine, "live", window_seconds=window_seconds)
            for p in np.split(wave, [1, 3_333, 3_333, 17_000, 17_401, 40_007]):
                sess.feed(p)
            outs = list(sess.finish())
            out.append(([(r.name, r.wave.tobytes()) for r in sess._reqs], outs, sess.win))
        assert out[0] == out[1]
        win = out[0][2]
        spans = TA.plan_silence_chunks(wave, win)
        assert [w for _, w in out[0][0]] == [
            TW.encode_wire(wave[s:e], encoding).tobytes() for s, e in spans]
    finally:
        eng.shutdown()
        jax_eng.shutdown()


@pytest.mark.parametrize("fmt", ["pcm16", "f32"])
def test_pcm_stream_decoder_as_the_jax_decoder(fmt):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, 1001).astype(np.float32)
    raw = (x * 32767).astype("<i2").tobytes() if fmt == "pcm16" else x.tobytes()
    cuts = sorted(rng.integers(0, len(raw), 9).tolist())
    parts = [raw[a:b] for a, b in zip([0, *cuts], [*cuts, len(raw)])]  # splits mid-sample
    ours, theirs = S._PcmStreamDecoder(fmt), jax_serve._PcmStreamDecoder(fmt)
    a = np.concatenate([ours.decode(p) for p in parts])
    b = np.concatenate([theirs.decode(p) for p in parts])
    assert a.dtype == b.dtype and np.array_equal(a, b) and len(a) == len(x)
    assert ours._carry == theirs._carry == b""
    with pytest.raises(ValueError, match="unsupported stream format"):
        S._PcmStreamDecoder("mp3")


# --------------------------------------------------- 2. the port's own server
SERVE_CFG = {**CFG, "data": {**CFG["data"], "max_len": 8}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A YAML config (the tiny config of test_torch_pipeline.py, 8 tokens),
    a random decoder `.pt`, a tokenizer and four 0.5 s clips."""
    tmp = tmp_path_factory.mktemp("serve")
    vocab = _write_vocab(tmp / "spm.vocab")
    (tmp / "config.yaml").write_text(json.dumps(SERVE_CFG))  # JSON is YAML
    pipe = FDDMPipeline.from_config(Config(SERVE_CFG), tokenizer=object(), device="cpu", seed=3)
    torch.save(pipe.decoder.state_dict(), str(tmp / "decoder.pt"))
    rng = np.random.default_rng(0)
    clips = []
    for i in range(4):
        clips.append(str(tmp / f"clip{i}.wav"))
        TA.save_wav(clips[-1], 0.3 * rng.standard_normal(SR // 2).astype(np.float32), SR)
    return {"dir": tmp, "config": str(tmp / "config.yaml"), "ckpt": str(tmp / "decoder.pt"),
            "vocab": vocab, "clips": clips}


def _args(files, *extra):
    return S.parse_args(["--config", files["config"], "--ckpt", files["ckpt"],
                         "--tokenizer", files["vocab"], "--port", "0", "--device", "cpu",
                         *extra])


@pytest.fixture(scope="module")
def server(files):
    srv = S.build_server(_args(files, "--max-batch", "4", "--max-wait-ms", "150"))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()
    srv.server_close()
    srv.engine.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read().decode("utf-8"))


def _post(url, data, ctype):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode("utf-8"))


def _ndjson(resp_bytes):
    return [json.loads(line) for line in resp_bytes.decode("utf-8").splitlines() if line.strip()]


def _serve_thread(handler):
    s = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return s, f"http://127.0.0.1:{s.server_address[1]}"


RESULT_KEYS = {"wav", "text", "ids", "confidence", "T_infer", "r", "greedy", "posterior_mode"}


def test_healthz(server):
    base, _ = server
    code, obj = _get(base + "/healthz")
    assert code == 200 and obj["status"] == "ok"
    assert obj["T_infer"] == 20 and obj["r"] == 5 and obj["seq_len"] == 8


def test_upload_and_path_mode_give_the_jax_schema(server, files):
    base, _ = server
    clip = files["clips"][0]
    code, obj = _post(base + "/v1/transcribe", open(clip, "rb").read(), "audio/wav")
    assert code == 200, obj
    assert set(obj) == RESULT_KEYS  # the JAX server's result schema
    assert len(obj["ids"]) == 8 and obj["confidence"] == obj["confidence"]
    code, obj2 = _post(base + "/v1/transcribe", json.dumps({"path": clip}).encode(),
                       "application/json")
    assert code == 200 and obj2["wav"] == clip and set(obj2) == RESULT_KEYS


def test_float_wav_upload(server, files, tmp_path):
    """A float WAV upload is read from the request's bytes (the RIFF parser
    takes a file object), as the JAX package reads the file from disk."""
    base, _ = server
    x = (0.2 * np.random.default_rng(4).standard_normal(6000)).astype("<f4")
    fmt = struct.pack("<HHIIHH", 3, 1, SR, SR * 4, 4, 32)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", x.nbytes) + x.tobytes()
    blob = b"RIFF" + struct.pack("<I", len(body)) + body
    (tmp_path / "f.wav").write_bytes(blob)
    np.testing.assert_array_equal(S._decode_wav_bytes(blob), JA.load_wav(str(tmp_path / "f.wav"))[0])
    code, obj = _post(base + "/v1/transcribe", blob, "audio/wav")
    assert code == 200 and set(obj) == RESULT_KEYS


def test_bad_request(server):
    base, _ = server
    code, obj = _post(base + "/v1/transcribe", b"not a wav", "audio/wav")
    assert code == 400 and "error" in obj


def test_path_mode_restrictions(server, files):
    base, srv = server
    clip, out = files["clips"][0], str(files["dir"])
    s2, b2 = _serve_thread(S.make_handler(srv.engine, {}, loopback_only_paths=True))
    try:
        code, obj = _post(b2 + "/v1/transcribe", json.dumps({"path": clip}).encode(),
                          "application/json")
        assert code == 403 and "path mode disabled" in obj["error"]
    finally:
        s2.shutdown()
    s3, b3 = _serve_thread(S.make_handler(srv.engine, {}, audio_root=out))
    try:
        def post(path):
            return _post(b3 + "/v1/transcribe", json.dumps({"path": path}).encode(),
                         "application/json")

        assert post(clip)[0] == 200
        code, obj = post("/etc/passwd")
        assert code == 403 and obj["error"] == "path outside --audio-root"
        assert post(f"{out}/../../../../../etc/passwd")[0] == 403
        code, obj = post(f"{out}/nope.wav")
        assert code == 400 and "could not read audio" in obj["error"]
        assert "nope.wav" not in obj["error"]
    finally:
        s3.shutdown()


def test_sub_frame_audio_is_finite(server, tmp_path):
    base, _ = server
    path = str(tmp_path / "tiny.wav")
    TA.save_wav(path, np.random.default_rng(0).uniform(-0.1, 0.1, 320).astype(np.float32), SR)
    code, obj = _post(base + "/v1/transcribe", open(path, "rb").read(), "audio/wav")
    assert code == 200, obj
    assert obj["confidence"] == obj["confidence"] and isinstance(obj["text"], str)


def test_concurrency_three_is_a_batch_of_four(server, files):
    base, srv = server
    before = srv.engine.stats_snapshot()
    results = [None] * 3

    def call(i):
        results[i] = _post(base + "/v1/transcribe",
                           json.dumps({"path": files["clips"][i]}).encode(), "application/json")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None and r[0] == 200 for r in results), results
    after = srv.engine.stats_snapshot()
    assert after["requests"] - before["requests"] == 3 and after["errors"] == 0
    assert after["batches"] - before["batches"] == 1  # coalesced
    assert (4, SR) in srv.engine._warm_shapes         # three rows padded to four


def test_batch_padding_rows_are_independent(server):
    """Under the condition mask the pad rows' content does not reach the
    real rows (same generator seed, other pad-row audio)."""
    _, srv = server
    eng = srv.engine
    rng = np.random.default_rng(0)
    real = rng.standard_normal((3, 8000)).astype(np.float32)

    def run(pad_row):
        wave = np.concatenate([real, pad_row[None]])
        return eng.pipeline.transcribe_with_ids(
            wave, np.array([8000] * 3 + [1600]), seq_len=eng.seq_len,
            generator=torch.Generator().manual_seed(5), **eng.sampling)

    a = run(np.zeros(8000, np.float32))
    b = run(rng.standard_normal(8000).astype(np.float32))
    assert a[:3] == b[:3]


def test_served_ids_equal_the_pipeline_at_the_engine_seed(server, files):
    """One upload alone is a batch of one at the next counter: its ids are
    `transcribe_with_ids` of the [1, T] bucket-padded batch with the
    generator seeded at that counter."""
    base, srv = server
    eng = srv.engine
    body = open(files["clips"][1], "rb").read()
    code, obj = _post(base + "/v1/transcribe", body, "audio/wav")
    assert code == 200
    wave = S._decode_wav_bytes(body)
    batch = np.zeros((1, SR), np.float32)
    batch[0, :len(wave)] = wave
    (text, ids, conf), = eng.pipeline.transcribe_with_ids(
        batch, np.array([len(wave)]), seq_len=eng.seq_len, with_confidence=True,
        generator=torch.Generator().manual_seed(eng._rng_counter), **eng.sampling)
    assert obj["ids"] == ids and obj["text"] == text
    assert obj["confidence"] == round(conf, 6)


@pytest.fixture(scope="module")
def encoder_files(files):
    """Encoder weights that are not the seed's, one file for each flag: an
    `AcousticEncoder` state_dict drawn from another seed (`--encoder-ckpt`,
    what a fine-tune's `{prefix}.encoder.pt` holds) and a Hugging Face WavLM
    directory written as tests/test_torch_wavlm_hf.py writes one
    (`--wavlm-ckpt`)."""
    from transformers import WavLMConfig as HFConfig
    from transformers import WavLMModel as HFModel

    tmp = files["dir"]
    tuned = FDDMPipeline.from_config(Config(SERVE_CFG), tokenizer=object(), device="cpu", seed=11)
    torch.save(tuned.encoder.state_dict(), str(tmp / "tuned.encoder.pt"))
    torch.manual_seed(0)
    hf = HFModel(HFConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True, num_buckets=32,
        max_bucket_distance=80, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4))
    with torch.no_grad():  # move norms and biases off their init
        for p in hf.parameters():
            p.add_(0.05 * torch.randn_like(p))
    hf.save_pretrained(str(tmp / "hf"))
    return {"--encoder-ckpt": str(tmp / "tuned.encoder.pt"), "--wavlm-ckpt": str(tmp / "hf")}


@pytest.mark.parametrize("flag", ["--encoder-ckpt", "--wavlm-ckpt"])
def test_served_encoder_weights_are_the_clis(server, files, encoder_files, flag):
    """C8: a server given encoder weights serves, for one upload at the
    engine's seed, the ids of the inference CLI's pipeline built from the
    same files (`inference.build_pipeline`, through the loader both share),
    and not those of the seed's encoder."""
    from fddm_asr_tpu_torch import inference as cli

    srv = S.build_server(_args(files, flag, encoder_files[flag]))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body = open(files["clips"][2], "rb").read()
        code, obj = _post(f"http://127.0.0.1:{srv.server_address[1]}/v1/transcribe", body,
                          "audio/wav")
        seed = srv.engine._rng_counter
    finally:
        srv.shutdown()
        srv.server_close()
        srv.engine.shutdown()
    assert code == 200, obj
    pipe = cli.build_pipeline(cli.parse_args(
        ["--wav", files["clips"][2], "--ckpt", files["ckpt"], "--main-config", files["config"],
         "--diffusion-config", files["config"], "--tokenizer", files["vocab"],
         "--device", "cpu", flag, encoder_files[flag]]))
    pipe.use_condition_mask = True  # as the server pads: bucket padding stays out
    wave = S._decode_wav_bytes(body)
    batch = np.zeros((1, SR), np.float32)
    batch[0, :len(wave)] = wave

    def served(p):
        return p.transcribe_with_ids(
            batch, np.array([len(wave)]), seq_len=srv.engine.seq_len, with_confidence=True,
            generator=torch.Generator().manual_seed(seed), **srv.engine.sampling)[0]

    text, ids, conf = served(pipe)
    assert obj["ids"] == ids and obj["text"] == text and obj["confidence"] == round(conf, 6)
    assert obj["ids"] != served(server[1].engine.pipeline)[1]


@pytest.mark.parametrize("flag", ["--encoder-ckpt", "--wavlm-ckpt"])
def test_encoder_weights_beside_an_artifact_raise(files, flag):
    """An artifact carries its own weights: the flags name the export CLI."""
    with pytest.raises(SystemExit, match="export_model"):
        S.build_server(_args(files, "--exported", "artifact", flag, "w"))


def test_long_audio_windows_and_joins(server, files):
    base, srv = server
    srv.engine.max_samples = int(0.4 * SR)  # the 0.5 s clip -> two windows
    try:
        code, obj = _post(base + "/v1/transcribe", open(files["clips"][0], "rb").read(),
                          "audio/wav")
        assert code == 200, obj
        assert len(obj["chunks"]) == 2 and obj["text"] == "".join(obj["chunks"])
        assert obj["chunk_seconds"] == 0.4 and len(obj["ids"]) == 2
    finally:
        srv.engine.max_samples = 30 * SR


def test_streaming_long_form(server, files):
    base, srv = server
    srv.engine.max_samples = int(0.4 * SR)
    try:
        req = urllib.request.Request(base + "/v1/transcribe?stream=1",
                                     data=open(files["clips"][0], "rb").read(),
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("application/x-ndjson")
            lines = _ndjson(r.read())
        assert len(lines) == 3  # two window partials, then the aggregate
        for i, p in enumerate(lines[:-1]):
            assert p["chunk_index"] == i and p["chunk_count"] == 2
        assert lines[-1]["chunks"] == [p["text"] for p in lines[:-1]]
    finally:
        srv.engine.max_samples = 30 * SR


def test_stream_endpoint_chunked_pcm16_and_f32(server):
    base, srv = server
    host = base.split("//")[1]
    srv.engine.max_samples = int(0.4 * SR)  # a 0.7 s upload -> two windows
    try:
        wave = np.random.default_rng(0).uniform(-0.2, 0.2, int(0.7 * SR)).astype(np.float32)
        pcm = (wave * 32767).astype("<i2").tobytes()
        conn = http.client.HTTPConnection(host, timeout=120)
        conn.request("POST", "/v1/transcribe/stream?format=pcm16",
                     body=(pcm[i:i + 3001] for i in range(0, len(pcm), 3001)),
                     encode_chunked=True)
        resp = conn.getresponse()
        assert resp.status == 200
        lines = _ndjson(resp.read())
        conn.close()
        assert len(lines) == 3, lines
        assert lines[-1]["text"] == "".join(p["text"] for p in lines[:-1])

        body = wave[:4000].tobytes()
        conn = http.client.HTTPConnection(host, timeout=120)
        conn.request("POST", "/v1/transcribe/stream?format=f32", body=body,
                     headers={"Content-Length": str(len(body))})
        resp = conn.getresponse()
        lines = _ndjson(resp.read())
        conn.close()
        assert resp.status == 200 and len(lines) == 2 and lines[0]["chunk_count"] == 1
        code, obj = _post(base + "/v1/transcribe/stream?format=mp3", b"\x00\x00",
                          "application/octet-stream")
        assert code == 400 and "unsupported stream format" in obj["error"]
    finally:
        srv.engine.max_samples = 30 * SR


def test_stream_endpoint_malformed_chunk_framing(server):
    base, _ = server
    host, port = base.split("//")[1].split(":")
    s = socket.create_connection((host, int(port)), timeout=120)
    try:
        s.sendall(b"POST /v1/transcribe/stream?format=pcm16 HTTP/1.1\r\n"
                  b"Host: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                  b"10\r\n" + b"\x00" * 16 + b"\r\nzz\r\n")
        buf = b""
        while b"0\r\n\r\n" not in buf:
            data = s.recv(65536)
            if not data:
                break
            buf += data
        text = buf.decode("utf-8", "replace")
        assert " 200 " in text.splitlines()[0]
        assert "stream aborted" in text and "chunk-size" in text
        assert buf.endswith(b"0\r\n\r\n")
    finally:
        s.close()


def test_num_candidates(files):
    srv = S.build_server(_args(files, "--max-batch", "2", "--max-wait-ms", "5",
                               "--num-candidates", "2"))
    try:
        wave = (np.random.default_rng(0).standard_normal(8000) * 0.1).astype(np.float32)
        res = srv.engine.submit(wave, "x.wav")
        assert "error" not in res and res["num_candidates"] == 2
        assert 0.0 <= res["confidence"] <= 1.0
    finally:
        srv.server_close()
        srv.engine.shutdown()


def test_request_timeout():
    class Stalled(FakePipeline):
        def transcribe_with_ids_async(self, *a, **k):
            def fin():
                time.sleep(2.0)
                return []

            return fin

    eng = S.BatchingEngine(Stalled(), {}, 8, max_batch=2, max_wait_ms=1, request_timeout_s=0.2)
    try:
        t0 = time.perf_counter()
        assert "timed out" in eng.submit(np.zeros(1600, np.float32), "x").get("error", "")
        assert time.perf_counter() - t0 < 1.5
        out = list(eng.submit_stream(np.zeros(1600, np.float32), "y"))
        assert len(out) == 1 and "timed out" in out[0]["error"]
    finally:
        eng.shutdown()


def test_warmup_runs_every_batch_level_with_seed_zero(files):
    calls = []

    class WarmRecorder(Recorder):
        def transcribe_with_ids(self, wave, lengths=None, seq_len=None, generator=None,
                                with_confidence=False, **_):
            calls.append((wave.shape, with_confidence, generator.initial_seed()))
            return [("", [0], 0.0)] * wave.shape[0]

    eng = S.BatchingEngine(WarmRecorder("pcm16"), {}, 8, max_batch=8, max_wait_ms=1)
    try:
        rows = S._warmup(eng, "1", 8)
    finally:
        eng.shutdown()
    assert [c[0][0] for c in calls] == [1, 2, 4, 8] == [r["B"] for r in rows]
    assert all(c[1] is True and c[2] == 0 for c in calls)
    assert {(b, SR) for b in (1, 2, 4, 8)} <= eng._warm_shapes
    assert eng._rng_counter == 0  # transcripts comparable to an unwarmed server's
    # the tiny pipeline itself: warm-up and a request at the same counter as a cold server
    srv = S.build_server(_args(files, "--max-batch", "2", "--warmup-seconds", "1"))
    cold = S.build_server(_args(files, "--max-batch", "2"))
    try:
        assert {(1, SR), (2, SR)} <= srv.engine._warm_shapes
        wave = S._decode_wav_bytes(open(files["clips"][2], "rb").read())
        assert srv.engine.submit(wave, "w") == cold.engine.submit(wave, "w")
    finally:
        for s in (srv, cold):
            s.server_close()
            s.engine.shutdown()


def test_cold_shape_dispatch_does_not_block_ready_results():
    seen = set()

    class ColdPipeline(FakePipeline):
        def transcribe_with_ids_async(self, wave, lengths=None, **_):
            if wave.shape not in seen:  # first call at a new shape
                seen.add(wave.shape)
                time.sleep(2.0)
            rows = [("ok", [1], 1.0)] * wave.shape[0]
            return lambda: rows

    eng = S.BatchingEngine(ColdPipeline(), {}, 8, max_batch=2, max_wait_ms=1)
    try:
        r1 = eng._plan_requests(np.zeros(1600, np.float32), "a")
        eng._enqueue(r1)
        time.sleep(0.3)
        r2 = eng._plan_requests(np.zeros(17000, np.float32), "b")  # another bucket
        eng._enqueue(r2)
        assert r1[0].done.wait(timeout=3.2), "a ready batch waited behind a cold shape"
        assert r2[0].done.wait(timeout=5.0)
        assert eng.stats_snapshot()["errors"] == 0
    finally:
        eng.shutdown()


def test_pipeline_depth_overlaps_and_keeps_order():
    inflight = {"now": 0, "max": 0}
    lock = threading.Lock()

    class SlowPipeline(FakePipeline):
        def transcribe_with_ids_async(self, wave, lengths=None, **_):
            with lock:
                inflight["now"] += 1
                inflight["max"] = max(inflight["max"], inflight["now"])
            marks = [float(wave[i].sum()) for i in range(wave.shape[0])]
            t_done = time.perf_counter() + 0.08

            def fin():
                time.sleep(max(0.0, t_done - time.perf_counter()))
                with lock:
                    inflight["now"] -= 1
                return [(f"m{m:.0f}", [int(m)], 1.0) for m in marks]

            return fin

    eng = S.BatchingEngine(SlowPipeline(), {"T_infer": 4, "r": 2}, 8, max_batch=1,
                           max_wait_ms=1, pipeline_depth=3)
    try:
        results = {}

        def client(i):
            results[i] = eng.submit(np.full(1600, float(i), np.float32), f"u{i}", timeout_s=20)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(1, 13)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(results[i]["text"] == f"m{1600 * i}" for i in range(1, 13)), results
        assert inflight["max"] >= 3
        assert eng.stats_snapshot()["requests"] == 12
    finally:
        eng.shutdown()


def test_a_failing_batch_fails_only_its_requests():
    class Flaky(FakePipeline):
        def transcribe_with_ids_async(self, wave, lengths=None, **_):
            if wave.shape[1] > SR:
                raise RuntimeError("kernel launch failed")
            rows = [("ok", [1], 1.0)] * wave.shape[0]
            return lambda: rows

    eng = S.BatchingEngine(Flaky(), {}, 8, max_batch=2, max_wait_ms=1)
    try:
        assert eng.submit(np.zeros(2 * SR, np.float32), "bad") == {
            "wav": "bad", "error": "kernel launch failed"}
        assert eng.submit(np.zeros(SR, np.float32), "good")["text"] == "ok"
        assert eng.stats_snapshot()["errors"] == 1
    finally:
        eng.shutdown()


def test_flags_that_are_not_ported_raise(files):
    # --exported is served (tests/test_torch_aot.py); its mesh is the
    # artifact's, so --mesh beside it raises as the root serve.py's does
    # (sharded artifacts: tests/test_torch_aot_mesh.py); a mesh is served
    # over a process group (tests/test_torch_serve_mesh.py), so in one
    # process a mesh of two asks for the launcher, and --seq-parallel for a
    # model axis
    for extra, error, item in (
            (["--exported", "artifact", "--mesh", "data=2"], SystemExit,
             "pre-lowered; pass --mesh to python -m fddm_asr_tpu_torch.export_model instead"),
            (["--mesh", "data=2"], ValueError, r"torchrun --nproc_per_node 2"),
            (["--seq-parallel"], SystemExit, "--mesh model=N")):
        with pytest.raises(error, match=item):
            S.build_server(_args(files, *extra))


def test_the_entry_point_needs_a_gpu_unless_told_cpu(files):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.main(["--config", files["config"], "--ckpt", files["ckpt"],
                "--tokenizer", files["vocab"], "--port", "0"])


# ------------------------------------------------- 3. what the server needs
@pytest.mark.parametrize("n", [300, 399])
def test_a_batch_under_one_receptive_field_raises(pipelines, n):
    """C4: the JAX pipeline returns NaN there; the port refuses before any
    device work and names the constant."""
    _, tp, *_ = pipelines
    wav = np.zeros((2, n), np.float32)
    with pytest.raises(ValueError, match="CONV_RECEPTIVE_FIELD"):
        tp.encode_waveform(wav)
    with pytest.raises(ValueError, match="CONV_RECEPTIVE_FIELD"):
        tp.transcribe_with_ids(wav, seq_len=4)


@pytest.mark.parametrize("n", [400, 401])
def test_one_receptive_field_encodes_as_jax(pipelines, n):
    jp, tp, *_ = pipelines
    wav = (0.3 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    c, _ = jp.encode_waveform(wav)
    ours, _ = tp.encode_waveform(wav)
    assert ours.shape == c.shape and c.shape[1] >= 1
    np.testing.assert_allclose(ours.numpy(), np.asarray(c), atol=1e-5, rtol=0)


V, DM, H, LAYERS, FF = 96, 256, 4, 2, 512


def _jax_decoder_state_dict(scheme, pos_emb_type):
    from fddm_asr_tpu.convert.torch_ckpt import decoder_state_dict_from_params
    from fddm_asr_tpu.models.decoder import DenoisingTransformerDecoder
    from fddm_asr_tpu.models.torch_init import torch_like_decoder_init

    model = DenoisingTransformerDecoder(vocab_size=V, d_model=DM, nhead=H, num_layers=LAYERS,
                                        dim_ff=FF, dropout=0.0, max_len=1024, pad_id=0,
                                        pos_emb_type=pos_emb_type)
    p = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                            jnp.ones((1,), jnp.int32), jnp.zeros((1, 16, DM)))["params"]
    if scheme == "torch":
        p = torch_like_decoder_init(jax.random.key(1), p, pad_id=0)
    return decoder_state_dict_from_params(p, pos_emb_type=pos_emb_type)


def _init_cfg(scheme, pos_emb_type="rope"):
    model = {"d_model": DM, "nhead": H, "num_layers": LAYERS, "dim_ff": FF, "dropout": 0.0,
             "pos_emb_type": pos_emb_type,
             "encoder": {"wavlm_name": "tiny", "proj": "linear"}}
    if scheme is not None:
        model["init_scheme"] = scheme
    return Config({"seed": 0, "data": {"vocab_size": V, "pad_id": 0}, "model": model,
                   "diffusion": {"T": 20, "beta_max": 0.2}})


@pytest.mark.parametrize("scheme,pos_emb_type", [
    (None, "rope"), ("flax", "learned"), ("torch", "rope"), ("TORCH", "learned")])
def test_init_scheme_draws_the_jax_distributions(scheme, pos_emb_type):
    """C5: model.init_scheme ("flax" by default) draws each decoder tensor
    from the distribution the JAX pipeline's init of that scheme draws it:
    per-tensor standard deviations within 10 %, zeros where JAX has zeros,
    flax's kernels truncated at two standard deviations."""
    ours = {k: v.numpy() for k, v in FDDMPipeline.from_config(
        _init_cfg(scheme, pos_emb_type), tokenizer=object(), device="cpu").decoder
        .state_dict().items()}
    theirs = _jax_decoder_state_dict(str(scheme or "flax").lower(), pos_emb_type)
    assert ours.keys() == theirs.keys()
    for k, want in theirs.items():
        got = ours[k]
        assert got.shape == want.shape, k
        if not np.any(want):
            assert not np.any(got), k
        elif want.size >= 64 and np.std(want) > 0:
            assert 0.9 < np.std(got) / np.std(want) < 1.1, (k, np.std(got), np.std(want))
    assert not np.any(ours["tok_emb.weight"][0])  # the pad row
    w = ours["blocks.0.ff.0.weight"]
    if str(scheme or "flax").lower() == "flax":
        std = 1.0 / np.sqrt(DM) / 0.87962566103423978
        assert np.abs(w).max() <= 2 * std * (1 + 1e-6) and not np.any(ours["head.bias"])
    else:
        assert np.abs(w).max() <= 1.0 / np.sqrt(DM) and np.std(ours["head.bias"]) > 1e-4


def test_init_schemes_differ_and_keep_the_encoder():
    flax = FDDMPipeline.from_config(_init_cfg("flax"), tokenizer=object(), device="cpu")
    tch = FDDMPipeline.from_config(_init_cfg("torch"), tokenizer=object(), device="cpu")
    r = np.std(tch.decoder.head.weight.detach().numpy()) / np.std(
        flax.decoder.head.weight.detach().numpy())
    assert 0.5 < r < 0.65  # torch's U(+-1/sqrt(fan_in)) is 1/sqrt(3) of flax's std, about
    for a, b in zip(flax.encoder.state_dict().values(), tch.encoder.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="init_scheme"):
        FDDMPipeline.from_config(_init_cfg("bogus"), tokenizer=object(), device="cpu")


@pytest.mark.parametrize("encoding", WIRES)
def test_wire_encoders_are_byte_equal_to_jax(encoding):
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-1.3, 1.3, 50_000),
                        np.arange(-32768, 32768, 7) / 32768.0,
                        [0.0, 1.0, -1.0, 0.5 / 32768]]).astype(np.float32)
    a, b = TW.encode_wire(x, encoding), JW.encode_wire(x, encoding)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert TW.wire_dtype(encoding) == JW.wire_dtype(encoding)
    assert TW.silence_value(encoding) == JW.silence_value(encoding)
    with pytest.raises(ValueError, match="unknown wire encoding"):
        TW.encode_wire(x, "alaw")


needs_codecs = pytest.mark.skipif(
    not (JM.mpg123_available() and JM.lame_available()),
    reason="system libmpg123/libmp3lame not present")


@needs_codecs
@pytest.mark.parametrize("sr,channels,kbps", [(16000, 1, 64), (44100, 2, 128), (22050, 1, 32)])
def test_decode_mp3_equals_the_jax_decoder(tmp_path, sr, channels, kbps):
    t = np.arange(int(sr * 0.4)) / sr
    src = np.stack([0.5 * np.sin(2 * np.pi * 300 * t), 0.3 * np.sin(2 * np.pi * 700 * t)])
    blob = JM.encode_mp3(src[:channels].astype(np.float32) if channels == 2
                         else src[0].astype(np.float32), sr, kbps)
    path = tmp_path / "x.mp3"
    path.write_bytes(blob)
    want, want_sr = JM.decode_mp3(blob)
    for got, got_sr in (TM.decode_mp3(blob), TM.decode_mp3(str(path))):
        assert got_sr == want_sr == sr and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    a, b = TA.load_audio(str(path), 16000), JA.load_audio(str(path), 16000)
    assert a[1] == b[1] == 16000
    np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(ValueError):
        TM.decode_mp3(b"")


def test_mp3_without_any_decoder_names_both(tmp_path, monkeypatch):
    path = tmp_path / "a.mp3"
    path.write_bytes(b"\xff\xfb\x90\x00" * 8)
    monkeypatch.setattr(TM, "mpg123_available", lambda: False)
    monkeypatch.setattr(TA.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="neither libmpg123 nor ffmpeg"):
        TA.load_audio(str(path))


def test_position_bias_table_is_cached_for_its_length():
    """The bucket table is built once for a length and kept while other
    lengths come (a CUDA graph captured at a length reads it for as long as
    the graph lives); the bias equals a fresh layer's at every length and
    the embedding of the [L, L] bucket table."""
    from fddm_asr_tpu_torch.models.wavlm import (GatedRelPosAttention, WavLMConfig,
                                                 relative_position_buckets)

    torch.manual_seed(0)
    cfg = WavLMConfig.tiny_for_tests()
    layer = GatedRelPosAttention(cfg, has_relative_position_bias=True)
    cpu = torch.device("cpu")
    a = layer.position_bias(7, torch.float32)
    table = layer._relative_buckets[(7, cpu)]
    assert torch.equal(layer.position_bias(7, torch.float32), a)
    assert layer._relative_buckets[(7, cpu)] is table  # not rebuilt
    for L in (9, 7, *range(10, 40)):
        fresh = GatedRelPosAttention(cfg, has_relative_position_bias=True)
        fresh.load_state_dict(layer.state_dict())
        bias = layer.position_bias(L, torch.float32)
        assert torch.equal(bias, fresh.position_bias(L, torch.float32))
        buckets = torch.from_numpy(relative_position_buckets(
            L, L, cfg.num_buckets, cfg.max_bucket_distance))
        assert torch.equal(bias, torch.nn.functional.embedding(
            buckets, layer.rel_attn_embed.weight).permute(2, 0, 1))
    assert layer._relative_buckets[(7, cpu)] is table  # kept
