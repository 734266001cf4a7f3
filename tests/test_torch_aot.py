# -*- coding: utf-8 -*-
"""The port's AOT artifacts (`fddm_asr_tpu_torch/aot.py`, the export CLI and
`serve --exported`) against the live port pipeline and the JAX package.

Mirrors tests/test_aot_export.py (all but its multichip cases and its
legacy two-output format) at a tiny config: exported ids equal the live
pipelines' at the same padded batch and x_T, bucket selection equals
JAX's, the bf16 params round-trip, a fresh process loads without model
code, pcm16/mulaw8 artifacts, the CLI, the server.  On the CPU the loaded
programs run eagerly; CUDA graphs are held in tests/test_torch_aot_cuda.py.
"""
import ast
import json
import os
import subprocess
import sys
import threading
import urllib.request
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu import diffusion as JD
from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu.aot import ExportedPipeline as JaxExportedPipeline
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.convert.torch_ckpt import save_reference_checkpoint
from fddm_asr_tpu.eval import utterance_confidence
from fddm_asr_tpu.pipeline import FDDMPipeline as JaxPipeline
from fddm_asr_tpu.pipeline import build_wavlm_config
from fddm_asr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from fddm_asr_tpu_torch import aot
from fddm_asr_tpu_torch import serve as S
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import wavlm_state_dict_from_jax_params
from fddm_asr_tpu_torch.data import audio_io as TA
from fddm_asr_tpu_torch.data.wire import mulaw_encode
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from fddm_asr_tpu_torch.sampler import categorical
from fddm_asr_tpu_torch.tokenizer import load_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, SEQ_LEN, N, N_SHORT = 40, 12, 8000, 4800  # 0.5 s and 0.3 s at 16 kHz
# the smallest model that keeps every kind of layer: a trace and a load cost
# about a millisecond a node on a host, and depth multiplies the nodes
CFG = {
    "seed": 0,
    "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
    "model": {"d_model": 32, "nhead": 4, "num_layers": 1, "dim_ff": 64, "dtype": "float32",
              "encoder": {"wavlm_name": "tiny", "proj": "linear",
                          "wavlm_config": {"num_hidden_layers": 1}}},
    "diffusion": {"T": 200, "beta_max": 0.2},
}
SAMPLING = dict(T_infer=4, r=4, greedy=True, posterior_mode="map", sampling_mode="exact",
                ref_compat=True)
# non-greedy: two jumps, so the first step's draw reaches the output
NONGREEDY = dict(SAMPLING, T_infer=4, r=2, greedy=False, posterior_mode="average")
GRID = [(1, N_SHORT), (2, N)]  # largest samples not a multiple of the smallest
SERVE_RESULT_KEYS = {"wav", "text", "ids", "confidence", "T_infer", "r", "greedy",
                     "posterior_mode"}


def _write_vocab(path):
    lines = ["<unk>\t0", "<s>\t0", "</s>\t0", "<pad>\t0"]
    lines += [f"{chr(0x4E00 + i)}\t{-(i + 1)}" for i in range(K - 4)]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX pipeline, port pipeline on the CPU, dir, decoder .pt, vocab):
    the same weights, both with the condition mask on."""
    tmp = tmp_path_factory.mktemp("aot_torch")
    vocab = _write_vocab(tmp / "spm.vocab")
    jcfg = JaxConfig(CFG)
    specials = {"pad_id": 3, "bos_id": 1, "eos_id": 2, "unk_id": None}
    jp = JaxPipeline(jcfg, {}, {}, JD.make_schedule(K, 200, 0.2), jax_load_tokenizer(vocab),
                     specials, build_wavlm_config(jcfg.model.encoder), use_condition_mask=True)
    jp.decoder_params = jax.jit(jp.decoder.init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1,), jnp.int32),
        jnp.zeros((1, 16, 32)))
    jp.encoder_params = jax.jit(jp.encoder.init)(jax.random.key(1), jnp.zeros((1, 640)))
    ckpt = str(tmp / "dec.pt")
    save_reference_checkpoint(ckpt, jp.decoder_params["params"])
    backbone = jax.tree.map(np.asarray, jp.encoder_params["params"]["backbone"])
    tp = FDDMPipeline.from_config(Config(CFG), ckpt_path=ckpt, tokenizer=load_tokenizer(vocab),
                                  wavlm_state_dict=wavlm_state_dict_from_jax_params(backbone),
                                  device="cpu", use_condition_mask=True)
    return jp, tp, tmp, ckpt, vocab


@pytest.fixture(scope="module")
def artifact(pair):
    _, tp, tmp, _, vocab = pair
    art = str(tmp / "artifact")
    aot.save_artifact(tp, art, GRID, seq_len=SEQ_LEN, sampling=SAMPLING, tokenizer_path=vocab)
    return art


@pytest.fixture(scope="module")
def ep(artifact):
    return aot.ExportedPipeline.load(artifact, device="cpu")


def _wave(rows, samples=N, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal((rows, samples))).astype(
        np.float32)


def _x_T(rows, seed):
    """The x_T the artifact draws for `seed` at a bucket of `rows` rows."""
    return torch.randint(0, K, (rows, SEQ_LEN), generator=torch.Generator().manual_seed(seed))


def _live(tp, wave, lengths, seed, sampling=SAMPLING):
    return tp.transcribe_with_ids(wave, lengths, seq_len=SEQ_LEN,
                                  generator=torch.Generator().manual_seed(seed),
                                  with_confidence=True, **sampling)


def _jax_rows(jp, wave, lengths, x_T):
    c, c_mask = jp.encode_waveform(wave, lengths)
    scfg = JS.SamplerConfig(K=K, T_train=200, **{k: SAMPLING[k] for k in (
        "T_infer", "r", "greedy", "posterior_mode", "sampling_mode", "ref_compat")})

    def decoder_apply(params, xt, t, cond, cm):
        return jp.decoder.apply(params, xt, t, cond, None, cm, deterministic=True)

    ids, p = JS.make_sample_fn(decoder_apply, jp.sched, scfg)(
        jp.decoder_params, jax.random.key(0), c, SEQ_LEN, c_mask, jnp.asarray(x_T.numpy()))
    ids, p = np.asarray(ids), np.asarray(p)
    return [(row.tolist(), utterance_confidence(row, p_row, 3, jp.special_ids))
            for row, p_row in zip(ids, p)]


# ------------------------------------------------------ 1. the transcripts
def test_exported_matches_live_port_and_jax_pipelines(pair, ep):
    jp, tp, *_ = pair
    wave, lengths = _wave(2), np.array([N, 5000])
    got = ep.transcribe_with_ids(wave, lengths, seed=7, with_confidence=True)
    live = _live(tp, wave, lengths, 7)
    assert [g[1] for g in got] == [r[1] for r in live]
    assert [g[0] for g in got] == [r[0] for r in live]
    for g, r in zip(got, live):
        assert abs(g[2] - r[2]) <= 1e-5
    jax_rows = _jax_rows(jp, wave, lengths, _x_T(2, 7))
    assert [g[1] for g in got] == [ids for ids, _ in jax_rows]
    for g, (_, conf) in zip(got, jax_rows):
        assert abs(g[2] - conf) <= 1e-5
    # x_T is drawn from the seed: another seed, another trajectory
    assert [g[1] for g in ep.transcribe_with_ids(wave, lengths, seed=8)] != [
        g[1] for g in got]


def test_bucket_padding_and_selection(pair, ep):
    """One shorter row pads into the (2, N) bucket, zeros and a pad row of
    one receptive field; the ids are the live pipeline's at that shape."""
    _, tp, *_ = pair
    short = _wave(1, N - 1024, seed=3)
    got = ep.transcribe_with_ids(short, seed=5)
    assert len(got) == 1
    padded = np.zeros((2, N), np.float32)
    padded[0, : N - 1024] = short[0]
    assert got[0][1] == _live(tp, padded, np.array([N - 1024, 400]), 5)[0][1]
    assert ep.pick_bucket(1, 100) == (1, N_SHORT)
    assert ep.pick_bucket(1, N_SHORT + 1) == (2, N)
    with pytest.raises(ValueError):
        ep.pick_bucket(3, N)  # no bucket with batch >= 3
    with pytest.raises(ValueError):
        ep.pick_bucket(1, N + 1)  # audio longer than any bucket


def test_pick_bucket_equals_jax_on_a_grid():
    grid = [(1, 4800), (2, 4800), (2, 8000), (8, 8000), (4, 16000), (16, 320000)]
    port = object.__new__(aot.ExportedPipeline)
    port.buckets = grid
    jax_ep = object.__new__(JaxExportedPipeline)
    jax_ep._modules, jax_ep.native = dict.fromkeys(grid), {}
    for rows in (1, 2, 3, 4, 8, 9, 16, 17):
        for samples in (1, 4800, 4801, 8000, 8001, 16000, 320000, 320001):
            try:
                want = JaxExportedPipeline.pick_bucket(jax_ep, rows, samples)
            except ValueError:
                with pytest.raises(ValueError):
                    port.pick_bucket(rows, samples)
                continue
            assert port.pick_bucket(rows, samples) == want, (rows, samples)


# --------------------------------------------------------- 2. the artifact
def test_params_npz_bf16_roundtrip(tmp_path):
    enc = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 3,
           "inner.b": torch.tensor([1.5, -2.0]), "scalar": torch.tensor(7.25)}
    dec = {"emb": torch.arange(4, dtype=torch.int64)}
    path = str(tmp_path / "p.npz")
    aot.save_params_npz(path, enc, dec)
    enc2, dec2 = aot.load_params_npz(path)
    for want, got in ((enc, enc2), (dec, dec2)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert torch.equal(got[k].view(torch.uint8) if got[k].dim() else got[k],
                               want[k].view(torch.uint8) if want[k].dim() else want[k])


def test_no_program_holds_the_weights(pair, artifact):
    """The weights go to params.npz once: a program file keeps no state,
    no example inputs and no weight's bytes, and is far smaller."""
    _, tp, *_ = pair
    meta = json.load(open(os.path.join(artifact, "meta.json")))
    assert meta["program"] == "torch.export" and meta["mesh"] is None
    params = os.path.getsize(os.path.join(artifact, "params.npz"))
    head = tp.decoder.head.weight.detach().contiguous().numpy().tobytes()[:256]
    for n in sorted({n for _, n in GRID}):
        path = os.path.join(artifact, f"module_n{n}.pt2")
        program = torch.export.load(path)
        assert not program.state_dict and program.example_inputs is None
        assert sum(c.numel() * c.element_size() for c in program.constants.values()) < 4096
        with zipfile.ZipFile(path) as z:
            assert not any(head in z.read(i) for i in z.namelist())
        assert os.path.getsize(path) < 10 * params


def test_meta_has_every_key_of_the_jax_meta(artifact):
    """scripts/export_model.py's artifacts carry these keys (fddm_asr_tpu/aot.py
    `save_artifact`); the port adds what its programs are."""
    jax_keys = {"format_version", "jax_version", "mesh", "platforms", "seq_len", "sampling",
                "buckets", "vocab_size", "special_ids", "use_condition_mask",
                "device_confidence", "input_encoding", "tokenizer_file"}
    meta = json.load(open(os.path.join(artifact, "meta.json")))
    assert jax_keys <= set(meta) and {"program", "torch_version"} <= set(meta)
    assert meta["platforms"] == ["cpu"] and meta["buckets"] == [list(b) for b in GRID]
    assert meta["sampling"] == aot.resolve_sampling(SAMPLING)


def test_fresh_process_loads_without_model_code(pair, artifact, tmp_path):
    """A serving host loads and runs the artifact with no module of
    `fddm_asr_tpu_torch.models` (nor JAX) imported."""
    _, tp, *_ = pair
    wave, lengths = _wave(2, seed=11), np.array([N, 6000])
    expected = [r[1] for r in _live(tp, wave, lengths, 3)]
    np.save(str(tmp_path / "wave.npy"), wave)
    script = f"""
import builtins, sys
sys.path.insert(0, {REPO!r})
_real_import = builtins.__import__
def _guard(name, *a, **k):
    if name.startswith(("fddm_asr_tpu_torch.models", "jax", "fddm_asr_tpu.")):
        raise ImportError(f"model code imported at serving time: {{name}}")
    return _real_import(name, *a, **k)
builtins.__import__ = _guard
import numpy as np
from fddm_asr_tpu_torch.aot import ExportedPipeline
ep = ExportedPipeline.load({artifact!r}, device="cpu")
got = [ids for _, ids in ep.transcribe_with_ids(np.load({str(tmp_path / "wave.npy")!r}),
                                                np.array([{N}, 6000]), seed=3)]
assert got == {expected!r}, got
assert not [m for m in sys.modules if m.startswith("fddm_asr_tpu_torch.models")]
print("FRESH_PROCESS_OK")
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "FRESH_PROCESS_OK" in res.stdout


@pytest.mark.parametrize("encoding", ["pcm16", "mulaw8"])
def test_wire_encoded_artifacts(pair, tmp_path, encoding):
    """The program takes the wire dtype and expands it as its first step:
    the ids of the live pipeline fed the same codes, from float or code
    input alike."""
    _, tp, _, _, vocab = pair
    art = str(tmp_path / encoding)
    aot.save_artifact(tp, art, [(2, N)], seq_len=SEQ_LEN, sampling=SAMPLING,
                      tokenizer_path=vocab, input_encoding=encoding)
    exp = aot.ExportedPipeline.load(art, device="cpu")
    assert exp.input_encoding == encoding
    wave = _wave(2) * 0.1
    codes = (np.clip(np.round(wave * 32768.0), -32768, 32767).astype(np.int16)
             if encoding == "pcm16" else mulaw_encode(wave))
    got = exp.transcribe_with_ids(wave, seed=7)
    assert [g[1] for g in got] == [r[1] for r in _live(tp, codes, None, 7)]
    assert [g[1] for g in exp.transcribe_with_ids(codes, seed=7)] == [g[1] for g in got]


def test_a_jax_artifact_raises_naming_the_export_cli(tmp_path):
    (tmp_path / "meta.json").write_text(json.dumps({"format_version": 1, "buckets": [[1, N]]}))
    with pytest.raises(ValueError, match="fddm_asr_tpu_torch.export_model"):
        aot.ExportedPipeline.load(str(tmp_path), device="cpu")


def test_the_loader_needs_a_gpu_unless_told_cpu(artifact):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aot.ExportedPipeline.load(artifact)  # CUDA by default


# ------------------------------------------------------ 3. non-greedy draws
def test_categorical_draws_follow_the_probabilities():
    """Inverse-CDF draws from one uniform a position: the frequencies of
    200k draws sit within 5 standard errors of the probabilities, and a
    token of probability 0 is never drawn (the first, the last, inside)."""
    g = torch.Generator().manual_seed(0)
    probs = torch.tensor([0.0, 0.05, 0.3, 0.0, 0.15, 0.4, 0.1, 0.0])
    n = 200_000
    draws = categorical(probs.expand(n, -1), torch.rand(n, generator=g))
    freq = torch.bincount(draws, minlength=len(probs)).double() / n
    se = (probs.double() * (1 - probs.double()) / n).sqrt()
    assert torch.all((freq - probs.double()).abs() <= 5 * se + 1e-12), freq
    assert freq[probs == 0].sum() == 0
    # unnormalised rows and the edges of [0, 1)
    assert categorical(torch.tensor([[0.0, 2.0, 2.0]]), torch.tensor([0.0])).item() == 1
    assert categorical(torch.tensor([[1.0, 1.0, 0.0]]),
                       torch.tensor([1.0 - 2 ** -24])).item() == 1


def test_nongreedy_exported_equals_live(pair, tmp_path):
    """The program takes the steps' uniforms, drawn after x_T from the same
    generator: exported equals live non-greedy at the same seed."""
    _, tp, _, _, vocab = pair
    art = str(tmp_path / "nongreedy")
    meta = aot.save_artifact(tp, art, [(2, N)], seq_len=SEQ_LEN, sampling=NONGREEDY,
                             tokenizer_path=vocab)
    assert meta["sampling"]["greedy"] is False
    exp = aot.ExportedPipeline.load(art, device="cpu")
    assert exp.draws == 2
    wave, lengths = _wave(2, seed=4), np.array([N, 7000])
    for seed in (1, 2):
        got = exp.transcribe_with_ids(wave, lengths, seed=seed)
        assert [g[1] for g in got] == [r[1] for r in _live(tp, wave, lengths, seed, NONGREEDY)]
    greedy = [r[1] for r in _live(tp, wave, lengths, 1)]
    draws = [[r[1] for r in _live(tp, wave, lengths, s, NONGREEDY)] for s in range(1, 6)]
    assert any(d != greedy for d in draws)  # the draws reach the ids


# ------------------------------------------------------------- 4. the CLI
def test_cli_bucket_grid_parsing_matches_the_jax_script():
    from fddm_asr_tpu_torch.export_model import parse_buckets
    from scripts.export_model import parse_buckets as jax_parse_buckets

    for batches, seconds in (("1,8", "5,20"), ("2", "0.5"), ("1,2,4,8,16", "5,10,20"),
                             ("16,1", "20,5")):
        assert parse_buckets(batches, seconds) == jax_parse_buckets(batches, seconds)
    for batches, seconds in (("", "20"), ("1", "")):
        with pytest.raises(ValueError):
            parse_buckets(batches, seconds)
        with pytest.raises(ValueError):
            jax_parse_buckets(batches, seconds)


def _jax_cli_summary_keys():
    """The keys of scripts/export_model.py's JSON summary line, from its source."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "export_model.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in scripts/export_model.py")


def _cli_files(pair):
    jp, tp, tmp, ckpt, vocab = pair
    cfg = tmp / "config.yaml"
    cfg.write_text(json.dumps(CFG))  # JSON is YAML
    return str(cfg), ckpt, vocab


def test_export_cli(pair, tmp_path, capsys):
    """.pt checkpoint -> artifact -> ids equal to the live pipeline built
    from the same arguments; the summary line has the JAX script's keys."""
    from fddm_asr_tpu_torch import inference as infer_cli
    from fddm_asr_tpu_torch.export_model import main as export_main

    cfg, ckpt, vocab = _cli_files(pair)
    out = str(tmp_path / "artifact")
    argv = ["--ckpt", ckpt, "--main-config", cfg, "--diffusion-config", cfg,
            "--tokenizer", vocab, "--out", out, "--batch-sizes", "2", "--seconds", "0.5",
            "--seq-len", str(SEQ_LEN), "--T-infer", "4", "--r", "4", "--greedy",
            "--posterior-mode", "map", "--device", "cpu", "--condition-mask", "on",
            "--native", "on", "--native-batch-sizes", "1", "--fused-attention", "off"]
    assert export_main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == _jax_cli_summary_keys()
    # --native-batch-sizes: ordinary buckets; the CPU replays no graph
    assert summary["buckets"] == [[1, N], [2, N]] and summary["native_buckets"] is None
    assert summary["platforms"] == ["cpu"] and summary["fused_attention"] is True
    assert summary["artifact_bytes"] > os.path.getsize(os.path.join(out, "params.npz"))

    exp = aot.ExportedPipeline.load(out, device="cpu")
    live = infer_cli.build_pipeline(infer_cli.parse_args(
        ["--wav", "x.wav", "--ckpt", ckpt, "--main-config", cfg, "--diffusion-config", cfg,
         "--tokenizer", vocab, "--device", "cpu"]))
    live.use_condition_mask = True
    wave, lengths = _wave(2, seed=21), np.array([N, 6500])
    got = exp.transcribe_with_ids(wave, lengths, seed=1)
    assert [g[1] for g in got] == [r[1] for r in _live(live, wave, lengths, 1)]


@pytest.mark.parametrize("extra,match", [
    # a mesh exports sharded programs over a process group
    # (tests/test_torch_aot_mesh.py): in one process it asks for the
    # launcher, and --seq-parallel for a model axis, as the server's does
    pytest.param(["--mesh", "data=2"], r"torchrun --nproc_per_node 2", id="extra0-A7"),
    pytest.param(["--seq-parallel"], r"give --mesh model=N", id="extra1-A7"),
    (["--platforms", "tpu"], "cuda or cpu"), (["--platforms", "cuda"], "traced on"),
])
def test_export_cli_raises(pair, tmp_path, extra, match):
    from fddm_asr_tpu_torch.export_model import main as export_main

    cfg, ckpt, vocab = _cli_files(pair)
    with pytest.raises(SystemExit, match=match):
        export_main(["--ckpt", ckpt, "--main-config", cfg, "--diffusion-config", cfg,
                     "--tokenizer", vocab, "--out", str(tmp_path / "a"), "--device", "cpu",
                     *extra])


@pytest.mark.parametrize("entry", ["inference", "serve", "export_model"])
def test_an_orbax_ckpt_directory_raises_naming_the_export_script(pair, tmp_path, entry):
    """An orbax `--ckpt` (a directory) needs JAX to read: every entry point
    that loads a decoder checkpoint says so instead of IsADirectoryError."""
    from fddm_asr_tpu_torch import export_model, inference

    cfg, _, vocab = _cli_files(pair)
    orbax = tmp_path / "ckpt_orbax"
    orbax.mkdir()
    common = ["--ckpt", str(orbax), "--tokenizer", vocab, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="export_torch_encoder.py"):
        if entry == "inference":
            wav = str(tmp_path / "a.wav")
            TA.save_wav(wav, _wave(1)[0], 16000)
            inference.main(["--wav", wav, "--main-config", cfg, "--diffusion-config", cfg,
                            *common])
        elif entry == "serve":
            S.build_server(S.parse_args(["--config", cfg, "--port", "0", *common]))
        else:
            export_model.main(["--main-config", cfg, "--diffusion-config", cfg,
                               "--out", str(tmp_path / "a"), *common])


# ---------------------------------------------------------- 5. the server
@pytest.fixture
def exported_server(artifact, ep, monkeypatch):
    """`serve --exported` on the module's artifact (its loaded programs
    reused: a load is seconds of the file's time), serving on port 0."""
    monkeypatch.setattr(aot.ExportedPipeline, "load",
                        classmethod(lambda cls, path, device=None: ep))
    servers = []

    def start(*extra):
        srv = S.build_server(S.parse_args(["--exported", artifact, "--port", "0",
                                           "--max-wait-ms", "5", "--device", "cpu", *extra]))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    yield start
    for srv in servers:
        srv.shutdown()
        srv.server_close()
        srv.engine.shutdown()


def _post(base, path, body, content_type="audio/wav"):
    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read().decode("utf-8"))


def test_serve_exported_artifact(ep, exported_server, tmp_path):
    """The engine's buckets and sampling come from the meta; a served
    request has the root server's result keys and the ids of the artifact
    at the engine's padded batch and counter."""
    srv, base = exported_server()
    engine = srv.engine
    assert engine.max_batch == 2 and engine.seq_len == SEQ_LEN
    assert engine.bucket == N_SHORT and engine.max_samples == N
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        health = json.loads(r.read().decode("utf-8"))
    assert health["T_infer"] == SAMPLING["T_infer"] and health["native_buckets"] == []
    wav_path = str(tmp_path / "clip.wav")
    TA.save_wav(wav_path, _wave(1, 7000, seed=2)[0], 16000)
    res = _post(base, "/v1/transcribe", open(wav_path, "rb").read())
    assert set(res) == SERVE_RESULT_KEYS
    wave, _ = TA.load_audio(wav_path, target_sr=16000, mono=True)
    padded = np.zeros((1, N), np.float32)  # 0.3 s buckets, clamped to the largest
    padded[0, :len(wave)] = wave
    (text, ids, conf), = ep.transcribe_with_ids(
        padded, np.array([len(wave)]), generator=torch.Generator().manual_seed(1),
        with_confidence=True)  # the first batch takes counter 1
    assert res["ids"] == ids and res["text"] == text
    assert abs(res["confidence"] - conf) < 1e-6


def test_serve_exported_nonmultiple_buckets_and_long_form(exported_server):
    """0.35 s rounds up to 0.6 s of 0.3 s buckets, past the largest (0.5 s):
    clamped, it is served; 1.2 s is windowed at 0.5 s and the texts join."""
    srv, base = exported_server()
    res = srv.engine.submit(_wave(1, 5600, seed=9)[0], "mid.wav")
    assert "error" not in res and isinstance(res["text"], str)
    long = srv.engine.submit(_wave(1, int(1.2 * 16000), seed=4)[0] * 0.1, "long.wav")
    assert "error" not in long and len(long["chunks"]) >= 3
    assert long["text"] == "".join(long["chunks"])


@pytest.mark.parametrize("extra,match", [
    (["--num-candidates", "2"], "num-candidates"), (["--max-batch", "3"], "max-batch 3"),
    (["--wire-dtype", "pcm16"], "conflicts"),
])
def test_serve_exported_raises(exported_server, extra, match):
    with pytest.raises(SystemExit, match=match):
        exported_server(*extra)


def test_serve_exported_warns_on_a_condition_mask_off_artifact(ep, exported_server,
                                                               monkeypatch):
    monkeypatch.setitem(ep.meta, "use_condition_mask", False)
    with pytest.warns(UserWarning, match="condition-mask off"):
        exported_server()
