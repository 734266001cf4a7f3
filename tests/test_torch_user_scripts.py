# -*- coding: utf-8 -*-
"""The port's user scripts (`python -m fddm_asr_tpu_torch.scripts.<name>`)
against the repository's JAX scripts, on the CPU at tiny sizes, over a
corpus the port's `make_synth_data` writes (4 clips a split of 0.5 s, a
96-piece tokenizer, a tiny WavLM under a d32 decoder; made from a seed):

  make_synth_data      every file of both styles byte for byte (absolute
                       paths aside: each side writes its own directory);
  average_checkpoints  the `.pt` of three inputs (one written by the JAX
                       package) bit for bit, and --last k;
  sweep                --dry-run's assignments (random and grid) and every
                       trial's config.yaml equal; one tiny trial writes
                       result.json and summary.json;
  init_random_ckpt     its `.pt` holds the port's `run_training` epoch-0
                       weights, the JAX `load_checkpoint_any` reads it, and
                       --make-tokenizer's files are the JAX script's;
  precompute_features  the cache equals the JAX script's within float32
                       tolerance, at the JAX pipeline's encoder carried across
                       (--encoder-ckpt), and `run_training` accepts it;
  validate_quant       at the JAX pipeline's weights and one injected x_init
                       on both sides (the JAX sampler's `x_init` argument),
                       the report of fp, int8, pcm16 and mulaw8 equals the
                       JAX script's; int8 changes the sampler's p_x0.

Pinned differences: the random-init `.pt` holds the port's draws, not the
JAX package's; average_checkpoints and validate_quant take `.pt` files,
and an orbax directory raises naming scripts/export_torch_encoder.py;
sweep parses --mesh with the port's `parallel.parse_mesh`.  Every script
that builds a model raises without a GPU unless given --device cpu."""
import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu import checkpoint as JC
from fddm_asr_tpu import pipeline as JP
from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import load_config
from fddm_asr_tpu_torch.convert import acoustic_encoder_state_dict_from_jax_params
from fddm_asr_tpu_torch.scripts import average_checkpoints as AVG
from fddm_asr_tpu_torch.scripts import init_random_ckpt as INIT
from fddm_asr_tpu_torch.scripts import make_synth_data as SYNTH
from fddm_asr_tpu_torch.scripts import precompute_features as PRE
from fddm_asr_tpu_torch.scripts import sweep as SWEEP
from fddm_asr_tpu_torch.scripts import validate_quant as VQ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

SCRIPTS = ("preprocess", "tokenizer_train", "make_synth_data", "init_random_ckpt",
           "average_checkpoints", "sweep", "precompute_features", "validate_quant")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The port's smoke corpus, config and tokenizer."""
    out = tmp_path_factory.mktemp("synth")
    SYNTH.main(["--out", str(out), "--n", "4", "--seconds", "0.5"])
    return out


@pytest.fixture(scope="module")
def jax_runs(synth, tmp_path_factory):
    """The JAX `precompute_features.py` and `validate_quant.py` over `synth`,
    with the pipelines they build recorded, the sampler's x_T injected, and
    the port's random-init `.pt` as the checkpoint."""
    import precompute_features as jax_pre
    import validate_quant as jax_vq

    from fddm_asr_tpu import runtime

    tmp = tmp_path_factory.mktemp("jax_runs")
    mp = pytest.MonkeyPatch()
    built = []
    from_config = JP.FDDMPipeline.from_config.__func__

    def recording(cls, *a, **k):
        built.append(from_config(cls, *a, **k))
        return built[-1]

    cfg = load_config(str(synth / "config.yaml"))
    seq_len = int(cfg.data.max_len)
    x_init = np.random.default_rng(21).integers(0, cfg.data.vocab_size, (4, seq_len))

    def with_x_init(decoder_apply, sched, scfg):
        base = JS.make_sample_fn(decoder_apply, sched, scfg)
        return lambda params, rng, cond, seq_len, c_mask=None: base(
            params, rng, cond, seq_len, c_mask, jnp.asarray(x_init))

    ckpt = str(tmp / "random.pt")
    INIT.main(["--config", str(synth / "config.yaml"), "--out", ckpt, "--device", "cpu"])
    try:
        mp.setattr(runtime, "enable_compile_cache", lambda *a, **k: None)
        mp.setattr(JP.FDDMPipeline, "from_config", classmethod(recording))
        mp.setattr(JP, "make_sample_fn", with_x_init)
        jax_pre.main(["--config", str(synth / "config.yaml"), "--cache-dir", str(tmp / "feats"),
                      "--splits", "train,test", "--device", "cpu"])
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            jax_vq.main(["--config", str(synth / "config.yaml"), "--ckpt", ckpt,
                         "--manifest", str(synth / "data/processed/test.json"),
                         "--variants", "fp,int8,pcm16,mulaw8", "--device", "cpu"])
    finally:
        mp.undo()
    encoder = tmp / "encoder.pt"
    params = jax.tree.map(np.asarray, built[0].encoder_params["params"])
    torch.save(acoustic_encoder_state_dict_from_jax_params(params), str(encoder))
    return {"feats": tmp / "feats", "report": json.loads(buf.getvalue().strip().splitlines()[-1]),
            "encoder": str(encoder), "ckpt": ckpt, "x_init": x_init, "seq_len": seq_len}


# ------------------------------------------------------------ make_synth_data
def _tree(root):
    """{relative path: bytes} of every file under `root`, its absolute path
    written as <OUT>."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            out[os.path.relpath(path, root)] = open(path, "rb").read().replace(
                str(root).encode(), b"<OUT>")
    return out


@pytest.mark.parametrize("argv", [["--n", "3", "--seconds", "0.4"],
                                  ["--style", "words", "--n", "3", "--seconds", "1.0",
                                   "--max-seconds", "2.2", "--n-chars", "12",
                                   "--vocab-size", "20"]], ids=["sentences", "words"])
def test_make_synth_data_writes_the_jax_scripts_files(tmp_path, argv):
    import make_synth_data as jax_cli

    jax_cli.main(["--out", str(tmp_path / "jax"), *argv])
    SYNTH.main(["--out", str(tmp_path / "port"), *argv])
    ours, theirs = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs) and len(ours) > 10
    for name in theirs:
        assert ours[name] == theirs[name], name
    for name in ("config.yaml", "config_flagship.yaml", "config_convergence.yaml"):
        if name in ours:
            cfg = load_config(str(tmp_path / "port" / name))
            assert cfg.data.vocab_size == int(argv[argv.index("--vocab-size") + 1]
                                              if "--vocab-size" in argv else 96)


# --------------------------------------------------------- average_checkpoints
def _write_pt(synth, path, seed):
    cfg = load_config(str(synth / "config.yaml")).updated({"seed": seed})
    pipe = TL.training_pipeline(cfg, device="cpu")
    host = [{k: v.detach().clone() for k, v in m.state_dict().items()}
            for m in (pipe.decoder, *TL.training_heads(cfg, pipe))]
    from fddm_asr_tpu_torch.checkpoint import save_reference_ckpt

    save_reference_ckpt(str(path), *host, epoch=seed, step=10 * seed, config=cfg.to_dict())


@pytest.fixture(scope="module")
def three_checkpoints(synth, tmp_path_factory):
    """ep001.pt and ep002.pt by the port, ep010.pt by the JAX package's
    writer (ep001's trees through the JAX loader, moved by numpy noise)."""
    d = tmp_path_factory.mktemp("avg")
    _write_pt(synth, d / "ep001.pt", 1)
    _write_pt(synth, d / "ep002.pt", 2)
    ck = JC.load_checkpoint_any(str(d / "ep001.pt"))
    rng = np.random.default_rng(3)
    moved = {k: jax.tree.map(lambda x: (np.asarray(x) + rng.standard_normal(np.shape(x))
                                        .astype(np.float32)), ck[k])
             for k in ("decoder", "s_proj", "t_embed", "t_proj")}
    JC.export_reference_ckpt(str(d / "ep010.pt"), moved["decoder"], moved["s_proj"],
                             moved["t_embed"], moved["t_proj"], epoch=10, step=99)
    return d


def _pt(path):
    return torch.load(str(path), map_location="cpu", weights_only=False)


def _assert_same_pt(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, dict) and value and all(torch.is_tensor(t) for t in value.values()):
            assert set(got[key]) == set(value), key
            for name, t in value.items():
                assert got[key][name].dtype == t.dtype, (key, name)
                assert torch.equal(got[key][name], t), (key, name)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("how", ["explicit", "last"])
def test_average_checkpoints_equals_the_jax_script_bit_for_bit(three_checkpoints, tmp_path,
                                                               how):
    import average_checkpoints as jax_cli

    d = three_checkpoints
    args = ([str(d / n) for n in ("ep002.pt", "ep010.pt", "ep001.pt")] if how == "explicit"
            else ["--last", "2", "--ckpt-dir", str(d)])
    jax_cli.main([*args, "--out", str(tmp_path / "jax.pt")])
    AVG.main([*args, "--out", str(tmp_path / "port.pt")])
    got, want = _pt(tmp_path / "port.pt"), _pt(tmp_path / "jax.pt")
    _assert_same_pt(got, want)
    assert got["epoch"] == 10 and got["step"] == 99 and got["config"] is None
    inputs = [_pt(d / n)["decoder"]["tok_emb.weight"].double() for n in (
        ("ep002.pt", "ep010.pt", "ep001.pt") if how == "explicit" else ("ep002.pt", "ep010.pt"))]
    mean = (sum(inputs) / len(inputs)).float()
    assert torch.equal(got["decoder"]["tok_emb.weight"], mean)
    assert AVG.collect_last(str(d), 2) == jax_cli.collect_last(str(d), 2)


def test_average_checkpoints_refuses_orbax_and_too_few(three_checkpoints, tmp_path):
    orbax = tmp_path / "ep003.orbax"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="export_torch_encoder.py"):
        AVG.main([str(orbax), str(three_checkpoints / "ep001.pt"), "--out",
                  str(tmp_path / "a.pt")])
    with pytest.raises(SystemExit, match="at least two"):
        AVG.main([str(three_checkpoints / "ep001.pt"), "--out", str(tmp_path / "a.pt")])
    with pytest.raises(SystemExit, match="--ckpt-dir"):
        AVG.main(["--last", "2", "--out", str(tmp_path / "a.pt")])
    assert AVG.collect_last(str(three_checkpoints), 9) == [
        str(three_checkpoints / n) for n in ("ep001.pt", "ep002.pt", "ep010.pt")]


# --------------------------------------------------------------------- sweep
@pytest.mark.parametrize("mode,trials,seed", [("random", 4, 3), ("grid", 5, 0)])
def test_sweep_dry_run_equals_the_jax_script(tmp_path, monkeypatch, capsys, mode, trials, seed):
    import sweep as jax_cli

    from fddm_asr_tpu_torch.config import load_yaml

    space = load_yaml(os.path.join(REPO, "configs/fddm_sweep.yaml"))
    space["base_config"] = os.path.join(REPO, "configs/fddm_zhTW_base.yaml")
    (tmp_path / "sweep.yaml").write_text(json.dumps(space))
    printed = {}
    for name, main in (("jax", jax_cli.main), ("port", SWEEP.main)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        main(["--sweep", "../sweep.yaml", "--trials", str(trials), "--mode", mode, "--seed",
              str(seed), "--out", "sw", "--epochs", "3", "--dry-run"])
        printed[name] = [line for line in capsys.readouterr().out.splitlines()
                         if line.startswith("[trial")]
    assert printed["port"] == printed["jax"] and len(printed["port"]) == trials
    for i in range(trials):
        rel = f"sw/trial_{i:03d}/config.yaml"
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    leaves = list(jax_cli.iter_search_leaves(space))
    assert [p for p, _ in SWEEP.iter_search_leaves(space)] == [p for p, _ in leaves]
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _, leaf in leaves:
        assert SWEEP.sample_leaf(leaf, rng_a) == jax_cli.sample_leaf(leaf, rng_b)
        assert SWEEP.grid_leaf(leaf) == jax_cli.grid_leaf(leaf)
    assert SWEEP.materialise(space, {}) == jax_cli.materialise(space, {})


def test_sweep_runs_a_tiny_trial_and_ranks_it(synth, tmp_path, monkeypatch, capsys):
    space = {"base_config": str(synth / "config.yaml"),
             "optim": {"lr": {"distribution": "log_uniform", "min": 1e-4, "max": 1e-3}},
             "log": {"run_lock": False}}
    (tmp_path / "sweep.yaml").write_text(json.dumps(space))
    monkeypatch.chdir(tmp_path)
    SWEEP.main(["--sweep", "sweep.yaml", "--trials", "1", "--epochs", "1",
                "--max-steps-per-epoch", "1", "--out", "sw", "--device", "cpu",
                "--mesh", "data=1"])
    result = json.loads((tmp_path / "sw/trial_000/result.json").read_text())
    assert "error" not in result, result
    assert set(result["assignment"]) == {"optim/lr"} and result["epoch"] == 1
    assert np.isfinite(result["train_loss"]) and result["best_val_cer"] is not None
    (ranked,) = json.loads((tmp_path / "sw/summary.json").read_text())
    assert ranked["trial"] == 0 and ranked["best_val_cer"] == result["best_val_cer"]
    assert "== sweep ranking" in capsys.readouterr().out


def test_sweep_parses_the_mesh_with_the_ports_parser(tmp_path):
    """--mesh goes through `parallel.parse_mesh` (the JAX script imports the
    root train.py's parser): an unknown axis raises before any trial."""
    (tmp_path / "s.yaml").write_text(json.dumps(
        {"base_config": os.path.join(REPO, "configs/fddm_zhTW_base.yaml")}))
    with pytest.raises(ValueError, match=r"unknown axes \['pipeline'\] \(data, model\)"):
        SWEEP.main(["--sweep", str(tmp_path / "s.yaml"), "--trials", "1", "--out",
                    str(tmp_path / "sw"), "--device", "cpu", "--mesh", "pipeline=2"])
    assert not (tmp_path / "sw").exists()


# ----------------------------------------------------------- init_random_ckpt
class _Epoch0(Exception):
    pass


def test_init_random_ckpt_holds_run_trainings_epoch0_weights(synth, tmp_path, monkeypatch,
                                                              capsys):
    import init_random_ckpt as jax_cli

    cfg_path = str(synth / "config.yaml")
    INIT.main(["--config", cfg_path, "--out", str(tmp_path / "r/random.pt"), "--device", "cpu",
               "--make-tokenizer"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["out"] == str(tmp_path / "r/random.pt") and line["bytes"] > 0
    assert line["tokenizer"] == str(tmp_path / "r/spm_synth.model")
    ck = _pt(tmp_path / "r/random.pt")
    assert ck["epoch"] == 0 and ck["step"] == 0
    assert ck["config"] == load_config(cfg_path).to_dict()
    # the weights run_training starts from, captured as its state is made
    seen = {}
    make_state = TL.init_train_state

    def capture(pipeline, cfg, **kw):
        state = make_state(pipeline, cfg, **kw)
        for key in ("decoder", "s_proj", "t_embed", "t_proj"):
            seen[key] = {k: v.detach().clone() for k, v in getattr(state, key).state_dict()
                         .items()}
        raise _Epoch0

    monkeypatch.setattr(TL, "init_train_state", capture)
    cfg = load_config(cfg_path).updated({"log": {"ckpt_dir": str(tmp_path / "ck")}})
    with pytest.raises(_Epoch0):
        TL.run_training(cfg, device="cpu")
    for key, sd in seen.items():
        assert set(ck[key]) == set(sd), key
        for name, t in sd.items():
            assert torch.equal(ck[key][name], t), (key, name)
    assert line["params"] == sum(t.numel() for n, t in seen["decoder"].items()
                                 if n != "pos_emb.inv_freq")
    # the JAX package's loader reads it
    loaded = JC.load_checkpoint_any(str(tmp_path / "r/random.pt"))
    assert loaded["epoch"] == 0 and loaded["s_proj"] is not None
    assert sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(loaded["decoder"])) == \
        line["params"]
    # --make-tokenizer: the JAX script's files
    jax_cli._make_synthetic_tokenizer(str(tmp_path / "j/spm_synth"), 96)
    for name in ("spm_synth.model", "spm_synth.vocab"):
        assert (tmp_path / "r" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert json.loads((tmp_path / "r/vocab.json").read_text())["id2token"] == json.loads(
        (tmp_path / "j/vocab.json").read_text())["id2token"]


def test_random_init_holds_the_ports_draws_not_the_jax_packages(synth, tmp_path):
    """Deliberate difference: the same seed draws other weights in each
    package (torch.Generator against jax.random), so the port's random-init
    `.pt` is not the JAX script's."""
    cfg = load_config(str(synth / "config.yaml"))
    INIT.main(["--config", str(synth / "config.yaml"), "--out", str(tmp_path / "p.pt"),
               "--device", "cpu"])
    ours = _pt(tmp_path / "p.pt")["decoder"]["tok_emb.weight"].numpy()
    jp = JP.FDDMPipeline(JaxConfig(cfg.to_dict()), {}, {}, None, None, {"pad_id": 3}, None)
    rng_dec, _ = jax.random.split(jax.random.key(int(cfg.seed)))
    theirs = jax.jit(jp.decoder.init)(rng_dec, jnp.zeros((1, 8), jnp.int32),
                                      jnp.ones((1,), jnp.int32),
                                      jnp.zeros((1, 16, cfg.model.d_model)))
    theirs = np.asarray(theirs["params"]["tok_emb"]["embedding"])
    assert ours.shape == theirs.shape and not np.allclose(ours, theirs)


# -------------------------------------------------------- precompute_features
def test_precompute_features_equals_the_jax_cache(synth, jax_runs, tmp_path):
    cfg = load_config(str(synth / "config.yaml"))
    out = PRE.main(["--config", str(synth / "config.yaml"), "--cache-dir", str(tmp_path),
                    "--splits", "train,test", "--encoder-ckpt", jax_runs["encoder"],
                    "--device", "cpu"])
    assert set(out) == {"train", "test"}
    for split in ("train", "test"):
        ours = np.load(tmp_path / split / "feats.npy")
        theirs = np.load(jax_runs["feats"] / split / "feats.npy")
        assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)
        assert list(out[split]["shape"]) == list(ours.shape)
    # run_training's own check of the cache: the same weights open it unbuilt
    sd = torch.load(jax_runs["encoder"], weights_only=True)
    pipe = TL.training_pipeline(cfg, encoder_state_dict=sd, device="cpu")
    manifest = cfg.data.train_json
    cache, built = TL._ensure_feature_cache(pipe, TL.training_dataset(cfg, manifest,
                                                                      pipe.tokenizer),
                                            str(tmp_path), "train",
                                            int(cfg.optim.batch_size), manifest)
    assert not built and cache.shape[0] == 4


def test_run_training_takes_a_precomputed_cache_without_rebuilding(synth, tmp_path):
    """The seed's encoder, as a run with no encoder weights builds it: the
    run's feature_cache record says it opened the cache."""
    cfg = load_config(str(synth / "config.yaml"))
    PRE.main(["--config", str(synth / "config.yaml"), "--cache-dir", str(tmp_path / "feats"),
              "--device", "cpu"])
    before = (tmp_path / "feats/train/feats.npy").read_bytes()
    cfg = cfg.updated({"data": {"cache_features": str(tmp_path / "feats")},
                       "log": {"ckpt_dir": str(tmp_path / "ck"), "metrics_jsonl": True},
                       "optim": {"num_epochs": 1}})
    TL.run_training(cfg, max_steps_per_epoch=1, export_pt=False, device="cpu", eval_every=9)
    records = [json.loads(x) for x in open(tmp_path / "ck/metrics.jsonl")]
    (cache,) = [r for r in records if r["kind"] == "feature_cache"]
    assert cache["built"] is False and cache["shape"][0] == 4
    assert (tmp_path / "feats/train/feats.npy").read_bytes() == before


# ------------------------------------------------------------- validate_quant
def test_validate_quant_report_equals_the_jax_scripts(synth, jax_runs):
    cfg = load_config(str(synth / "config.yaml"))
    records = json.load(open(synth / "data/processed/test.json", encoding="utf-8"))
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    pipes = {}
    report, variants = VQ.validate(
        cfg, jax_runs["ckpt"], records, ["fp", "int8", "pcm16", "mulaw8"],
        seq_len=jax_runs["seq_len"], T_infer=cfg.inference.T_infer, r=cfg.inference.r,
        tokenizer=load_tokenizer(cfg.data.tokenizer_path),
        encoder_state_dict=torch.load(jax_runs["encoder"], weights_only=True), device="cpu",
        x_init=jax_runs["x_init"], on_variant=lambda name, pipe: pipes.setdefault(name, pipe))
    assert report == jax_runs["report"]
    assert set(report) >= {"n", "cer_fp", "cer_int8", "transcript_agreement_int8",
                           "transcript_agreement_pcm16", "disagreements", "seq_len"}
    assert any(t for v in variants.values() for t in v["texts"])  # something was decoded
    assert pipes["pcm16"] is pipes["fp"] is pipes["mulaw8"] is not pipes["int8"]
    # the option changed something: int8's p_x0 is not fp's
    batch, lengths, _ = VQ.load_batch(records)
    p = {}
    for name in ("fp", "int8"):
        cond, mask = pipes[name].encode_waveform(batch, lengths)
        p[name] = pipes[name].sample(cond, jax_runs["seq_len"], c_mask=mask,
                                     x_init=jax_runs["x_init"])[1]
    assert not torch.equal(p["fp"], p["int8"])


def test_validate_quant_cli_takes_pt_and_encoder_ckpt(synth, jax_runs, tmp_path, capsys):
    args = ["--config", str(synth / "config.yaml"), "--ckpt", jax_runs["ckpt"],
            "--manifest", str(synth / "data/processed/test.json"), "--device", "cpu"]
    report = VQ.main([*args, "--encoder-ckpt", jax_runs["encoder"], "--variants",
                      "int8_all,int8_fused"])
    assert json.loads(capsys.readouterr().out.strip()) == report
    assert set(report) >= {"cer_int8_all", "cer_int8_fused", "transcript_agreement"}
    orbax = tmp_path / "best_model.orbax"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="export_torch_encoder.py"):
        VQ.main(["--config", str(synth / "config.yaml"), "--ckpt", str(orbax),
                 "--manifest", str(synth / "data/processed/test.json"), "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown --variants"):
        VQ.main([*args, "--variants", "fp,int4"])


# ------------------------------------------------------------ entry points
@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a GPU")
@pytest.mark.parametrize("script", ["init_random_ckpt", "precompute_features",
                                    "validate_quant", "sweep"])
def test_scripts_that_build_a_model_raise_without_a_gpu(synth, tmp_path, script):
    cfg = str(synth / "config.yaml")
    argv = {"init_random_ckpt": ["--config", cfg, "--out", str(tmp_path / "r.pt")],
            "precompute_features": ["--config", cfg, "--cache-dir", str(tmp_path)],
            "validate_quant": ["--config", cfg, "--ckpt", str(tmp_path / "none.pt"),
                               "--manifest", str(synth / "data/processed/test.json")],
            "sweep": ["--sweep", str(tmp_path / "s.yaml"), "--out", str(tmp_path / "sw")]}
    (tmp_path / "s.yaml").write_text(json.dumps({"base_config": cfg}))
    module = {"init_random_ckpt": INIT, "precompute_features": PRE, "validate_quant": VQ,
              "sweep": SWEEP}[script]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv[script])
    assert not (tmp_path / "r.pt").exists() and not (tmp_path / "sw").exists()


def test_every_script_runs_as_a_module_without_jax():
    code = (
        "import sys, runpy\n"
        "for name in sys.argv[2:]:\n"
        "    sys.argv = [name, '--help']\n"
        "    try:\n"
        "        runpy.run_module('fddm_asr_tpu_torch.scripts.' + name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'flax', 'yaml', "
        "'fddm_asr_tpu', 'pandas', 'sentencepiece'})\n"
        "print(bad, file=sys.stderr); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code, REPO, *SCRIPTS], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in SCRIPTS:
        assert f"fddm_asr_tpu_torch.scripts.{name}" in open(
            os.path.join(REPO, "fddm_asr_tpu_torch/scripts", f"{name}.py")).read()
