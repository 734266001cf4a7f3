# -*- coding: utf-8 -*-
"""The port's training entry point (`python -m fddm_asr_tpu_torch.train`,
`train_lib.run_training`, `checkpoint.py`, `profiling.py`) on the CPU at a
one-layer tiny config (one decoder layer, a one-layer tiny WavLM), over
manifests of clips of 0.1-0.3 s and the toy tokenizer of
`scripts/make_synth_data.py`.

* A frozen run with the feature cache writes ep001.{pt,state.pt,meta.json},
  best_model.* and metrics.jsonl, each with the JAX loop's keys
  (`fddm_asr_tpu/train_lib.py:1038-1050`, `:1286-1289`, `:1370-1375`,
  `convert/torch_ckpt.py:267-300`).
* The JAX `load_reference_checkpoint` reads its `.pt`, whose weights are
  the EMA's (ema_eval) or the raw ones; the JAX sampler on that `.pt` gives
  the port's ids from the same condition and injected x_T.
* A learned-position decoder's `.pt` keeps `pos_emb.weight`, which the JAX
  writer drops (ROADMAP C).
* Resume: the state comes back bit for bit (moments, counts, step, EMA;
  EMA on -> off and off -> on); `--resume` starts at epoch 2 with the
  best_val_cer carried.
* Early stop, ckpt_every, --eval-every, lfd.tau 0, collapse_restore, the
  run lock, model.init_ckpt, model.encoder.condition_mask, --profile-dir and
  --debug-nans; each opt-in knob also changes the output.
* A fine-tune run with resume (the JAX package's
  `tests/test_train_encoder.py::test_run_training_finetune_e2e_with_resume`)
  whose `.encoder.pt` the inference CLI's `--encoder-ckpt` loads.
* Raises: a mesh larger than the process group, a group without its
  coordinator, an orbax `--resume` (naming the
  export script's `--ckpt`), LoRA with a frozen encoder (as the JAX loop),
  an asynchronous checkpoint whose write fails, no GPU without --device
  cpu; and `convert.load_reference_checkpoint` on a directory names the
  port's own training output.
"""
import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fddm_asr_tpu import diffusion as JD
from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.convert.torch_ckpt import decoder_params_from_state_dict
from fddm_asr_tpu.convert.torch_ckpt import decoder_state_dict_from_params
from fddm_asr_tpu.convert.torch_ckpt import load_reference_checkpoint as jax_load_pt
from fddm_asr_tpu.pipeline import FDDMPipeline as JaxPipeline
from fddm_asr_tpu.pipeline import build_wavlm_config as jax_build_wavlm_config
from fddm_asr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from fddm_asr_tpu_torch import checkpoint as C
from fddm_asr_tpu_torch import profiling as P
from fddm_asr_tpu_torch import train as train_cli
from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import load_reference_checkpoint
from fddm_asr_tpu_torch.data.audio_io import save_wav
from fddm_asr_tpu_torch.pipeline import FDDMPipeline

SENTENCES = ["我們可以一起交流", "台灣的高速公路很大", "我們在台灣交流", "高速公路可以交流",
             "我們的交流道很大", "沒有問題可以交流", "一個大的交流道", "我們有一個問題"]

# the JAX loop's record keys (fddm_asr_tpu/train_lib.py), optional ones apart
STEP_KEYS = {"kind", "step", "epoch", "total_loss", "loss_diff", "grad_norm", "ts"}
STEP_OPTIONAL = {"loss_fd", "w_t", "examples_per_s"}
EPOCH_KEYS = {"kind", "epoch", "train_loss", "val_loss", "val_cer", "test_cer", "best_val_cer",
              "best_epoch", "epoch_seconds", "ts"}
EPOCH_OPTIONAL = {"val_kl", "train_cer", "early_stopped"}
META_KEYS = {"epoch", "ema_eval", "has_ema", "train_encoder"}
PT_KEYS = {"decoder", "epoch", "step", "config", "s_proj", "t_embed", "t_proj"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Train (8), validation (4) and test (4) manifests of 0.1-0.3 s clips,
    and the toy tokenizer."""
    from scripts.make_synth_data import main as make

    root = tmp_path_factory.mktemp("loop")
    make(["--out", str(root / "toy"), "--n", "1", "--seconds", "0.05"])
    rng = np.random.default_rng(0)
    manifests = {}
    for split, n in (("train", 8), ("validation", 4), ("test", 4)):
        records = []
        for i in range(n):
            path = str(root / f"{split}{i}.wav")
            t = np.arange(int(16000 * rng.uniform(0.1, 0.3))) / 16000
            wav = 0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t) + 0.05 * rng.standard_normal(t.size)
            save_wav(path, wav.astype(np.float32), 16000)
            records.append({"processed_path": path, "text": SENTENCES[(i + n) % 8]})
        manifests[split] = str(root / f"{split}.json")
        with open(manifests[split], "w", encoding="utf-8") as f:
            json.dump(records, f, ensure_ascii=False)
    return root, manifests, str(root / "toy/data/tokenizer/toy/spm_toy.model")


def _config(corpus, name, **overrides):
    """The tiny config as a dict, `overrides` merged in ({"optim": {...}})."""
    root, manifests, tok = corpus
    cfg = {
        "seed": 7,
        "data": {"sample_rate": 16000, "max_seconds": 0.3, "pad_id": 0, "max_len": 12,
                 "train_json": manifests["train"], "val_json": manifests["validation"],
                 "test_json": manifests["test"], "tokenizer_path": tok, "vocab_size": 96},
        "model": {"d_model": 32, "nhead": 4, "num_layers": 1, "dim_ff": 64, "dropout": 0.1,
                  "dtype": "float32",
                  "encoder": {"wavlm_name": "tiny", "freeze": True, "proj": "linear",
                              "pooling": "none", "wavlm_config": {"num_hidden_layers": 1}},
                  "projector": {"d_proj": 16}},
        "diffusion": {"T": 50, "beta_max": 0.2},
        "inference": {"T_infer": 4, "r": 2},
        "optim": {"batch_size": 4, "lr": 1e-3, "weight_decay": 0.01, "num_epochs": 1,
                  "warmup_steps": 0, "dtype": "float32", "ema_decay": 0.9},
        "lfd": {"lambda_offdiag": 5e-3, "n_step_fd": 2, "tau": 1.0},
        "log": {"log_every": 1, "ckpt_dir": str(root / name), "metrics_jsonl": True,
                "val_kl": "sampled"},
    }
    for key, value in overrides.items():
        cfg[key] = {**cfg.get(key, {}), **value} if isinstance(value, dict) else value
    return cfg


def _write(corpus, cfg, name):
    path = str(corpus[0] / f"{name}.yaml")
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    return path


def _train(corpus, name, *flags, **overrides):
    cfg = _config(corpus, name, **overrides)
    summary = train_cli.main(["--config", _write(corpus, cfg, name), "--device", "cpu", *flags])
    return cfg, summary, cfg["log"]["ckpt_dir"]


def _records(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _state(ckpt_dir, prefix):
    return torch.load(os.path.join(ckpt_dir, f"{prefix}.state.pt"), weights_only=True)


def _port_state(cfg):
    """A fresh port TrainState of `cfg` (for parameter names and restores)."""
    c = Config(cfg)
    pipe = FDDMPipeline.from_config(c, device="cpu", seed=c.seed)
    return pipe, TL.init_train_state(pipe, c)


@pytest.fixture(scope="module")
def frozen(corpus):
    """One epoch of 2 steps on the feature cache, evaluated with the EMA."""
    cfg, summary, d = _train(corpus, "frozen", data={"cache_features": str(corpus[0] / "feats")},
                             log={"train_cer_batches": 1})
    return cfg, summary, d


def test_frozen_run_writes_the_jax_loops_files_and_keys(frozen):
    cfg, summary, d = frozen
    names = set(os.listdir(d))
    for prefix in ("ep001", "best_model"):
        assert {f"{prefix}.pt", f"{prefix}.state.pt", f"{prefix}.meta.json"} <= names
        assert f"{prefix}.encoder.pt" not in names  # the encoder is frozen
    assert ".run.lock" not in names  # released
    records = _records(d)
    kinds = [r["kind"] for r in records]
    assert kinds[:1] == ["feature_cache"] and kinds.count("step") == 2
    assert kinds.count("epoch") == 1 and kinds.count("checkpoint") == 2
    for r in records:
        if r["kind"] == "step":
            assert STEP_KEYS <= set(r) <= STEP_KEYS | STEP_OPTIONAL
            assert ("loss_fd" in r) == (r["step"] % 2 == 0)  # n_step_fd 2
        elif r["kind"] == "epoch":
            assert set(r) == EPOCH_KEYS | {"val_kl", "train_cer"}
            assert r["epoch"] == 1 and r["best_epoch"] == 1
    cache = records[0]
    assert cache["built"] and cache["device_resident"] and cache["shape"][0] == 8
    with open(os.path.join(d, "ep001.meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert set(meta) == META_KEYS | {"best_val_cer"}
    assert meta["ema_eval"] and meta["has_ema"] and not meta["train_encoder"]
    pt = torch.load(os.path.join(d, "ep001.pt"), weights_only=False)
    assert set(pt) == PT_KEYS | {"best_val_cer"} and pt["epoch"] == 1 and pt["step"] == 2
    assert summary["epoch"] == 1 and summary["best_val_cer"] == pt["best_val_cer"]
    assert np.isfinite(summary["train_loss"]) and summary["train_cer"] is not None


def test_the_pt_holds_the_ema_and_jax_reads_it(frozen):
    cfg, _, d = frozen
    _, state = _port_state(cfg)
    blob = _state(d, "ep001")
    ema = {name: e for name, e in zip(state.param_names(), blob["ema"])}
    pt = load_reference_checkpoint(os.path.join(d, "ep001.pt"))
    raw_differs = False
    for key in ("decoder", "s_proj", "t_embed", "t_proj"):
        for n, v in pt[key].items():
            if (key, n) in ema:
                assert torch.equal(v, ema[(key, n)]), (key, n)
                raw_differs |= not torch.equal(v, blob["modules"][key][n])
            else:  # a buffer: RoPE's inv_freq
                assert torch.equal(v, blob["modules"][key][n])
    assert raw_differs  # the EMA trails the trained weights
    jax_pt = jax_load_pt(os.path.join(d, "ep001.pt"))
    back = decoder_state_dict_from_params(jax_pt["decoder"])
    assert set(back) == set(pt["decoder"])
    for n, v in back.items():
        np.testing.assert_array_equal(v, pt["decoder"][n].numpy(), err_msg=n)
    assert jax_pt["epoch"] == 1 and jax_pt["s_proj"] is not None


def test_jax_sampler_on_the_pt_gives_the_ports_ids(frozen):
    """The decoder crosses to JAX through the `.pt`; both sample from the
    port encoder's condition at one padded shape with an injected x_T."""
    cfg, _, d = frozen
    pt = os.path.join(d, "best_model.pt")
    tp = FDDMPipeline.from_config(Config(cfg), ckpt_path=pt, device="cpu", seed=cfg["seed"])
    jcfg = JaxConfig(cfg)
    jp = JaxPipeline(jcfg, {"params": jax_load_pt(pt)["decoder"]}, {},
                     JD.make_schedule(96, 50, 0.2), jax_load_tokenizer(cfg["data"]["tokenizer_path"]),
                     tp.special_ids, jax_build_wavlm_config(jcfg.model.encoder))
    rng = np.random.default_rng(3)
    wav = (0.3 * rng.standard_normal((3, 4800))).astype(np.float32)
    seq = 12
    x_init = rng.integers(0, 96, (3, seq))
    c, _ = tp.encode_waveform(wav)
    ids, _ = tp.sample(c, seq, x_init=torch.as_tensor(x_init), T_infer=20, r=5, greedy=True,
                       posterior_mode="map")
    scfg = JS.SamplerConfig(K=96, T_train=50, T_infer=20, r=5, greedy=True, posterior_mode="map")

    def decoder_apply(params, xt, t, cond, cm):
        return jp.decoder.apply(params, xt, t, cond, None, cm, deterministic=True)

    j_ids, _ = JS.make_sample_fn(decoder_apply, jp.sched, scfg)(
        jp.decoder_params, jax.random.key(0), jnp.asarray(c.numpy()), seq, None,
        jnp.asarray(x_init))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    assert [tp.ids_to_text(r) for r in ids.numpy()] == [jp.ids_to_text(r) for r in np.asarray(j_ids)]
    assert len(set(map(tuple, ids.numpy().tolist()))) > 1


def _tensors(state):
    opt = state.optimizer
    return ([p.detach() for p in opt.params] + opt.mu + opt.nu
            + ([] if state.ema is None else state.ema))


@pytest.mark.parametrize("saved_ema,run_ema", [(0.9, 0.9), (0.9, 0.0), (0.0, 0.9)],
                         ids=["ema", "ema-on-to-off", "ema-off-to-on"])
def test_restore_is_bitwise_with_the_ema_migration(corpus, tmp_path, saved_ema, run_ema):
    cfg = _config(corpus, "restore", optim={"ema_decay": saved_ema})
    pipe, state = _port_state(cfg)
    step = TL.make_train_step(pipe, Config(cfg))
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        step(state, rng.standard_normal((2, 3200)).astype(np.float32),
             rng.integers(4, 40, (2, 12)), generator=gen)
    prefix = str(tmp_path / "ep003")
    files = C.save_ckpt(prefix, state, 3, None, 0.5, export_pt=True, ema_export=True)
    assert set(files) == {"ep003.state.pt", "ep003.pt"}
    assert all(f["bytes"] > 0 for f in files.values())

    cfg2 = _config(corpus, "restore", optim={"ema_decay": run_ema})
    _, fresh = _port_state(cfg2)
    epoch, best = C.restore_state(fresh, C.load_state(prefix + ".state.pt"))
    assert (epoch, best, fresh.step) == (3, 0.5, 3)
    assert fresh.optimizer.count == state.optimizer.count == 3
    opt, ref = fresh.optimizer, state.optimizer
    for a, b in zip([p.detach() for p in opt.params] + opt.mu + opt.nu,
                    [p.detach() for p in ref.params] + ref.mu + ref.nu):
        assert torch.equal(a, b)
    if run_ema and saved_ema:
        assert all(torch.equal(a, b) for a, b in zip(fresh.ema, state.ema))
    elif run_ema:  # seeded from the restored weights
        assert all(torch.equal(a, p.detach()) for a, p in zip(fresh.ema, opt.params))
    else:
        assert fresh.ema is None
    assert _tensors(fresh)  # the comparison ran over the state


def test_resume_starts_at_epoch_two_with_the_best_cer(frozen, corpus):
    cfg, summary, d = frozen
    cfg2 = copy.deepcopy(cfg)
    cfg2["optim"]["num_epochs"] = 2
    before = len(_records(d))
    s2 = train_cli.main(["--config", _write(corpus, cfg2, "frozen_resume"), "--device", "cpu",
                         "--resume", os.path.join(d, "ep001.state.pt")])
    records = _records(d)[before:]
    steps = [r["step"] for r in records if r["kind"] == "step"]
    assert steps == [3, 4] and {r["epoch"] for r in records if r["kind"] == "step"} == {2}
    assert not any(r["kind"] == "feature_cache" and r["built"] for r in records)
    assert s2["epoch"] == 2 and s2["best_val_cer"] <= summary["best_val_cer"]
    assert _state(d, "ep002")["step"] == 4


def test_early_stop_ckpt_every_and_a_constant_model(corpus):
    """lr 0: the weights and so val CER stay put, and patience 1 stops the
    run at epoch 2, which is saved though ckpt_every is 5."""
    _, summary, d = _train(corpus, "early", optim={"lr": 0.0, "num_epochs": 4,
                                                   "early_stop_patience": 1},
                           log={"ckpt_every": 5})
    names = os.listdir(d)
    assert summary["epoch"] == 2 and summary["early_stopped"] is True
    assert "ep002.state.pt" in names and "ep001.state.pt" not in names
    assert "ep003.state.pt" not in names and summary["best_epoch"] == 1


def test_eval_every_ckpt_every_tau_zero_and_raw_weights_in_the_pt(corpus):
    _, summary, d = _train(corpus, "cadence", "--eval-every", "2",
                           optim={"num_epochs": 3, "ema_eval": False}, lfd={"tau": 0.0},
                           log={"ckpt_every": 2})
    epochs = [r for r in _records(d) if r["kind"] == "epoch"]
    assert [r["val_cer"] is not None for r in epochs] == [False, True, True]
    assert not any("loss_fd" in r for r in _records(d) if r["kind"] == "step")
    assert sorted(n for n in os.listdir(d) if n.endswith(".state.pt")) == [
        "best_model.state.pt", "ep002.state.pt", "ep003.state.pt"]
    pt = load_reference_checkpoint(os.path.join(d, "ep003.pt"))
    blob = _state(d, "ep003")
    assert all(torch.equal(v, blob["modules"]["decoder"][n]) for n, v in pt["decoder"].items())
    assert not json.load(open(os.path.join(d, "ep003.meta.json")))["ema_eval"]


def test_collapse_restore_puts_back_the_best_epoch(corpus):
    """factor 0, margin 0: any later epoch's loss counts as a collapse, so
    epoch 2 ends on epoch 1's state, bit for bit."""
    _, _, d = _train(corpus, "collapse", optim={"num_epochs": 2,
                                                "collapse_restore": {"factor": 0.0,
                                                                     "margin": 0.0}},
                     data={"cache_features": str(corpus[0] / "feats_collapse")})
    restores = [r for r in _records(d) if r["kind"] == "collapse_restore"]
    assert len(restores) == 1 and restores[0]["epoch"] == 2
    one, two = _state(d, "ep001"), _state(d, "ep002")
    assert two["step"] == one["step"] == 2
    for key in ("decoder", "s_proj", "t_embed", "t_proj"):
        for n, v in one["modules"][key].items():
            assert torch.equal(v, two["modules"][key][n]), (key, n)
    for a, b in zip(one["ema"] + one["optimizer"]["groups"][0]["mu"],
                    two["ema"] + two["optimizer"]["groups"][0]["mu"]):
        assert torch.equal(a, b)


def test_run_lock_refuses_a_live_owner_and_takes_over_a_dead_one(corpus, tmp_path):
    cfg = _config(corpus, "locked")
    os.makedirs(cfg["log"]["ckpt_dir"])
    lock = os.path.join(cfg["log"]["ckpt_dir"], ".run.lock")
    owner = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        with open(lock, "w") as f:
            json.dump({"pid": owner.pid, "log_file": "x.log", "started": "then"}, f)
        with pytest.raises(RuntimeError, match=f"LIVE training run: pid {owner.pid}"):
            TL.run_training(Config(cfg), device="cpu")
    finally:
        owner.kill()
        owner.wait(timeout=30)
    assert os.path.exists(lock)  # not the refused run's to remove
    taken = TL.RunLock(cfg["log"]["ckpt_dir"])
    taken.acquire()  # the owner is dead now: a stale lock, taken over
    assert json.load(open(lock))["pid"] == os.getpid()
    taken.release()
    assert not os.path.exists(lock)


def test_init_ckpt_warm_starts_the_decoder(frozen, corpus):
    _, _, d = frozen
    init = os.path.join(d, "ep001.pt")
    flags = dict(optim={"lr": 0.0}, data={"val_json": "/nonexistent", "test_json": "/nonexistent"})
    _, _, warm = _train(corpus, "warm", model={**_config(corpus, "x")["model"], "init_ckpt": init},
                        **flags)
    _, _, cold = _train(corpus, "cold", **flags)
    want = load_reference_checkpoint(init)["decoder"]
    got = load_reference_checkpoint(os.path.join(warm, "ep001.pt"))["decoder"]
    other = load_reference_checkpoint(os.path.join(cold, "ep001.pt"))["decoder"]
    assert all(torch.equal(got[n], v) for n, v in want.items())
    assert not all(torch.equal(other[n], v) for n, v in want.items())


def test_condition_mask_changes_the_cache_and_the_loss(corpus):
    common = dict(optim={"lr": 0.0}, data={"val_json": "/nonexistent",
                                           "test_json": "/nonexistent"})
    losses = {}
    for masked in (False, True):
        name = f"mask{int(masked)}"
        model = _config(corpus, "x")["model"]
        model["encoder"] = {**model["encoder"], "condition_mask": masked}
        _, _, d = _train(corpus, name, model=model,
                         data={**common["data"], "cache_features": str(corpus[0] / name)},
                         optim=common["optim"])
        losses[masked] = [r["loss_diff"] for r in _records(d) if r["kind"] == "step"]
        with open(corpus[0] / name / "train" / "meta.json") as f:
            assert f.read().count('"masked": true') == int(masked)
    assert losses[False] != losses[True]


def test_profile_dir_and_debug_nans(frozen, corpus, tmp_path):
    """--profile-dir writes a Chrome trace; --debug-nans restores the
    anomaly mode, and with a NaN in the decoder raises at the first step,
    where a run without it carries on with a NaN loss."""
    _, _, d = frozen
    prof = str(tmp_path / "prof")
    _train(corpus, "profiled", "--profile-dir", prof, "--debug-nans",
           data={"val_json": "/nonexistent", "test_json": "/nonexistent"})
    trace = [n for n in os.listdir(prof) if n.endswith(".json")]
    assert trace and "host_to_device" in open(os.path.join(prof, trace[0])).read()
    assert not torch.is_anomaly_enabled()
    bad = load_reference_checkpoint(os.path.join(d, "ep001.pt"))
    raw = torch.load(os.path.join(d, "ep001.pt"), weights_only=False)
    raw["decoder"]["head.bias"][:] = float("nan")
    nan_pt = str(tmp_path / "nan.pt")
    torch.save(raw, nan_pt)
    assert bad["decoder"] is not None
    model = {**_config(corpus, "x")["model"], "init_ckpt": nan_pt}
    flags = dict(model=model, data={"val_json": "/nonexistent", "test_json": "/nonexistent"})
    with pytest.raises((FloatingPointError, RuntimeError), match="(?i)nan"):
        _train(corpus, "nan_guarded", "--debug-nans", **flags)
    assert not torch.is_anomaly_enabled()
    _, summary, _ = _train(corpus, "nan_unguarded", **flags)
    assert np.isnan(summary["train_loss"])


def test_finetune_run_with_resume_and_its_encoder_in_the_cli(corpus, tmp_path):
    ft = dict(model={**_config(corpus, "x")["model"],
                     "encoder": {"wavlm_name": "tiny", "freeze": False, "proj": "linear",
                                 "mask_time_prob": 0.2, "mask_time_length": 2,
                                 "wavlm_config": {"num_hidden_layers": 1,
                                                  "attention_dropout": 0.0}}},
              optim={"batch_size": 8, "encoder_lr": 1e-4},
              data={"val_json": "/nonexistent", "test_json": "/nonexistent"})
    cfg, s1, d = _train(corpus, "finetune", **ft)
    assert np.isfinite(s1["train_loss"])
    names = set(os.listdir(d))
    assert {"ep001.pt", "ep001.state.pt", "ep001.encoder.pt"} <= names
    assert json.load(open(os.path.join(d, "ep001.meta.json")))["train_encoder"]
    with pytest.raises(ValueError, match="frozen encoder"):
        _train(corpus, "finetune_cached", **{**ft, "data": {
            **ft["data"], "cache_features": str(tmp_path / "feats")}})
    cfg2 = copy.deepcopy(cfg)
    cfg2["optim"]["num_epochs"] = 2
    s2 = train_cli.main(["--config", _write(corpus, cfg2, "finetune_resume"), "--device", "cpu",
                         "--resume", os.path.join(d, "ep001.state.pt")])
    assert s2["epoch"] == 2 and np.isfinite(s2["train_loss"])

    # the fine-tuned encoder (its EMA) through the inference CLI's --encoder-ckpt
    from fddm_asr_tpu_torch import inference as cli

    blob = _state(d, "ep001")
    _, state = _port_state(cfg)
    ema = {n: e for (key, n), e in zip(state.param_names(), blob["ema"]) if key == "encoder"}
    args = cli.parse_args(["--wav", "x.wav", "--ckpt", os.path.join(d, "ep001.pt"),
                           "--encoder-ckpt", os.path.join(d, "ep001.encoder.pt"),
                           "--main-config", _write(corpus, cfg, "finetune"),
                           "--diffusion-config", _write(corpus, cfg, "finetune"),
                           "--tokenizer", cfg["data"]["tokenizer_path"], "--device", "cpu"])
    pipe = cli.build_pipeline(args)
    sd = pipe.encoder.state_dict()
    assert ema and all(torch.equal(sd[n], v) for n, v in ema.items())
    frozen_part = blob["modules"]["encoder"]
    assert all(torch.equal(sd[n], v) for n, v in frozen_part.items() if n not in ema)


@pytest.mark.parametrize("flags,overrides,error,match", [
    (["--mesh", "data=2"], {}, ValueError, r"torchrun --nproc_per_node 2"),
    (["--num-processes", "2"], {}, ValueError, "needs its coordinator"),
    (["--resume", "DIR"], {}, NotImplementedError, "export_torch_encoder.py --ckpt"),
    ([], {"model": "lora"}, ValueError, "lora_rank > 0 requires model.encoder.freeze: false"),
    ([], {"log": {"async_checkpoint": True}}, RuntimeError,
     "asynchronous checkpoint write failed"),
], ids=["mesh", "num-processes", "orbax-resume", "lora", "async-checkpoint"])
def test_unported_options_raise(corpus, tmp_path, flags, overrides, error, match):
    """The options this loop refuses: a mesh of more processes than run
    (one process a GPU) and a process group with no coordinator, an orbax
    `--resume`, LoRA on a frozen encoder; and an asynchronous checkpoint
    whose write fails (a directory where `ep001.state.pt` goes) raises from
    the run, not only in its writer thread."""
    if overrides.get("model") == "lora":
        model = _config(corpus, "x")["model"]
        model["encoder"] = {**model["encoder"], "freeze": True, "lora_rank": 2}
        overrides = {"model": model}
    cfg = _config(corpus, f"raises_{tmp_path.name}", **overrides)
    if overrides.get("log", {}).get("async_checkpoint"):
        os.makedirs(os.path.join(cfg["log"]["ckpt_dir"], "ep001.state.pt"))
    flags = [str(tmp_path) if f == "DIR" else f for f in flags]
    with pytest.raises(error, match=match):
        train_cli.main(["--config", _write(corpus, cfg, "raises"), "--device", "cpu", *flags])


def test_cuda_by_default_raises_naming_the_cpu_flag(corpus):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg = _config(corpus, "nogpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--config", _write(corpus, cfg, "nogpu")])


def test_a_directory_ckpt_names_the_ports_training_output(tmp_path):
    with pytest.raises(NotImplementedError) as info:
        load_reference_checkpoint(str(tmp_path))
    msg = str(info.value)
    for words in ("python -m fddm_asr_tpu_torch.train", "{prefix}.pt", "{prefix}.encoder.pt",
                  "--encoder-ckpt", "scripts/export_torch_encoder.py"):
        assert words in msg


def test_step_timer_and_nan_guard_units():
    timer = P.StepTimer(skip=1)
    for _ in range(3):
        timer.tick()
    assert timer.seconds_per_step is not None and timer.host_lead_s() is None
    timer.pause()
    timer.tick()
    assert len(timer._times) == 1  # the pause's gap and the first interval are left out
    with P.nan_guard(True) as guard:
        assert torch.is_anomaly_enabled()
        guard.check(torch.tensor(1.0), 1)
        with pytest.raises(FloatingPointError, match="step 5"):
            guard.check(torch.tensor(float("inf")), 5)
    assert not torch.is_anomaly_enabled()
    with P.nan_guard(False) as guard:
        guard.check(torch.tensor(float("nan")), 1)  # off: no check


def test_a_learned_position_decoder_keeps_its_table(corpus, tmp_path):
    """The JAX writer drops a learned decoder's `pos_emb.weight`; the port's
    `.pt` keeps it, and both packages' loaders read it back."""
    model = {**_config(corpus, "x")["model"], "pos_emb_type": "learned"}
    cfg = _config(corpus, "learned", model=model)
    _, state = _port_state(cfg)
    prefix = str(tmp_path / "ep001")
    C.save_ckpt(prefix, state, 1, None, None, export_pt=True)
    table = state.decoder.pos_emb.weight.detach()
    sd = load_reference_checkpoint(prefix + ".pt")["decoder"]
    assert torch.equal(sd["pos_emb.weight"], table) and "pos_emb.inv_freq" not in sd
    tp = FDDMPipeline.from_config(Config(cfg), ckpt_path=prefix + ".pt", device="cpu")
    assert torch.equal(tp.decoder.pos_emb.weight, table)
    jax_tree = decoder_params_from_state_dict(sd, pos_emb_type="learned")
    np.testing.assert_array_equal(jax_tree["pos_emb"]["embedding"], table.numpy())
