# -*- coding: utf-8 -*-
"""The port's host tools and profilers (`python -m
fddm_asr_tpu_torch.scripts.<name>`) against the repository's JAX scripts,
on the CPU at tiny sizes:

  every script         --help lists the JAX script's flag names;
  make_longform        the WAV and its .ref.json byte for byte;
  convergence_report   the report byte for byte, also of a log the port's
                       `run_training` wrote;
  sanity_check_scheduler, sanity_forward --tiny --cpu
                       both pass (and the JAX scheduler script); at the JAX
                       script's weights and inputs the logits and L_fd equal
                       JAX's within 1e-4 (float32);
  profile_frontend     each variant (and the per-tap matmul conv) equals the
                       JAX variant's at the same parameters, batch 2 x 0.25 s,
                       within one bf16 ulp;
  profile_finetune, bench_train
                       the Config each builds equals the JAX script's for
                       each flag set (the JAX `FDDMPipeline.from_config`
                       patched to record it and stop), the same argument
                       errors, the JAX line's keys, and FLOPs that count the
                       hand-written kernels' launches at their shapes;
  the paper-scale decoder (configs/fddm_zhTW_253m.yaml)
                       the parameter count of the JAX package's, 240-270 M,
                       and a finite [1, 8, 8000] forward.

The JAX scripts set a persistent compile cache when imported; each import
here puts the previous setting back."""
import importlib
import json
import logging
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu import pipeline as JP
from fddm_asr_tpu_torch.config import load_config
from fddm_asr_tpu_torch.data.audio_io import save_wav
from fddm_asr_tpu_torch.scripts import bench_train as BT
from fddm_asr_tpu_torch.scripts import convergence_report as CR
from fddm_asr_tpu_torch.scripts import make_longform as ML
from fddm_asr_tpu_torch.scripts import profile_finetune as PF
from fddm_asr_tpu_torch.scripts import profile_frontend as PFE
from fddm_asr_tpu_torch.scripts import sanity_check_scheduler as SCS
from fddm_asr_tpu_torch.scripts import sanity_forward as SF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

SCRIPTS = ("profile_step", "profile_finetune", "profile_frontend", "bench_train",
           "bench_serve", "stream_client", "make_longform", "inspect_transcripts",
           "convergence_report", "sanity_check_scheduler", "sanity_forward")


def jax_script(name):
    """The JAX script `scripts/<name>.py` as a module, the JAX compile-cache
    settings it changes on import put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    try:
        return importlib.import_module(name)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)


# ------------------------------------------------------------------ --help
@pytest.mark.parametrize("name", SCRIPTS)
def test_help_lists_the_jax_scripts_flags(name, capsys):
    with open(os.path.join(REPO, "scripts", f"{name}.py"), encoding="utf-8") as f:
        flags = set(re.findall(r"add_argument\(\s*\"(--[\w-]+)\"", f.read()))
    module = importlib.import_module(f"fddm_asr_tpu_torch.scripts.{name}")
    with pytest.raises(SystemExit) as e:
        module.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    shown = set(re.findall(r"--[\w-]+", out))
    assert flags <= shown, sorted(flags - shown)
    if name == "sanity_check_scheduler":  # the JAX script's config path: argv[1]
        assert "[config]" in out


# ------------------------------------------------------------ make_longform
@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Five clips of 0.2-0.6 s (one at 8 kHz, resampled) with texts."""
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(4)
    records = []
    for i, (sec, sr) in enumerate([(0.3, 16000), (0.5, 16000), (0.2, 8000), (0.6, 16000),
                                   (0.4, 16000)]):
        path = d / f"c{i}.wav"
        save_wav(str(path), (0.2 * rng.standard_normal(int(sec * sr))).astype(np.float32), sr)
        records.append({"processed_path": str(path), "text": f"句子{i}"} if i != 3
                       else {"processed_path": str(path), "sentence": "第三"})
    (d / "m.json").write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")
    return d / "m.json"


@pytest.mark.parametrize("argv", [["--minutes", "0.04", "--seed", "3"],
                                  ["--minutes", "0.01", "--gap-ms", "120", "--seed", "0"]],
                         ids=["repeats", "short"])
def test_make_longform_writes_the_jax_scripts_files(manifest, tmp_path, argv, capsys):
    jax_cli = jax_script("make_longform")
    lines = {}
    for side, main in (("jax", jax_cli.main), ("port", ML.main)):
        (tmp_path / side).mkdir()
        main(["--manifest", str(manifest), "--out", str(tmp_path / side / "long.wav"), *argv])
        lines[side] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in ("long.wav", "long.wav.ref.json"):
        ours = (tmp_path / "port" / name).read_bytes().replace(b"/port/", b"/X/")
        theirs = (tmp_path / "jax" / name).read_bytes().replace(b"/jax/", b"/X/")
        assert ours == theirs, name
    assert {k: v for k, v in lines["port"].items() if k not in ("wav", "ref_json")} == \
        {k: v for k, v in lines["jax"].items() if k not in ("wav", "ref_json")}
    assert lines["port"]["clips"] >= 1 and lines["port"]["ref_chars"] > 0


# ------------------------------------------------------- convergence_report
LOG = """2026-01-01 00:00:00 INFO [Epoch 1 Summary] train_loss=5.1234 | val_kl=2.5000
2026-01-01 00:01:00 INFO some other line val_cer=0.1
2026-01-01 00:02:00 INFO [Epoch 2 Summary] train_loss=4.0000 | val_cer=0.9500 | train_cer=nan
2026-01-01 00:03:00 INFO [Epoch 3 Summary] val_cer=0.7000 | train_loss=3.5000 | lr=1e-4
2026-01-01 00:04:00 INFO [Epoch 4 Summary] train_loss=3.2000 | val_cer=0.8000
"""


def _reports(tmp_path, log, extra=()):
    jax_cli = jax_script("convergence_report")
    out = {}
    for side, main in (("jax", jax_cli.main), ("port", CR.main)):
        main(["--log", str(log), "--out", str(tmp_path / f"{side}.json"), *extra])
        out[side] = (tmp_path / f"{side}.json").read_bytes()
    return out


def test_convergence_report_equals_the_jax_scripts(tmp_path, capsys):
    (tmp_path / "train.log").write_text(LOG, encoding="utf-8")
    (tmp_path / "cfg.yaml").write_text("optim:\n  lr: 1.0e-4\n", encoding="utf-8")
    out = _reports(tmp_path, tmp_path / "train.log",
                   ["--config", str(tmp_path / "cfg.yaml"), "--note", "tiny 注"])
    assert out["port"] == out["jax"]
    report = json.loads(out["port"])
    assert report["best_val_cer"] == 0.7 and report["best_epoch"] == 3
    assert report["epochs_run"] == 4 and report["recipe_yaml"].startswith("optim")
    assert json.dumps(CR.parse_log(str(tmp_path / "train.log"))) == json.dumps(
        jax_script("convergence_report").parse_log(str(tmp_path / "train.log")))
    (tmp_path / "empty.log").write_text("no summaries\n", encoding="utf-8")
    with pytest.raises(SystemExit, match="no epoch summaries"):
        CR.main(["--log", str(tmp_path / "empty.log"), "--out", str(tmp_path / "e.json")])


def test_convergence_report_reads_a_log_run_training_wrote(tmp_path, monkeypatch, capsys):
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.scripts import make_synth_data as SYNTH

    SYNTH.main(["--out", str(tmp_path / "s"), "--n", "2", "--seconds", "0.4"])
    cfg = load_config(str(tmp_path / "s/config.yaml")).updated(
        {"log": {"ckpt_dir": str(tmp_path / "ck"), "run_lock": False},
         "optim": {"num_epochs": 2}})
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:  # the training CLI's log file, as `python -m fddm_asr_tpu_torch.train` sets it up
        log = TL.setup_logging(str(tmp_path / "logs"))
        TL.run_training(cfg, max_steps_per_epoch=1, export_pt=False, device="cpu",
                        eval_every=1)
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
    out = _reports(tmp_path, log)
    assert out["port"] == out["jax"]
    assert "[Epoch 2 Summary]" in open(log, encoding="utf-8").read()
    report = json.loads(out["port"])
    assert report["epochs_run"] == 2 and len(report["train_loss_curve"]) == 2


# ----------------------------------------------------------- sanity scripts
def test_sanity_check_scheduler_passes_as_the_jax_script(capsys):
    config = os.path.join(REPO, "configs/fddm_zhTW_base.yaml")
    argv = sys.argv
    sys.argv = ["sanity_check_scheduler.py", config]
    try:
        runpy.run_path(os.path.join(REPO, "scripts/sanity_check_scheduler.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    assert capsys.readouterr().out.strip() == "Scheduler sanity check passed."
    SCS.main([config, "--device", "cpu"])
    assert capsys.readouterr().out.strip() == "Scheduler sanity check passed."
    rows = SCS.check(8000, "cpu")
    assert rows["xt"].shape == rows["post"].shape == (SCS.B, SCS.L, 8000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCS.main([config])


@pytest.fixture(scope="module")
def jax_sanity_forward():
    """The JAX script's `--tiny` modules, keys, inputs and forward, built as
    it builds them but with jitted inits (the same draws; its eager ones
    take about 30 s here), and its outputs."""
    from fddm_asr_tpu.losses import align_speech_to_text, lfd_loss
    from fddm_asr_tpu.models.decoder import DenoisingTransformerDecoder
    from fddm_asr_tpu.models.encoder import AcousticEncoder
    from fddm_asr_tpu.models.projection import SpeechProjector, TextEmbedding, TextProjector
    from fddm_asr_tpu.models.wavlm import WavLMConfig

    with open(os.path.join(REPO, "scripts/sanity_forward.py"), encoding="utf-8") as f:
        source = f.read()
    for line in ("B = 2 ", "T_wav = 16000 * 2 ", "L_tok = 64 ", "V = 4000 ", "D = 768 ",
                 "num_layers=4, dim_ff=2048", "lambda_offdiag=1.0",
                 "r1, r2, r3, r4, r5, r6, r7 = jax.random.split(rng, 7)"):
        assert line in source, line
    B, T_wav, L_tok, V, D = 2, 32000, 64, 4000, 768
    r1, r2, r3, r4, r5, r6, r7 = jax.random.split(jax.random.key(0), 7)
    g = {"wave": jax.random.normal(r1, (B, T_wav)), "xt": jax.random.randint(r2, (B, L_tok), 0, V),
         "t": jax.random.randint(r3, (B,), 1, 200)}
    enc = AcousticEncoder(config=WavLMConfig.tiny_for_tests(), d_model=D)
    dec = DenoisingTransformerDecoder(vocab_size=V, d_model=D, nhead=12, num_layers=4,
                                      dim_ff=2048, dropout=0.1, max_len=L_tok, pad_id=0)
    s_proj, te, t_proj = (SpeechProjector(d_proj=256), TextEmbedding(d_out=256, mode="logits"),
                          TextProjector(d_proj=256))
    g["enc_params"] = jax.jit(enc.init)(r4, g["wave"])
    c0, _, _ = jax.jit(lambda p, w: enc.apply(p, w, None, deterministic=True))(
        g["enc_params"], g["wave"])
    g["dec_params"] = jax.jit(dec.init)(r5, g["xt"], g["t"], c0)
    g["sp"] = jax.jit(s_proj.init)(r6, c0)
    g["tep"] = jax.jit(te.init)(r7, jnp.zeros((B, L_tok, V)))
    g["tpp"] = jax.jit(t_proj.init)(r7, jnp.zeros((B, L_tok, 256)))

    @jax.jit
    def forward(enc_params, dec_params, sp, tep, tpp, wave, xt, t):
        c, c_mask, _ = enc.apply(enc_params, wave, None, deterministic=True)
        logits = dec.apply(dec_params, xt, t, c, None, None, deterministic=True)
        z_text = t_proj.apply(tpp, te.apply(tep, logits))
        z_speech = align_speech_to_text(s_proj.apply(sp, c), L_tok)
        return logits, lfd_loss(z_speech, z_text, lambda_offdiag=1.0)

    g["logits"], g["loss_fd"] = forward(*(g[k] for k in ("enc_params", "dec_params", "sp", "tep",
                                                          "tpp", "wave", "xt", "t")))
    return g


def test_sanity_forward_equals_the_jax_script_at_its_weights(jax_sanity_forward, capsys):
    from fddm_asr_tpu_torch import convert as C

    g = jax_sanity_forward
    logits, loss = SF.main(["--tiny", "--cpu"])
    out = capsys.readouterr().out
    assert "Sanity check passed." in out and f"logits: {(2, 64, 4000)}" in out
    mods = SF.build(True, "cpu")
    p = lambda tree: jax.tree.map(np.asarray, tree["params"])  # noqa: E731
    mods["enc"].load_state_dict(C.acoustic_encoder_state_dict_from_jax_params(
        p(g["enc_params"])))
    mods["dec"].load_state_dict(C.decoder_state_dict_from_jax_params(p(g["dec_params"])))
    mods["s_proj"].load_state_dict(C.projector_state_dict_from_jax_params(p(g["sp"])))
    mods["te"].load_state_dict(C.text_embedding_state_dict_from_jax_params(p(g["tep"])))
    mods["t_proj"].load_state_dict(C.projector_state_dict_from_jax_params(p(g["tpp"])))
    args = [torch.from_numpy(np.array(g[k])) for k in ("wave", "xt", "t")]
    ours, ours_fd = SF.forward(mods, args[0].float(), args[1].long(), args[2].long())
    theirs = np.asarray(g["logits"])
    assert ours.shape == theirs.shape == (SF.B, SF.L_TOK, SF.V)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4, rtol=0)
    assert abs(float(ours_fd) - float(g["loss_fd"])) <= 1e-4 * max(1.0, abs(float(ours_fd)))


def test_sanity_forward_raises_without_a_gpu_unless_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SF.main(["--tiny"])


# --------------------------------------------------------- profile_frontend
@pytest.fixture(scope="module")
def frontend_inputs():
    jax_cli = jax_script("profile_frontend")
    params = jax_cli.make_params(jax.random.key(0))
    wave = np.asarray(jax.random.normal(jax.random.key(1), (2, 4000), jnp.float32) * 0.1)
    ours = [tuple(torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in layer) for layer in params]
    return jax_cli, params, wave, ours


def _within_bf16_ulps(ours: torch.Tensor, theirs, n: int) -> None:
    """|ours - theirs| <= n ulps of bf16 at the largest |theirs|."""
    theirs = torch.from_numpy(np.asarray(jnp.asarray(theirs, jnp.float32)))
    ours = ours.float()
    assert ours.shape == theirs.shape
    ulp = 2.0 ** (torch.floor(torch.log2(theirs.abs().max())) - 7)
    err = (ours - theirs).abs().max()
    assert err <= n * ulp, (err / ulp).item()


def _jax_layer(jax_cli, x, p, s, variant):
    """One layer of the JAX script's `frontend` / `frontend_mm` loop bodies,
    from its own functions."""
    w, b, scale, shift = p
    if variant.startswith("mm_"):
        if x.shape[-1] == 1:  # the first layer stays a conv there
            y = jax.lax.conv_general_dilated(x, w, (s,), "VALID",
                                             dimension_numbers=("NHC", "HIO", "NHC"),
                                             preferred_element_type=jnp.bfloat16) + b
        else:
            y = jax_cli.conv_mm(x, w, b, s)
        y = jax_cli.ln(y, scale, shift, jnp.float32)
        return jax.nn.gelu(y, approximate=variant.endswith("tanh"))
    kw = PFE.VARIANTS[variant]
    y = jax.lax.conv_general_dilated(x, w, (s,), "VALID", dimension_numbers=("NHC", "HIO", "NHC"),
                                     preferred_element_type=jnp.bfloat16) + b
    if kw.get("with_ln", True):
        y = jax_cli.ln(y, scale, shift,
                       jnp.float32 if kw["stats_dtype"] == torch.float32 else jnp.bfloat16)
    if kw.get("with_gelu", True):
        y = jax.nn.gelu(y, approximate=kw["gelu_approx"])
    return y


@pytest.mark.parametrize("variant", list(PFE.VARIANTS) + ["mm_frontend_erf", "mm_frontend_tanh"])
def test_profile_frontend_variant_equals_the_jax_variant(frontend_inputs, variant):
    """Layer by layer from the same input (the JAX layer's output feeds
    both sides' next layer): the two frameworks sum a conv in f32 in
    different orders, and seven layers would compound the last bit.  Within
    one bf16 ulp of the layer's largest value; two with bf16 LayerNorm
    statistics, where torch rounds every step of the normalisation to bf16
    and XLA's CPU fusions keep the steps between the reductions in f32."""
    import functools

    jax_cli, params, wave, ours = frontend_inputs
    x = jnp.asarray(wave)[..., None].astype(jnp.bfloat16)
    for i, (p, s) in enumerate(zip(params, jax_cli.CONV_STRIDE)):
        theirs = jax.jit(functools.partial(_jax_layer, jax_cli, s=s, variant=variant))(x, p)
        mine = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
        if variant.startswith("mm_"):
            got = PFE.layer_mm(mine, ours[i], s, gelu_approx=variant.endswith("tanh"),
                               first=i == 0)
        else:
            got = PFE.layer(mine, ours[i], s, **PFE.VARIANTS[variant])
        assert got.dtype == torch.bfloat16
        _within_bf16_ulps(got, theirs, 2 if variant.startswith("bf16stats") else 1)
        x = theirs
    # the whole stack, as each script runs it
    kw = PFE.VARIANTS.get(variant)
    if kw is None:
        approx = variant.endswith("tanh")
        whole = jax.jit(functools.partial(jax_cli.frontend_mm, gelu_approx=approx))(
            params, jnp.asarray(wave))
        got = PFE.frontend_mm(ours, torch.from_numpy(wave), gelu_approx=approx)
    else:
        jkw = dict(kw, stats_dtype=jnp.float32 if kw["stats_dtype"] == torch.float32
                   else jnp.bfloat16)
        whole = jax.jit(functools.partial(jax_cli.frontend, **jkw))(params, jnp.asarray(wave))
        got = PFE.frontend(ours, torch.from_numpy(wave), **kw)
    assert tuple(got.shape) == tuple(whole.shape) == (2, 12, 512)


def test_conv_mm_equals_the_conv(frontend_inputs):
    _, _, wave, ours = frontend_inputs
    x = PFE._gelu(PFE._conv(torch.from_numpy(wave)[..., None].to(torch.bfloat16),
                            *ours[0][:2], 5), False)
    for (w, b, _, _), s in zip(ours[1:], PFE.CONV_STRIDE[1:]):
        conv, mm = PFE._conv(x, w, b, s), PFE.conv_mm(x, w, b, s)
        # each tap rounds to bf16 before the sum: a few bf16 ulps of the sum's scale
        scale = conv.float().abs().max()
        assert conv.shape == mm.shape
        assert (conv.float() - mm.float()).abs().max() <= 4 * 2.0 ** -8 * scale
        x = conv
    t, out = PFE.time_fn(lambda a: a + 1, torch.zeros(3))
    assert t >= 0 and torch.equal(out, torch.ones(3))


def test_profile_frontend_main_prints_every_variant(capsys):
    times = PFE.main(["--batch", "1", "--seconds", "0.1", "--per-layer", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("dispatch_overhead", "mm_frontend_erf", "mm_frontend_tanh", *PFE.VARIANTS):
        assert name in out and times[name] > 0
    assert out.count("  conv") == 7 and "max|Δ|=0.000e+00" in out


# --------------------------------------------- bench_train, profile_finetune
class _Built(Exception):
    pass


def _jax_config(monkeypatch, main, argv=None, sys_argv=None):
    """The Config the JAX script hands FDDMPipeline.from_config."""
    from fddm_asr_tpu import runtime

    seen = {}

    def record(cls, cfg, *a, **k):
        seen["cfg"] = cfg
        raise _Built

    monkeypatch.setattr(runtime, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(JP.FDDMPipeline, "from_config", classmethod(record))
    if sys_argv is not None:
        monkeypatch.setattr(sys, "argv", sys_argv)
    with pytest.raises(_Built):
        main(argv) if argv is not None else main()
    return seen["cfg"].to_dict()


BENCH_FLAGS = [[], ["--lfd", "--quant", "int8_fused", "--batch", "16", "--max-len", "64"],
               ["--model", "paper", "--lfd"], ["--model", "base", "--decoder-remat"],
               ["--finetune", "--lora", "8", "--ema", "0.999", "--no-dropout",
                "--specaugment", "0.065", "--remat-policy", "dots"], ["--cached", "--ema", "0.5"]]


@pytest.mark.parametrize("argv", BENCH_FLAGS, ids=lambda a: " ".join(a) or "defaults")
def test_bench_train_builds_the_jax_scripts_config(monkeypatch, argv):
    jax_cli = jax_script("bench_train")
    theirs = _jax_config(monkeypatch, jax_cli.main, [*argv, "--device", "cpu"])
    ours = BT.make_config(BT.parse_args([*argv, "--device", "cpu"])).to_dict()
    assert ours == theirs


@pytest.mark.parametrize("argv", [["--finetune", "--cached"], ["--finetune", "--quant", "int8"],
                                  ["--lora", "4"]])
def test_bench_train_refuses_what_the_jax_script_refuses(argv, capsys):
    jax_cli = jax_script("bench_train")
    messages = []
    for parse in (lambda a: jax_cli.main(a), BT.parse_args):
        with pytest.raises(SystemExit) as e:
            parse(argv)
        assert e.value.code == 2
        messages.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[-1])
    assert messages[0] == messages[1]


@pytest.mark.parametrize("argv", [[], ["--no-remat", "--no-dropout", "--remat-policy", "dots",
                                       "--batch", "4", "--max-len", "32"]],
                         ids=["defaults", "flags"])
def test_profile_finetune_builds_the_jax_scripts_config(monkeypatch, argv):
    jax_cli = jax_script("profile_finetune")
    theirs = _jax_config(monkeypatch, jax_cli.main, sys_argv=["profile_finetune.py", *argv])
    assert PF.make_config(PF.parse_args(argv)).to_dict() == theirs


JAX_BENCH_TRAIN_KEYS = ("metric", "value", "unit", "batch", "audio_seconds", "step_seconds",
                        "tflops_per_s", "mfu_pct", "compile_seconds", "lfd",
                        "cached_features", "platform", "finetune", "config")


@pytest.fixture
def tiny_wavlm(monkeypatch):
    """WavLM-large's constructor gives the test config (both packages)."""
    from fddm_asr_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
    from fddm_asr_tpu_torch.models.wavlm import WavLMConfig

    monkeypatch.setattr(WavLMConfig, "large", classmethod(lambda cls: cls.tiny_for_tests()))
    monkeypatch.setattr(JaxWavLMConfig, "large", classmethod(lambda cls: cls.tiny_for_tests()))


def test_bench_train_prints_the_jax_keys_and_counts_flops(tiny_wavlm, capsys):
    with open(os.path.join(REPO, "scripts/bench_train.py"), encoding="utf-8") as f:
        source = f.read()
    assert all(f'"{k}"' in source for k in JAX_BENCH_TRAIN_KEYS)
    result = BT.main(["--device", "cpu", "--batch", "2", "--seconds", "0.3", "--max-len", "8",
                      "--iters", "1", "--lfd"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert set(JAX_BENCH_TRAIN_KEYS) <= set(line)
    assert line["platform"] == "cpu" and line["mfu_pct"] is None and line["lfd"] is True
    assert line["config"] == "frozen wavlm-large + d768x6 decoder, KL, AdamW, bf16"
    # on the CPU no kernel launches: the plain attention's ops are torch's
    assert line["step_flops"]["torch"] > 0 and line["step_flops"]["kernels"] == 0
    flops = line["step_flops"]["torch"] + line["step_flops"]["kernels"]
    assert line["tflops_per_s"] == pytest.approx(flops / line["step_seconds"] / 1e12, abs=0.011)
    assert line["kernel_launches_per_step"] == {}


def test_gated_attention_flops_is_the_closed_form():
    from fddm_asr_tpu_torch.profiling import gated_attention_flops

    B, L, H, dh = 3, 96, 4, 64
    assert gated_attention_flops("fwd", [L] * B, L, H, dh) == 4 * B * H * L * L * dh
    assert gated_attention_flops("fwd_lse", [L] * B, L, H, dh) == 4 * B * H * L * L * dh
    assert gated_attention_flops("bwd_dq", [L] * B, L, H, dh) == 6 * B * H * L * L * dh
    assert gated_attention_flops("bwd_dkv", [L] * B, L, H, dh) == 8 * B * H * L * L * dh
    # kept keys only; an all-masked row: the mean of v (forward), dO's column sum (B5)
    assert gated_attention_flops("fwd", [50, 0], L, H, dh) == 4 * H * L * 50 * dh + L * H * dh
    assert gated_attention_flops("bwd_dq", [50, 0], L, H, dh) == 6 * H * L * 50 * dh
    assert gated_attention_flops("bwd_dkv", [50, 0], L, H, dh) == \
        8 * H * L * 50 * dh + L * H * dh


def test_step_flops_counts_the_kernels_launches_at_their_shapes():
    """A step that launches the kernels (as on the card) gets their FLOPs
    at the step's shape; a dispatch mode sees none of them."""
    import dataclasses

    from fddm_asr_tpu_torch.models.wavlm import WavLMConfig
    from fddm_asr_tpu_torch.ops import kernel_wrappers
    from fddm_asr_tpu_torch.profiling import gated_attention_flops

    wrappers = kernel_wrappers()
    launched = {"fwd_lse": 47, "bwd_dq": 24, "bwd_dkv": 24, "int8_matmul_fused": 144}

    def step():
        for k, n in launched.items():
            wrappers[k].launches += n

    cfg = dataclasses.replace(WavLMConfig.large(), seq_pad_multiple=128)
    counted = BT.step_flops(step, cfg, batch=4, samples=320000)
    frames = cfg.feat_extract_output_length(320000)
    assert frames == 999
    attn = sum(n * gated_attention_flops(k, [999] * 4, 1024, 16, 64)
               for k, n in launched.items() if k != "int8_matmul_fused")
    dense = 144 / 6 * 2.0 * 4 * 1024 * (4 * 1024 * 1024 + 2 * 1024 * 4096)
    assert counted["kernels"] == attn + dense and counted["torch"] == 0
    assert counted["launches"] == launched
    with pytest.raises(RuntimeError, match="no FLOP count"):
        BT.step_flops(lambda: setattr(wrappers["conv_ln_gelu"], "launches", 6), cfg, 4, 320000)


def test_peak_table_is_the_cards(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    assert BT.PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.0}
    assert BT.peak_tflops(torch.device("cpu")) is None
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "123.5")
    assert BT.peak_tflops(torch.device("cpu")) == 123.5


# --------------------------------------------------- the paper-scale decoder
def test_paper_scale_decoder_matches_the_jax_packages():
    from fddm_asr_tpu.config import load_config as jax_load_config
    from fddm_asr_tpu.models.decoder import DenoisingTransformerDecoder as JaxDecoder
    from fddm_asr_tpu_torch.models.decoder import DenoisingTransformerDecoder

    path = os.path.join(REPO, "configs", "fddm_zhTW_253m.yaml")
    cfg = load_config(path)
    m = cfg.model
    assert cfg.data.vocab_size == 8000 and m.d_model == 1024 and m.num_layers == 12
    assert m.scan_blocks
    jm = jax_load_config(path).model
    jdec = JaxDecoder(vocab_size=8000, d_model=jm.d_model, nhead=jm.nhead,
                      num_layers=jm.num_layers, dim_ff=jm.dim_ff, max_len=1024, pad_id=3,
                      scan_blocks=True)
    shapes = jax.eval_shape(jdec.init, jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                            jnp.ones((1,), jnp.int32), jnp.zeros((1, 16, 1024)))
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    torch.manual_seed(0)
    dec = DenoisingTransformerDecoder(cfg.data.vocab_size, d_model=m.d_model, nhead=m.nhead,
                                      num_layers=m.num_layers, dim_ff=m.dim_ff, max_len=1024,
                                      pad_id=3, scan_blocks=True).eval()
    n_port = sum(p.numel() for p in dec.parameters())
    assert n_port == n_jax and 240e6 < n_port < 270e6, (n_port, n_jax)
    with torch.no_grad():
        logits = dec(torch.full((1, 8), 5), torch.ones(1, dtype=torch.long),
                     torch.zeros(1, 16, 1024), None, None)
    assert logits.shape == (1, 8, 8000) and torch.isfinite(logits).all()
