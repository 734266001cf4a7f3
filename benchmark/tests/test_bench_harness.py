"""The harness on the CPU at toy widths: a cell added as new files runs,
the program and the plain reference agree, the comparison catches an
altered token, the work counters match hand counts, and nothing of JAX
is loaded.  `python -m pytest benchmark/tests -q`."""
import ast
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import BENCH, ROOT, add_tiny_cell

import counters
import harness


def run_tiny(bench_copy, like="fddm-wavlm-large-d768x6", traffic="longform-20s-b32",
             name="tiny-cell", trace=True, seed=2**33 + 5, overrides=None, variant=None):
    bench, manifest = bench_copy
    add_tiny_cell(bench, manifest, like, traffic, name, overrides)
    cell = harness.Cell(manifest, name, bench)
    return harness.run_cell(cell, seed, 1.0, trace, "cpu", os.path.dirname(bench),
                            time.perf_counter(), variant=variant)


@pytest.mark.parametrize("like,traffic,compared,host_metrics", [
    ("fddm-wavlm-large-d768x6", "longform-20s-b32",
     {"frontend_rel_err", "attention_rel_err", "ffn_rel_err", "head_rel_err", "id_gap_nats"},
     {"pipeline.host_ms_per_call.long"}),
    ("fddm-wavlm-large-d1024x12", "short-1to4s-b64",
     {"decoder_attention_rel_err", "head_rel_err", "id_gap_nats"},
     {"pipeline.host_ms_per_call.short"}),
    ("fddm-wavlm-large-d768x6", "finetune-20s-b32",
     {"loss_rel_err", "grad_norm_gap", "change_norm_gap", "ema_change_gap"}, set()),
])
def test_cell_added_as_new_files_runs_and_agrees_with_reference(bench_copy, like, traffic,
                                                                compared, host_metrics):
    result, checks = run_tiny(bench_copy, like, traffic)
    assert result["correct"], result["checks"]
    assert {name for name, _, _ in checks} >= compared
    assert result["attempted"] > 0 and result["failed"] == 0
    # a CPU run gives the host spans and no device metric
    assert set(result["metrics"]) == host_metrics
    assert list(result)[-1] == "checks"


def test_untraced_run_reports_the_cells_end_to_end_metrics(bench_copy):
    result, _ = run_tiny(bench_copy, trace=False)
    assert set(result["metrics"]) == {"audio_s_per_s.long", "setup_s"}
    assert result["metrics"]["audio_s_per_s.long"]["value"] > 0


def test_altered_token_fails_the_comparison(bench_copy, monkeypatch):
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline

    real = FDDMPipeline.transcribe_with_ids_async

    def altered(self, *args, **kwargs):
        fin = real(self, *args, **kwargs)

        def finalize():
            rows = fin()
            text, ids = rows[0][:2]
            ids = list(ids)
            ids[5] = (ids[5] + 17) % self.cfg.data.vocab_size
            return [(text, ids)] + rows[1:]
        return finalize

    monkeypatch.setattr(FDDMPipeline, "transcribe_with_ids_async", altered)
    result, compared = run_tiny(bench_copy, trace=False,
                                overrides={"check_among": 1, "check_batches": 1})
    assert not result["correct"]
    gap = dict((n, v) for n, v, _ in compared)["id_gap_nats"]
    assert gap > 1e-2


def _scaled_linear(module, which, factor):
    """`module._linear` with the output of the layers `which(layer)` picks
    scaled by `factor`."""
    real = module._linear

    def linear(layer, *args, **kwargs):
        out = real(layer, *args, **kwargs)
        return out * factor if which(layer) else out
    return linear


@pytest.mark.parametrize("fault,number", [
    ("decoder_ffn", "decoder_ffn_rel_err"), ("film", "film_rel_err"),
    ("time_mlp", "embed_rel_err"), ("encoder_proj", "encoder_proj_rel_err"),
    ("decoder_norm", "norm_rel_err")])
def test_a_wrong_stage_fails_the_comparison(bench_copy, monkeypatch, fault, number):
    """A fault planted in one stage of the timed path, a few per cent off,
    fails the transcribe cell's comparison on that stage's number."""
    from fddm_asr_tpu_torch.models import decoder as D
    from fddm_asr_tpu_torch.models import encoder as E

    if fault == "decoder_ffn":  # the FFN's output projection (d_ff -> d_model)
        monkeypatch.setattr(D, "_linear", _scaled_linear(
            D, lambda m: m.in_features == 48 and m.out_features == 24, 1.05))
    elif fault == "film":  # FiLM without its shift
        monkeypatch.setattr(D.FiLMLayer, "forward", lambda self, x, cond, dtype: x * (
            1.0 + D._linear(self.scale_proj, cond, dtype)[:, None, :]))
    elif fault == "time_mlp":
        real = D.SinusoidalTimeEmbedding.forward
        monkeypatch.setattr(D.SinusoidalTimeEmbedding, "forward",
                            lambda self, t, dtype: real(self, t, dtype) * 1.1)
    elif fault == "encoder_proj":
        monkeypatch.setattr(E, "_linear", _scaled_linear(E, lambda m: True, 1.05))
    else:  # a decoder block's norms off by a few per cent
        real_ln = D._layer_norm
        monkeypatch.setattr(D, "_layer_norm", lambda ln, x, dtype: real_ln(ln, x, dtype) * 1.05)
    result, compared = run_tiny(bench_copy, trace=False,
                                overrides={"check_among": 1, "check_batches": 1})
    assert not result["correct"]
    check = result["checks"][number]
    assert check["value"] > 10 * check["limit"], result["checks"]


def test_seed_gives_the_same_inputs_and_every_seed_the_same_sizes():
    transcribe = harness.load_module(os.path.join(BENCH, "drivers", "transcribe.py"),
                                     "bench_driver_transcribe")
    tr = json.load(open(os.path.join(BENCH, "traffic", "short-1to4s-b64.json")))
    a, b, c = (transcribe.plan_lengths(tr, s) for s in (7, 7, 2**40 + 3))
    assert a == b and a != c
    assert sorted(map(sorted, a)) == sorted(map(sorted, c))
    assert all(16000 < n <= 64000 for batch in a for n in batch)
    assert all(len(batch) == tr["rows"] for batch in a)


def test_counters_match_hand_counts():
    # B1 forward on 1 row, L = 8 frames of which 6 real, 2 heads, head dim 64, bf16
    w = counters.gated_attention("fwd", rows=1, L=8, kept=6, heads=2, elem_bytes=2)
    assert w["ops"] == 2 * 2 * 1 * 2 * 6 * 6 * 64
    act = 1 * 8 * 2 * 64 * 2
    assert w["bytes"] == 3 * act + 2 * 8 * 8 * 2 + 1 * 2 * 8 * 4 + 8 + act
    # a decoder call: one layer, one row, d = 4, L = 2 tokens, S = 3 frames, ff 8, K 5
    f = counters.decoder_flops(L=2, S=3, d=4, layers=1, dim_ff=8, vocab=5)
    time_mlp = 2 * 4 * 16 * 2 + 2 * 4 * 4
    block = (8 * 16 * 2 + 4 * 4 * 4) + (4 * 16 * 2 + 4 * 16 * 3 + 4 * 2 * 3 * 4) \
        + 4 * 16 + 4 * 4 * 8 * 2
    assert f == time_mlp + block + 2 * 4 * 5 * 2
    # WavLM-large on 20 s: about 41 GFLOP a second of audio (the conv
    # front-end about 4.9, the 24 layers about 35)
    large = json.load(open(os.path.join(BENCH, "configs", "fddm-wavlm-large-d768x6.json")))
    per_s = counters.encoder_flops(320000, large["wavlm"], 768) / 20
    assert 38e9 < per_s < 44e9
    t, bound = counters.bound_seconds(989e12, 1.0, 989e12, 3.35e12)
    assert (t, bound) == (1.0, "ops")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "reference", "*.py"))))
def test_reference_imports_nothing_of_the_program_or_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"fddm_asr_tpu_torch", "fddm_asr_tpu", "jax", "jaxlib", "flax"}, tops


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a process of its own, then its modules' top-level
    names compared whole with JAX's and the JAX package's."""
    script = f"""
import json, os, shutil, sys, time
sys.path[:0] = [{BENCH!r}, {ROOT!r}, {os.path.join(BENCH, 'tests')!r}]
from conftest import add_tiny_cell
import harness
bench = {str(tmp_path / 'benchmark')!r}
shutil.copytree({BENCH!r}, bench, ignore=shutil.ignore_patterns('.cache', '__pycache__', 'tests'))
manifest = add_tiny_cell(bench, json.load(open({os.path.join(ROOT, 'BENCHMARK.json')!r})),
                         'fddm-wavlm-large-d768x6', 'longform-20s-b32', 'tiny-cell')
result, _ = harness.run_cell(harness.Cell(manifest, 'tiny-cell', bench), 3, 0.5, False, 'cpu',
                             {str(tmp_path)!r}, time.perf_counter())
print(json.dumps({{"correct": result["correct"], "forbidden": harness.forbidden_modules()}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == {"correct": True, "forbidden": []}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fddm_asr_tpu_torch_lookalike", sys)
    assert "fddm_asr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fddm_asr_tpu.models", sys)
    assert "fddm_asr_tpu" in harness.forbidden_modules()


def test_the_command_refuses_without_a_card():
    """Without CUDA the command exits with another code than 0 and prints
    no result."""
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "d768-transcribe-20s", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_training_faults_fail_the_comparison(bench_copy, monkeypatch):
    """A step that leaves the state unchanged, and one that leaves out half
    the batch, each fail the fine-tune cell's comparison."""
    from fddm_asr_tpu_torch import train_lib

    result, _ = run_tiny(bench_copy, traffic="finetune-20s-b32", trace=False, variant="half_batch")
    assert not result["correct"]
    assert result["checks"]["loss_rel_err"]["value"] > 1e-2
    monkeypatch.setattr(train_lib.AdamW, "_update", lambda self, grads, norm: False)
    monkeypatch.setattr(train_lib, "update_ema", lambda *args, **kwargs: None)
    result, _ = run_tiny(bench_copy, name="tiny-unchanged", traffic="finetune-20s-b32",
                         trace=False)
    assert not result["correct"]
    assert result["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_an_encoder_left_unchanged_fails_the_comparison(bench_copy, monkeypatch):
    """A step that computes the encoder's gradient but leaves the encoder
    where it was (its learning rate nought) fails the fine-tune comparison:
    the followed steps start past the warm-up, so the reference moves it."""
    from fddm_asr_tpu_torch import train_lib

    real = train_lib.lr_schedule

    def schedule(optim, lr, warmup):
        if lr == optim.get("encoder_lr"):
            return lambda count: 0.0
        return real(optim, lr, warmup)

    monkeypatch.setattr(train_lib, "lr_schedule", schedule)
    result, _ = run_tiny(bench_copy, name="tiny-frozen", traffic="finetune-20s-b32",
                         trace=False)
    assert not result["correct"]
    assert result["notes"]["leaves"]["encoder_moving"] > 0
    assert result["checks"]["change_norm_gap"]["value"] > 0.5
    # the reading a sound run notes for this fault is the one it gives
    assert result["checks"]["change_norm_gap"]["value"] == pytest.approx(
        result["notes"]["encoder_unchanged_reads"], rel=1e-2)
