"""Fixtures of the benchmark's own tests (`python -m pytest benchmark/tests`).

A tiny copy of the benchmark: the benchmark's files copied to a temporary
directory, with a configuration, a traffic mix and limits of its own added
as new files and a manifest naming them, so a test runs a whole cell on the
CPU in seconds.  Tests marked `cuda` need the card and skip without one;
they decide inside the test, never at import."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_WAVLM = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, conv_dim=[16] * 7, num_buckets=32,
                  max_bucket_distance=80, num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=4)
TINY_DECODER = dict(vocab_size=64, d_model=24, nhead=4, num_layers=2, dim_ff=48)
# float32 on the CPU: the port and the reference agree to rounding
TINY_LIMITS = {
    "transcribe": {"frontend_rel_err": 1e-4, "posconv_rel_err": 1e-4, "norm_rel_err": 1e-4,
                   "attention_rel_err": 1e-4, "ffn_rel_err": 1e-4,
                   "encoder_proj_rel_err": 1e-4, "embed_rel_err": 1e-4,
                   "decoder_attention_rel_err": 1e-4, "film_rel_err": 1e-4,
                   "decoder_ffn_rel_err": 1e-4, "head_rel_err": 1e-4,
                   "id_gap_nats": 1e-4},
    "finetune": {"loss_rel_err": 1e-4, "grad_norm_gap": 1e-3, "change_norm_gap": 1e-3,
                 "ema_change_gap": 1e-3}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips here; run on the card)")


def add_tiny_cell(bench_dir: str, manifest: dict, like: str, traffic: str, name: str,
                  overrides: dict = None) -> dict:
    """Add a tiny cell to the benchmark copy at `bench_dir` as new files: a
    configuration after `like`'s at toy widths, float32, a traffic mix
    after `traffic`'s with 3 rows, and limits; and name it in `manifest`."""
    cfg = json.load(open(os.path.join(bench_dir, "configs", like + ".json")))
    cfg.update(name=name, dtype="float32")
    cfg["wavlm"].update(TINY_WAVLM)
    cfg["decoder"].update(TINY_DECODER)
    json.dump(cfg, open(os.path.join(bench_dir, "configs", name + ".json"), "w"))
    tr = json.load(open(os.path.join(bench_dir, "traffic", traffic + ".json")))
    if tr["driver"] == "transcribe":
        tr.update(rows=3, pool_batches=3, trace_calls=2, check_among=2, check_batches=1,
                  check_rows=2, reference_rows=2)
        if tr["clip_seconds"]["kind"] == "fixed":
            tr["clip_seconds"]["seconds"] = 0.5
        else:
            tr["clip_seconds"].update(low=0.1, high=0.4)
            tr["bucket_seconds"] = 0.1
    elif tr["driver"] == "finetune":
        recipe = dict(tr["recipe"])
        recipe["optim"] = dict(recipe["optim"], dtype="float32")
        tr.update(rows=4, clip_seconds=0.5, target_tokens=[4, 8], pool_batches=2,
                  trace_steps=1, reference_rows=2, recipe=recipe)
    tr.update(overrides or {})
    json.dump(tr, open(os.path.join(bench_dir, "traffic", name + ".json"), "w"))
    json.dump({"limits": TINY_LIMITS[tr["driver"]]},
              open(os.path.join(bench_dir, "limits", name + ".json"), "w"))
    manifest["configs"].append({"name": name, "source": "toy widths for tests",
                                "file": f"benchmark/configs/{name}.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": name, "config": name, "traffic": name,
                                  "chips": 1, "why": "a test"})
    for metric in manifest["end_to_end"]:
        if metric["name"] == tr["metric"]:
            metric["workloads"].append(name)
    for metric in manifest["per_layer"]:
        if metric["moves"] == tr["metric"]:
            metric["workloads"].append(name)
    return manifest


@pytest.fixture
def bench_copy(tmp_path):
    """(benchmark directory, manifest) of a copy of the benchmark."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                                "tests"))
    manifest = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    return str(bench), manifest


def add_small_cell(bench_dir: str, manifest: dict, base: str, name: str,
                   overrides: dict) -> dict:
    """Add a cell like `base` (its configuration and limits) with its traffic
    mix changed by `overrides`, as new files, and name it in `manifest`."""
    w = next(c for c in manifest["workloads"] if c["name"] == base)
    tr = json.load(open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")))
    tr.update(overrides)
    json.dump(tr, open(os.path.join(bench_dir, "traffic", name + ".json"), "w"))
    shutil.copy(os.path.join(bench_dir, "limits", base + ".json"),
                os.path.join(bench_dir, "limits", name + ".json"))
    manifest["workloads"].append(dict(w, name=name, traffic=name))
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if base in metric.get("workloads", []):
            metric["workloads"].append(name)
    return manifest
