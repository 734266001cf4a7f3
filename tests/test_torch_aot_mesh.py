# -*- coding: utf-8 -*-
"""Sharded AOT artifacts of the port (`export_model --mesh`,
`aot.ExportedPipeline` over a mesh, `serve --exported` under torchrun)
against one process's artifact and the JAX pipeline over the same mesh.

Mirrors tests/test_aot_export.py:281-394 (its multichip cases) at the tiny
config of tests/test_torch_aot.py.  The ranks are gloo processes on the CPU
(`tests/torch_parallel_worker.py`), and each mesh is exported once for the
module:

* model=2 (tensor parallel) and model=2 `--seq-parallel` (the ring),
  exported by the CLI in two ranks and loaded in those ranks (case
  `aot_m2`), where a mesh made after the load leaves the artifact on its
  own; data=2 x model=2 exported by the CLI in four ranks (`aot_d2m2`),
  loaded in four fresh ranks that import no model code and then served
  there by the entry point, rank 0 dispatching to the others
  (`aot_fresh`), all three sets started together;
* ids and conf equal to the one-process artifact's at the same seeds, and
  to the JAX pipeline over the same mesh at the artifact's x_T (ids exact,
  conf within 1e-5);
* meta's mesh in the JAX form, programs that hold no weights, the
  collectives and the ring's hop as `torch.ops.fddm` nodes keyed by mesh
  axis, params.npz the one-process artifact's tensors;
* the "divisible" error, the world-size error, `--mesh` beside `--exported`;
* `serve.main --exported` on the fresh data=2 x model=2 ranks: served ids equal to
  one process's artifact at the engine's padded batches and counter, the
  engine's buckets aligned to the data axis, `/healthz` naming the mesh.
  (Two `torchrun` ranks of `python -m fddm_asr_tpu_torch.serve --exported`
  on a card are `chip_smoke.py` phase 21 (e3).)
"""
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from fddm_asr_tpu.parallel import MeshSpec as JaxMeshSpec
from fddm_asr_tpu.parallel import make_mesh as jax_make_mesh
from fddm_asr_tpu_torch import aot
from fddm_asr_tpu_torch import parallel as P
from fddm_asr_tpu_torch import serve as S
from fddm_asr_tpu_torch.export_model import main as export_main
from test_torch_aot import (CFG, N, SAMPLING, SEQ_LEN, _jax_rows, _wave, _x_T,  # noqa: F401
                            pair)
from torch_parallel_worker import collect, launch

GRID = [[2, N], [4, N]]
# (rows, samples, lengths, seed): a full 4-row bucket, 3 rows padded into it
# (data rank 1 holds row 2 and a pad row), one short row in the 2-row bucket
CALLS = [(4, N, [N, 5000, 6000, 7000], 7), (3, N, [N, 4000, 7500], 3), (1, 7000, [7000], 5)]
UPLOADS = (0.3, 0.45)  # seconds, each served as a batch of its own
JAX_MESH = {"axis_names": ["data", "model"], "shape": [2, 2]}


def _export_cli(pair, d) -> list:
    """The export CLI's arguments for the module's model, weights the pair's."""
    _, tp, _, ckpt, vocab = pair
    cfg = d / "config.yaml"
    cfg.write_text(json.dumps(CFG))  # JSON is YAML
    enc = str(d / "encoder.pt")
    torch.save(tp.encoder.state_dict(), enc)
    return ["--ckpt", ckpt, "--encoder-ckpt", enc, "--main-config", str(cfg),
            "--diffusion-config", str(cfg), "--tokenizer", vocab, "--batch-sizes", "2,4",
            "--seconds", "0.5", "--seq-len", str(SEQ_LEN), "--T-infer", "4", "--r", "4",
            "--greedy", "--posterior-mode", "map", "--condition-mask", "on", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(pair, tmp_path_factory):
    """Every rank's results, the one-process artifact and the directory."""
    d = tmp_path_factory.mktemp("aot_mesh")
    cli = _export_cli(pair, d)
    calls = []
    for i, (rows, samples, lengths, seed) in enumerate(CALLS):
        path = str(d / f"call{i}.npy")
        np.save(path, _wave(rows, samples, seed=20 + i))
        calls.append([path, lengths, seed])
    uploads = []
    for i, seconds in enumerate(UPLOADS):
        path = str(d / f"upload{i}.npy")
        np.save(path, _wave(1, int(seconds * 16000), seed=30 + i)[0])
        uploads.append(path)
    with open(d / "aot_mesh.json", "w") as f:
        json.dump({"cli": cli, "calls": calls, "uploads": uploads}, f)
    # the fresh ranks wait for the data=2 x model=2 ranks' artifact
    started = {case: launch(case, str(d), world)
               for case, world in (("aot_m2", 2), ("aot_d2m2", 4), ("aot_fresh", 4))}
    one = str(d / "art_one")
    export_main([*cli, "--out", one])
    out = {case: collect(procs, case, str(d)) for case, procs in started.items()}
    out.update(dir=d, one=aot.ExportedPipeline.load(one, device="cpu"), calls=calls,
               uploads=uploads, cli=cli, programs={})
    return out


def _program(runs, art: str, name: str):
    """A program file of an artifact, loaded once for the module."""
    key = (art, name)
    if key not in runs["programs"]:
        runs["programs"][key] = torch.export.load(str(runs["dir"] / art / name))
    return runs["programs"][key]


def _one_rows(runs):
    """The one-process artifact's (ids, conf) at every call, computed once."""
    if "one_rows" not in runs:
        runs["one_rows"] = [[(ids, conf) for _, ids, conf in runs["one"].transcribe_with_ids(
            np.load(wave), np.asarray(lengths), seed=seed, with_confidence=True)]
            for wave, lengths, seed in runs["calls"]]
    return runs["one_rows"]


def _assert_rows_equal(got, want):
    assert [[ids for ids, _ in call] for call in got] == [[ids for ids, _ in call]
                                                          for call in want]
    for g_call, w_call in zip(got, want):
        for (_, g), (_, w) in zip(g_call, w_call):
            assert abs(g - w) <= 1e-5


# ------------------------------------------------------ 1. the transcripts
@pytest.mark.parametrize("case,name,ranks", [("aot_m2", "tp", 2), ("aot_m2", "ring", 2),
                                              ("aot_fresh", None, 4)],
                         ids=["model2", "model2_seq_parallel", "data2_model2_fresh"])
def test_sharded_artifacts_equal_one_process(runs, case, name, ranks):
    """Every rank of every mesh returns every row: the one-process
    artifact's ids (and conf within 1e-5) at the same seeds, bucket
    padding, short rows and pad rows included."""
    want = _one_rows(runs)
    assert len({tuple(ids) for call in want for ids, _ in call}) > 2  # the calls differ
    results = runs[case]
    assert len(results) == ranks
    for rank in results:
        _assert_rows_equal((rank[name] if name else rank)["rows"], want)


def test_a_mesh_made_after_the_load_leaves_the_artifact_on_its_mesh(runs):
    """A data=2 mesh made after the model=2 load (its "model" groups of one
    rank each) does not move the loaded program's collectives: its rows
    are still one process's."""
    for rank in runs["aot_m2"]:
        _assert_rows_equal(rank["tp"]["rows_after_another_mesh"], _one_rows(runs)[:1])


def test_the_data2_model2_artifact_equals_the_jax_mesh_pipeline(runs, pair):
    """At the artifact's x_T, the JAX pipeline over data=2 x model=2 (eight
    host devices) gives the fresh ranks' ids, conf within 1e-5."""
    jp = pair[0]
    assert len(jax.devices()) >= 4
    jp.apply_mesh(jax_make_mesh(JaxMeshSpec(data=2, model=2)))
    wave, lengths, seed = runs["calls"][0]
    want = _jax_rows(jp, np.load(wave), np.asarray(lengths), _x_T(4, seed))
    got = runs["aot_fresh"][0]["rows"][0]
    assert [ids for ids, _ in got] == [ids for ids, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-5


def test_fresh_ranks_load_without_model_code(runs):
    for rank in runs["aot_fresh"]:
        assert rank["models_imported"] == [] and rank["mesh"] == {"data": 2, "model": 2}


def test_the_model2_ranks_run_eagerly_and_say_why(runs):
    for rank in runs["aot_m2"]:
        for name in ("tp", "ring"):
            assert rank[name]["execution"] == "eager" and rank[name]["native"] == 0
            assert rank[name]["eager_reason"] == "gloo: no graph capture"


# --------------------------------------------------------- 2. the artifact
@pytest.mark.parametrize("art,shape,seq_parallel", [("art_tp", [1, 2], False),
                                                     ("art_ring", [1, 2], True),
                                                     ("art_d2m2", [2, 2], False)])
def test_meta_names_the_mesh_in_the_jax_form(runs, art, shape, seq_parallel):
    meta = aot.read_meta(str(runs["dir"] / art))
    assert meta["mesh"] == {**JAX_MESH, "shape": shape}
    assert meta["seq_parallel"] is seq_parallel
    assert meta["buckets"] == GRID and meta["platforms"] == ["cpu"]
    # the ranks' programs differ (vocabulary offsets, the ring's blocks): one a rank
    assert meta["program_per_model_rank"] is True
    sliced = meta["sharded"]["enc"] | meta["sharded"]["dec"]
    assert (sliced == {}) is seq_parallel  # the ring keeps the weights whole
    assert runs["one"].meta["mesh"] is None and "seq_parallel" not in runs["one"].meta


@pytest.mark.parametrize("art", ["art_tp", "art_ring", "art_d2m2"])
def test_params_are_whole_and_no_program_holds_them(runs, pair, art):
    """params.npz holds the one-process artifact's tensors bit for bit; a
    program file keeps no state, no example inputs and no weight's bytes."""
    _, tp, *_ = pair
    d = runs["dir"]
    got = aot.load_params_npz(str(d / art / "params.npz"))
    want = aot.load_params_npz(str(d / "art_one" / "params.npz"))
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert all(g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]) for k in w)
    head = tp.decoder.head.weight.detach().contiguous().numpy().tobytes()[:256]
    files = sorted(f for f in os.listdir(d / art) if f.endswith(".pt2"))
    assert files == ["module_n8000_model0.pt2", "module_n8000_model1.pt2"]
    for name in files:
        with zipfile.ZipFile(str(d / art / name)) as z:
            assert not any(head in z.read(i) for i in z.namelist())
    program = _program(runs, art, files[1])  # a load costs seconds: one a rank's file
    assert not program.state_dict and program.example_inputs is None


@pytest.mark.parametrize("art,ops", [
    ("art_tp", {"fddm.gated_attention": 1, "fddm.all_reduce": None, "fddm.all_gather": None}),
    ("art_ring", {"fddm.ring_shift": None, "fddm.all_gather": None}),
    ("art_d2m2", {"fddm.gated_attention": 1, "fddm.all_reduce": None})])
def test_collectives_are_ops_keyed_by_mesh_axis(runs, art, ops):
    """The kernels' and the collectives' `torch.ops.fddm` nodes: B1 once a
    WavLM layer (one here) and rank, the collectives over "model" (never a group's
    own name), the ring's hop in the sequence-parallel program and no
    kernel there (its attention is the ring's)."""
    program = _program(runs, art, "module_n8000_model1.pt2")
    calls = [n for n in program.graph.nodes if n.op == "call_function"]
    found = {}
    for node in calls:
        name = str(node.target).rsplit(".", 1)[0]
        if name.startswith("fddm."):
            found[name] = found.get(name, 0) + 1
            if name in ("fddm.all_reduce", "fddm.all_gather", "fddm.ring_shift"):
                assert node.args[1] == "model", node
    for name, count in ops.items():
        assert found.get(name, 0) == count if count is not None else found.get(name, 0) > 0, \
            (name, found)
    if art == "art_ring":
        assert "fddm.gated_attention" not in found


# -------------------------------------------------------------- 3. refusals
def test_a_bucket_batch_the_data_axis_does_not_divide_raises(pair):
    """As JAX `aot.py:243-248`: before anything is traced."""
    _, tp, *_ = pair
    tp.applied_mesh = P.Mesh(data=2, model=2)
    try:
        with pytest.raises(ValueError, match="divisible"):
            aot.export_transcribe(tp, 3, N, SEQ_LEN, SAMPLING)
        with pytest.raises(ValueError, match="divisible"):
            aot.save_artifact(tp, "unused", [(2, N), (3, N)], SEQ_LEN, SAMPLING, "unused")
    finally:
        tp.applied_mesh = None


def test_a_sharded_artifact_needs_its_world_size(runs):
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2"):
        aot.ExportedPipeline.load(str(runs["dir"] / "art_tp"), device="cpu")
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 4"):
        aot.ExportedPipeline.load(str(runs["dir"] / "art_d2m2"), device="cpu")


@pytest.mark.parametrize("flags", [["--mesh", "model=2"], ["--seq-parallel"]])
def test_mesh_flags_beside_exported_raise_as_the_root_server(runs, flags):
    with pytest.raises(SystemExit, match="pass --mesh to python -m "
                                         "fddm_asr_tpu_torch.export_model instead"):
        S.build_server(S.parse_args(["--exported", str(runs["dir"] / "art_tp"), "--port", "0",
                                     "--device", "cpu", *flags]))


# ---------------------------------------------------------- 4. the server
def _engine_rows(one, waves: list) -> list:
    """The ids the engine's batches get from one process's artifact: each
    upload its own batch, padded into the bucket, batch n at seed n (the
    condition mask keeps a row's ids free of the batch's pad rows)."""
    out = []
    for counter, wave in enumerate(waves, start=1):
        padded = np.zeros((1, N), np.float32)
        padded[0, :len(wave)] = wave
        rows = one.transcribe_with_ids(padded, np.array([len(wave)]),
                                       generator=torch.Generator().manual_seed(counter))
        out.append(rows[0][1])
    return out


def test_serve_exported_entry_point_over_data2_model2(runs):
    """`serve.main --exported` on the four fresh ranks (rank 0 serving, the others
    following its dispatches): buckets aligned to the data axis, /healthz
    naming the mesh and the eager mode, each upload a batch of two rows
    (one a pad row) with one process's artifact's ids at that batch and
    counter; shutting rank 0's server down stops every rank."""
    rank0 = runs["aot_fresh"][0]
    assert rank0["batch_multiple"] == 2 and rank0["max_batch"] == 4 and rank0["stopped"]
    health = rank0["health"]
    assert health["mesh"] == {"data": 2, "model": 2, "seq_parallel": False}
    assert health["execution"] == "eager" and health["native_buckets"] == []
    assert health["eager_reason"] == "gloo: no graph capture"
    assert rank0["served"] == _engine_rows(runs["one"], [np.load(p) for p in runs["uploads"]])
