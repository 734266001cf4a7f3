# -*- coding: utf-8 -*-
"""The port's multi-process layer (`fddm_asr_tpu_torch/parallel/`, the
data-parallel and sequence-parallel train step and loop, `apply_mesh`)
against the JAX package's and against one process.

Two gloo process groups on the CPU run beside the test process
(`tests/torch_parallel_worker.py`, started once for the module, their
inputs written here from seeds): "dp", two ranks on a data=2 mesh, and
"sp", four ranks on data=2 x model=2 with the encoder sequence parallel.

* The fine-tune step with L_fd on a global batch of 4 with injected t, x_t
  and SpecAugment time mask (the JAX step's own draws): the two-rank step
  against the JAX step on a data=2 mesh of the 8 virtual CPU devices and
  against the port's one-process step: loss terms within rtol 1e-5; the
  reduced gradients within 1e-5 of the largest (the one-process port's),
  1e-4 (JAX's, as tests/test_torch_train_step.py); the parameters after the
  step within 2e-5 where the gradient's sign is resolved (elsewhere Adam's
  first update lr * g / (|g| + eps) may differ by up to twice lr, as that
  file explains).  The four-rank sequence-parallel step against the
  one-process step the same way: its encoder's gradients are summed over
  the ring and then averaged over data, the decoder's only averaged.
* Training runs (`run_training`, two steps and an evaluation on the CPU
  corpus of tests/test_torch_train_loop.py, fine-tuning a two-layer tiny
  WavLM): the data=2 run's train loss equals one process's within rtol
  1e-5, and the data=2 x model=2 sequence-parallel run's the data=2 run's,
  with an equal val_cer (each evaluates the same shards); only rank 0 wrote
  metrics.jsonl and the checkpoints.
* `apply_mesh(seq_parallel=True)` at data=2 x model=2: the ids equal the
  unsharded pipeline's (JAX tests/test_ring_attention.py:133-166).
* `make_batches(shard=...)`: each rank's rows are the JAX layout's.
* The deliberate differences from the JAX package: a process drives one
  GPU (the world is data x model, LOCAL_RANK picks the card), so a model
  axis in one process (tensor parallelism, `test_torch_tensor_parallel.py`),
  `serve --mesh` or `export_model --mesh` (sharded artifacts,
  `test_torch_aot_mesh.py`) asks for the launcher; and the backend is
  explicit: asking for nccl without a card raises, it never falls back to
  gloo.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JaxP

from fddm_asr_tpu import diffusion as JD
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.data.dataset import make_batches as jax_make_batches
from fddm_asr_tpu.models.wavlm import sample_time_mask as jax_sample_time_mask
from fddm_asr_tpu.parallel import decoder_param_spec, shard_pytree
from fddm_asr_tpu_torch import inference as infer_cli
from fddm_asr_tpu_torch import parallel as P
from fddm_asr_tpu_torch import train as train_cli
from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.data.dataset import make_batches
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from tests.test_torch_train_loop import _config as loop_config
from tests.test_torch_train_loop import _write as loop_write
from tests.test_torch_train_loop import corpus  # noqa: F401  (the module fixture)
from tests.test_torch_train_step import (
    MASK_LEN, MASK_PROB, N_WAVE, T_DIFF, _cfg, _jax_setup, _jparams, _named, _port_setup,
)
from tests.torch_parallel_worker import collect, launch

B, L = 4, 12  # the global batch; tokens


def _step_cfg() -> dict:
    cfg = _cfg(freeze=False)
    cfg["optim"]["batch_size"] = B
    # the JAX step on a mesh takes its XLA attention (the port's numerics)
    cfg["model"]["encoder"]["wavlm_config"]["fused_attention"] = False
    return cfg


def _draws(jpipe, x0, key):
    """The JAX fine-tune step's t, x_t and time mask for the global batch."""
    rng_core, _, rng_mask = jax.random.split(key, 3)
    rng_t, rng_q, _ = jax.random.split(rng_core, 3)
    t = jax.random.randint(rng_t, (B,), 1, T_DIFF + 1)
    xt = JD.sample_xt_tokens(jpipe.sched, rng_q, jnp.asarray(x0), t)
    S = jpipe.encoder.config.feat_extract_output_length(N_WAVE)
    tm = jax_sample_time_mask(jax.random.split(rng_mask)[0], B, int(S), MASK_PROB, MASK_LEN)
    return {"t": np.array(t), "xt": np.array(xt), "time_mask": np.array(tm)}


def _run_cfg(corpus, name, seq_parallel=False):  # noqa: F811
    """The loop file's tiny config, fine-tuning a two-layer WavLM with every
    dropout off (dropout masks are drawn per rank) and SpecAugment on."""
    enc = {"wavlm_name": "tiny", "freeze": False, "proj": "linear", "pooling": "none",
           "mask_time_prob": 0.3, "mask_time_length": 2, "seq_parallel": seq_parallel,
           "wavlm_config": {"num_hidden_layers": 2, "hidden_dropout": 0.0,
                            "attention_dropout": 0.0, "activation_dropout": 0.0}}
    model = {**loop_config(corpus, name)["model"], "dropout": 0.0, "encoder": enc}
    return loop_config(corpus, name, model=model, log={"run_lock": True})


@pytest.fixture(scope="module")
def groups(tmp_path_factory, corpus):  # noqa: F811
    """Starts both worker groups, then computes the JAX data=2 step and the
    one-process port step and run while they work."""
    root = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(0)
    cfg_dict = _step_cfg()
    jcfg, cfg = JaxConfig(cfg_dict), Config(cfg_dict)
    jpipe, mods, jstate, jstep = _jax_setup(jcfg, True, rng)
    pipe, state, step = _port_setup(cfg, jpipe, jstate, True)
    wave = rng.standard_normal((B, N_WAVE)).astype(np.float32)
    x0 = rng.integers(1, 96, (B, L)).astype(np.int32)
    x0[1, 9:] = 0
    key = jax.random.key(42)
    draws = _draws(jpipe, x0, key)
    heads = [m.state_dict() for m in (state.s_proj, state.t_embed, state.t_proj)]
    torch.save({"cfg": cfg_dict, "decoder": pipe.decoder.state_dict(),
                "encoder": pipe.encoder.state_dict(), "heads": heads,
                "wave": torch.from_numpy(wave), "x0": torch.from_numpy(x0),
                "draws": {k: torch.from_numpy(v) for k, v in draws.items()}},
               os.path.join(root, "step_inputs.pt"))
    runs = {}
    for name, sp in (("run_dp", False), ("run_sp", True), ("run_one", False)):
        runs[name] = _run_cfg(corpus, f"{name}_{os.path.basename(root)}", sp)
        with open(os.path.join(root, f"{name}.json"), "w", encoding="utf-8") as f:
            json.dump(runs[name], f)
    infer_cfg = {"seed": 0, "data": {"vocab_size": 96, "tokenizer_path": None},
                 "model": {"d_model": 32, "nhead": 4, "num_layers": 2, "dim_ff": 64,
                           "dtype": "float32", "encoder": {"wavlm_name": "tiny"}},
                 "diffusion": {"T": 20, "beta_max": 0.2}}
    infer_wave = np.random.default_rng(0).standard_normal((4, 3200)).astype(np.float32)
    torch.save({"cfg": infer_cfg, "wave": torch.from_numpy(infer_wave)},
               os.path.join(root, "infer_inputs.pt"))
    procs = {"dp": launch("dp", root, 2), "sp": launch("sp", root, 4)}

    # the JAX step on a data=2 mesh: the global batch's rows split over two devices
    mesh = JaxMesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    with mesh:
        jstate_m = shard_pytree(jstate, mesh, decoder_param_spec)
        rows = NamedSharding(mesh, JaxP("data"))
        jstate_m, jm = jstep(jstate_m, jax.device_put(wave, rows), jax.device_put(x0, rows),
                             key, True)
    jax_out = {"metrics": {k: float(v) for k, v in jm.items()},
               "grads": [g for _, _, g in _named(state, jstate_m.opt_state[0])],
               "params": [w for _, _, w in _named(state, _jparams(jstate_m, True))]}

    # the port in one process: gradients of the same loss, then the step
    loss, _ = step.forward(state, wave, x0, True, **draws)
    loss.backward()
    one_grads = [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                 for p in state.optimizer.params]
    metrics = step(state, wave, x0, True, **draws)
    one = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": one_grads,
           "params": [p.detach().clone() for p in state.optimizer.params]}
    one_run = TL.run_training(Config(runs["run_one"]), raw_cfg=runs["run_one"],
                              export_pt=False, device="cpu")

    # the unsharded pipeline's ids (sequence-parallel inference's reference)
    class Tok:
        def DecodeIds(self, ids):
            return "".join(chr(97 + (i % 26)) for i in ids)

    ipipe = FDDMPipeline.from_config(Config(infer_cfg), tokenizer=Tok(), device="cpu")
    c, c_mask = ipipe.encode_waveform(infer_wave)
    ids, _ = ipipe.sample(c, 8, c_mask, generator=torch.Generator().manual_seed(0), T_infer=4,
                          r=2, greedy=True)
    return {"dp": collect(procs["dp"], "dp", root), "sp": collect(procs["sp"], "sp", root),
            "jax": jax_out, "one": one, "one_run": one_run, "ids": ids, "runs": runs}


def _resolved(grads_ref, scale):
    return [np.abs(np.asarray(g)) > 2e-4 * scale for g in grads_ref]


@pytest.mark.parametrize("group", ["dp", "sp"])
def test_step_matches_one_process_and_jax(groups, group):
    ranks = [out["step"] for out in groups[group]]
    one, jx = groups["one"], groups["jax"]
    scale = max(float(g.abs().max()) for g in one["grads"])
    for r, out in enumerate(ranks):
        for k in jx["metrics"]:
            np.testing.assert_allclose(out["metrics"][k], one["metrics"][k], rtol=1e-5,
                                       err_msg=f"{group} rank {r} {k} vs one process")
            if group == "dp":
                np.testing.assert_allclose(out["metrics"][k], jx["metrics"][k], rtol=1e-5,
                                           err_msg=f"rank {r} {k} vs the JAX data=2 step")
        for i, (got, want) in enumerate(zip(out["grads"], one["grads"])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{group} rank {r} grad {i}")
            if group == "dp":
                np.testing.assert_allclose(got.numpy(), jx["grads"][i], rtol=0,
                                           atol=1e-4 * scale, err_msg=f"rank {r} grad {i} vs JAX")
        refs = [("one process", [p.numpy() for p in one["params"]])]
        if group == "dp":
            refs.append(("JAX", jx["params"]))
        resolved = _resolved(jx["grads"], scale)
        for what, params in refs:
            for i, (got, want, res) in enumerate(zip(out["params"], params, resolved)):
                diff = np.abs(got.numpy() - want)
                assert diff[res].max(initial=0) <= 2e-5, f"{group} rank {r} param {i} vs {what}"
                assert diff.max() <= 2.1e-3, f"{group} rank {r} param {i} vs {what}"
    # every rank holds the same state after the step
    for out in ranks[1:]:
        for a, b in zip(out["params"], ranks[0]["params"]):
            assert torch.equal(a, b)


def test_sequence_parallel_sums_the_encoder_gradients_over_the_ring(groups):
    """The rule of the sequence-parallel step, rank by rank before the
    reduction (ranks 2d + m sit at data d, model m): the decoder's and the
    heads' gradients are the same on both ranks of a ring, and the one
    process's is their mean over data; each ring rank's encoder gradient
    covers its own frames only, and the one process's is their sum over the
    ring, averaged over data."""
    local = [out["step"]["local_grads"] for out in groups["sp"]]
    n_main = groups["sp"][0]["step"]["n_main"]
    one = groups["one"]["grads"]
    scale = max(float(g.abs().max()) for g in one)
    for i, want in enumerate(one):
        if i < n_main:
            for d in (0, 2):
                assert torch.equal(local[d][i], local[d + 1][i]), i
            got = (local[0][i] + local[2][i]) / 2
        else:
            got = (local[0][i] + local[1][i] + local[2][i] + local[3][i]) / 2
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=f"grad {i}")
    # a ring rank's part alone is not the encoder's gradient
    enc_part = local[0][-1] + local[2][-1]
    assert float((enc_part / 2 - one[-1]).abs().max()) > 1e-3 * scale


def test_runs_match_one_process_and_each_other(groups):
    dp, sp, one = groups["dp"], groups["sp"], groups["one_run"]
    for out in dp + sp:  # every rank reports the global numbers
        assert out["run"] == dp[0]["run"]
    np.testing.assert_allclose(dp[0]["run"]["train_loss"], one["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(sp[0]["run"]["train_loss"], dp[0]["run"]["train_loss"], rtol=1e-5)
    assert sp[0]["run"]["val_cer"] == dp[0]["run"]["val_cer"]
    for name in ("run_dp", "run_sp"):
        ckpt_dir = groups["runs"][name]["log"]["ckpt_dir"]
        with open(os.path.join(ckpt_dir, "metrics.jsonl"), encoding="utf-8") as f:
            records = [json.loads(line) for line in f]
        assert [r["step"] for r in records if r["kind"] == "step"] == [1, 2]  # rank 0's alone
        assert sum(r["kind"] == "epoch" for r in records) == 1
        assert os.path.exists(os.path.join(ckpt_dir, "ep001.state.pt"))
        assert not os.path.exists(os.path.join(ckpt_dir, ".run.lock"))


def test_sequence_parallel_inference_ids_equal_the_unsharded_ones(groups):
    for out in groups["sp"]:
        assert torch.equal(out["infer"]["ids"], groups["ids"])
        assert out["infer"]["transcribed"] == groups["ids"].tolist()


class _Items:
    """A dataset of n items whose wave holds its index."""

    max_audio_samples = 2

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"wave": np.full((2,), i, np.float32), "wave_length": np.int32(2),
                "tokens": np.zeros((3,), np.int32), "token_length": np.int32(1)}


@pytest.mark.parametrize("n,hosts,drop_last", [(22, 2, True), (22, 2, False), (13, 4, False)])
def test_shard_layout_is_the_jax_one(n, hosts, drop_last):
    ds = _Items(n)
    for shuffle in (False, True):
        kw = dict(shuffle=shuffle, seed=3, epoch=2, drop_last=drop_last, num_workers=1)
        whole = [b.indices for b in make_batches(ds, 3 * hosts, **kw)]
        for h in range(hosts):
            ours = [b.indices for b in make_batches(ds, 3, shard=(h, hosts), **kw)]
            theirs = [b.indices for b in jax_make_batches(ds, 3, shard=(h, hosts), **kw)]
            assert [a.tolist() for a in ours] == [a.tolist() for a in theirs]
            # rank h's k-th batch: rows [3h, 3h + 3) of the k-th global batch
            assert [a.tolist() for a in ours] == [g[3 * h:3 * h + 3].tolist()
                                                  for g in whole if len(g[3 * h:3 * h + 3])]


def test_accumulation_reduces_once_an_update():
    """Under grad_accum_steps the optimizer's reduction runs on the update's
    running mean, once an update, and not on each micro-step's gradients;
    an identity reduction leaves the update as without one."""
    cfg = Config({"optim": {"lr": 1e-2, "grad_accum_steps": 2, "grad_clip": 1.0}})
    rng = np.random.default_rng(1)
    start = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((4, 3), (5,))]
    grads = [[torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in start]
             for _ in range(4)]
    seen = []

    def reduce(gs):
        seen.append([g.clone() for g in gs])
        return gs

    runs = {}
    for name, hook in (("plain", None), ("reduced", reduce)):
        params = [torch.nn.Parameter(p.clone()) for p in start]
        opt = TL.make_optimizer(cfg, params, reduce=hook)
        runs[name] = (params, [opt.step(g)[1] for g in grads])
    assert runs["plain"][1] == runs["reduced"][1] == [False, True, False, True]
    assert len(seen) == 2  # once an update
    for k, (a, b) in enumerate(((0, 1), (2, 3))):
        for got, g0, g1 in zip(seen[k], grads[a], grads[b]):
            torch.testing.assert_close(got, (g0 + g1) / 2)
    for p, q in zip(*(runs[n][0] for n in ("plain", "reduced"))):
        assert torch.equal(p, q)


# ------------------------------------------------------ the deliberate differences
def test_the_world_is_data_times_model():
    """One process a GPU: the world size must equal data x model (the JAX
    package's pinned subset meshes, a 1x1 mesh on a host of 8 devices,
    have no counterpart), and the message names torchrun's flag."""
    assert P.MeshSpec(data=2, model=2).resolve(4) == (2, 2)
    assert P.MeshSpec(model=2).resolve(8) == (4, 2)
    for spec, world in ((P.MeshSpec(data=1), 8), (P.MeshSpec(data=2, model=2), 2)):
        with pytest.raises(ValueError, match=r"torchrun --nproc_per_node \d"):
            spec.resolve(world)
    assert P.parse_mesh("data=2,model=4") == P.MeshSpec(2, 4)
    assert P.parse_mesh("") == P.MeshSpec(-1, 1)
    with pytest.raises(ValueError, match="unknown axes"):
        P.parse_mesh("data=2,tensor=2")
    mesh = P.make_mesh(P.MeshSpec(data=1))  # no process group: the trivial mesh
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    assert P.host_shard(mesh) is None


def test_a_rank_is_one_gpu_picked_by_local_rank():
    env = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "8", "RANK": "5",
           "LOCAL_RANK": "1"}
    cfg = P.DistributedConfig.from_env(env)
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id, cfg.local_rank) == (
        "10.0.0.1:1234", 8, 5, 1)
    assert cfg.is_multiprocess
    fddm = P.DistributedConfig.from_env({**env, "FDDM_COORDINATOR": "h:9", "FDDM_PROCESS_ID": "2",
                                         "FDDM_NUM_PROCESSES": "4"})
    assert (fddm.coordinator_address, fddm.num_processes, fddm.process_id) == ("h:9", 4, 2)
    assert fddm.overridden(num_processes=16).num_processes == 16
    assert not P.DistributedConfig.from_env({}).is_multiprocess
    assert cfg.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.rank_device("cuda")


def test_the_backend_is_explicit_and_never_switched():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert P.DistributedConfig().resolved_backend(cuda) == "nccl"
    assert P.DistributedConfig().resolved_backend(cpu) == "gloo"
    assert P.DistributedConfig(backend="gloo").resolved_backend(cuda) == "gloo"
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        P.DistributedConfig(backend="nccl").resolved_backend(cpu)
    with pytest.raises(ValueError, match="expected one of"):
        P.DistributedConfig(backend="mpi").resolved_backend(cpu)
    # asked for nccl on the CPU, initialize raises and joins nothing (no gloo fallback)
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        P.initialize(P.DistributedConfig("127.0.0.1:1", 2, 0, backend="nccl"), device="cpu")
    assert P.process_group() == (0, 1)
    assert P.initialize(P.DistributedConfig(), device="cpu") == (0, 1)  # one process: no-op
    assert P.all_hosts_weighted_mean(0.25, 3) == 0.25 and P.all_hosts_mean(2.0) == 2.0
    assert P.broadcast_object({"refusal": None}) == {"refusal": None}


def test_a_model_axis_without_sequence_parallelism_names_a7(corpus, tmp_path):  # noqa: F811
    """A model axis without sequence parallelism is tensor parallelism
    (tests/test_torch_tensor_parallel.py runs it): in one process the same
    calls get past it and ask for the process group a mesh of two needs."""
    cfg = loop_config(corpus, "tp")
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2"):
        train_cli.main(["--config", loop_write(corpus, cfg, "tp"), "--device", "cpu",
                        "--mesh", "data=1,model=2"])
    with pytest.raises(ValueError, match=r"needs a process group.*torchrun --nproc_per_node 2"):
        TL.run_training(Config(cfg), raw_cfg=cfg, device="cpu",
                        mesh=P.Mesh(data=1, model=2))
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2"):
        infer_cli.main(["--wav", "x.wav", "--ckpt", "x.pt", "--main-config", "c.yaml",
                        "--diffusion-config", "c.yaml", "--tokenizer", "t", "--device", "cpu",
                        "--mesh", "model=2"])


def test_serve_and_export_with_a_mesh_name_a7_part_2(tmp_path):
    """`export_model --mesh` exports sharded artifacts over a process group
    and `serve --mesh` serves the live pipeline over one
    (tests/test_torch_aot_mesh.py, tests/test_torch_serve_mesh.py); in one
    process a mesh of two asks for the launcher, before anything is read."""
    from fddm_asr_tpu_torch import export_model
    from fddm_asr_tpu_torch import serve

    with pytest.raises(SystemExit, match=r"torchrun --nproc_per_node 2"):
        export_model.main(["--ckpt", "x.pt", "--main-config", "c.yaml", "--diffusion-config",
                           "c.yaml", "--tokenizer", "t", "--out", str(tmp_path / "a"),
                           "--device", "cpu", "--mesh", "data=2"])
    assert not (tmp_path / "a").exists()
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2"):
        serve.main(["--config", "c.yaml", "--ckpt", "x.pt", "--tokenizer", "t",
                    "--device", "cpu", "--mesh", "data=2"])
