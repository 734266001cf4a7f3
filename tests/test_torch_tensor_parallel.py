# -*- coding: utf-8 -*-
"""Tensor parallelism in the port (`fddm_asr_tpu_torch/parallel/tensor.py`
and the layers that call it) against one process and against the JAX
package's `_DECODER_RULES` on a mesh.

Two gloo process groups on the CPU run beside the test process
(`tests/torch_parallel_worker.py`, started once for the module): "tp2", two
ranks on a model=2 mesh, and "tp4", four ranks on data=2 x model=2.

* The rules: every parameter of the decoder and the encoder is sliced on
  the axis `decoder_param_spec` gives its JAX counterpart (at model=2), and
  a width that does not divide (model=3) leaves its layers whole, as
  `shard_pytree` leaves its leaves.  `gather_state(shard_module(m))` is m's
  state bit for bit (in the workers).
* Inference: `apply_mesh` ids at model=2 and data=2 x model=2 in float32
  equal the unsharded port's and the JAX pipeline's on a data=4 x model=2
  mesh of the 8 virtual CPU devices (JAX tests/test_parallel.py:80-110) on
  the same weights and injected x_init; the same under quant_dense int8
  (:153-190).
* The fine-tune step (dropout off, injected t, x_t and time mask): loss
  terms within rtol 1e-5 of one process's, the gathered gradients within
  1e-5 of the largest (1e-4 against the JAX step on a data=2 x model=2
  mesh), the gathered parameters after the step within 2e-5 where the
  gradient's sign is resolved (as tests/test_torch_parallel.py); a LoRA
  step and the one after it against one process's.
* A training run at model=2: rank 0 alone writes files, the train loss
  equals one process's, the ep001 checkpoint is the one-process format and
  gives the same ids in one process as under the mesh, and `--resume`
  under the mesh runs its second epoch.
"""
import copy
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
from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu.convert.torch_ckpt import save_reference_checkpoint
from fddm_asr_tpu.parallel import MeshSpec as JaxMeshSpec
from fddm_asr_tpu.parallel import decoder_param_spec, make_mesh as jax_make_mesh, shard_pytree
from fddm_asr_tpu.pipeline import FDDMPipeline as JaxPipeline
from fddm_asr_tpu.pipeline import build_wavlm_config
from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.convert import wavlm_state_dict_from_jax_params
from fddm_asr_tpu_torch.models.lora import jax_path
from fddm_asr_tpu_torch.parallel import tensor as T
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from tests.test_torch_parallel import _draws, _resolved, _run_cfg, _step_cfg
from tests.test_torch_train_loop import corpus  # noqa: F401  (the module fixture)
from tests.test_torch_train_step import _jax_setup, _jparams, _named, _port_setup
from tests.torch_parallel_worker import collect, launch

B, L = 4, 12  # the step's global batch; tokens
K, SEQ = 96, 8  # the inference config's vocabulary; tokens sampled
INFER_CFG = {"seed": 0, "data": {"vocab_size": K, "pad_id": 3, "tokenizer_path": None},
             "model": {"d_model": 32, "nhead": 4, "num_layers": 2, "dim_ff": 64,
                       "dtype": "float32", "encoder": {"wavlm_name": "tiny"}},
             "diffusion": {"T": 20, "beta_max": 0.2}}


def _int8(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["model"]["quant_dense"] = "int8"
    cfg["model"]["encoder"]["wavlm_config"] = {"quant_dense": "int8"}
    return cfg


class _Chars:
    def DecodeIds(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)

    def decode(self, ids):
        return self.DecodeIds(ids)


def _jax_ids(cfg: dict, params, wave, x_init):
    """The JAX pipeline's ids on a data=4 x model=2 mesh (params placed by
    `decoder_param_spec`), sampled from `x_init` as the port samples."""
    jcfg = JaxConfig(cfg)
    jp = JaxPipeline(jcfg, params[0], params[1], JD.make_schedule(K, 20, 0.2), _Chars(),
                     {"pad_id": 3, "bos_id": None, "eos_id": None, "unk_id": None},
                     build_wavlm_config(jcfg.model.encoder))
    mesh = jax_make_mesh(JaxMeshSpec(data=4, model=2))
    jp.apply_mesh(mesh)
    with mesh:
        c, c_mask = jp.encode_waveform(wave)
        scfg = JS.SamplerConfig(K=K, T_train=20, T_infer=4, r=2, greedy=True,
                                posterior_mode="map")

        def decoder_apply(p, xt, t, cond, cm):
            return jp.decoder.apply(p, xt, t, cond, None, cm, deterministic=True)

        ids, _ = JS.make_sample_fn(decoder_apply, jp.sched, scfg)(
            jp.decoder_params, jax.random.key(0), c, SEQ, c_mask, jnp.asarray(x_init))
    return np.asarray(ids)


@pytest.fixture(scope="module")
def tp(tmp_path_factory, corpus):  # noqa: F811
    """Starts both worker groups, then computes the references while they
    work: the JAX step on data=2 x model=2, the one-process port steps,
    inference ids (port unsharded, JAX on its mesh) and training run."""
    root = str(tmp_path_factory.mktemp("tensor_parallel"))
    rng = np.random.default_rng(0)
    cfg_dict = _step_cfg()
    jcfg, cfg = JaxConfig(cfg_dict), Config(cfg_dict)
    jpipe, mods, jstate, jstep = _jax_setup(jcfg, True, rng)
    pipe, state, step = _port_setup(cfg, jpipe, jstate, True)
    wave = rng.standard_normal((B, 3200)).astype(np.float32)
    x0 = rng.integers(1, 96, (B, L)).astype(np.int32)
    x0[1, 9:] = 0
    key = jax.random.key(42)
    draws = _draws(jpipe, x0, key)
    heads = [m.state_dict() for m in (state.s_proj, state.t_embed, state.t_proj)]
    common = {"decoder": pipe.decoder.state_dict(), "encoder": pipe.encoder.state_dict(),
              "heads": heads, "wave": torch.from_numpy(wave), "x0": torch.from_numpy(x0),
              "draws": {k: torch.from_numpy(v) for k, v in draws.items()}}
    torch.save({"cfg": cfg_dict, **common}, os.path.join(root, "tp_step_inputs.pt"))
    lora_dict = copy.deepcopy(cfg_dict)
    lora_dict["model"]["encoder"].update(lora_rank=2, lora_alpha=4.0)
    torch.save({"cfg": lora_dict, "more_steps": 1, **common},
               os.path.join(root, "tp_lora_inputs.pt"))

    # inference: the JAX pipeline's weights, written for the port
    jp = JaxPipeline(JaxConfig(INFER_CFG), {}, {}, JD.make_schedule(K, 20, 0.2), _Chars(),
                     {"pad_id": 3, "bos_id": None, "eos_id": None, "unk_id": None},
                     build_wavlm_config(JaxConfig(INFER_CFG).model.encoder))
    dec = jax.jit(jp.decoder.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                                   jnp.ones((1,), jnp.int32), jnp.zeros((1, 16, 32)))
    enc = jax.jit(jp.encoder.init)(jax.random.key(1), jnp.zeros((1, 640)))
    ckpt = os.path.join(root, "dec.pt")
    save_reference_checkpoint(ckpt, dec["params"])
    wavlm = wavlm_state_dict_from_jax_params(
        jax.tree.map(np.asarray, enc["params"]["backbone"]))
    infer_wave = np.random.default_rng(1).standard_normal((8, 3200)).astype(np.float32)
    x_init = np.random.default_rng(2).integers(0, K, (8, SEQ))
    cfgs = {"float32": INFER_CFG, "int8": _int8(INFER_CFG)}
    torch.save({"cfgs": cfgs, "ckpt": ckpt, "wavlm": wavlm, "wave": torch.from_numpy(infer_wave),
                "x_init": torch.from_numpy(x_init)}, os.path.join(root, "tp_infer.pt"))
    run = _run_cfg(corpus, f"run_tp_{os.path.basename(root)}")
    with open(os.path.join(root, "run_tp.json"), "w", encoding="utf-8") as f:
        json.dump(run, f)
    procs = {"tp2": launch("tp2", root, 2), "tp4": launch("tp4", root, 4)}
    # (before the JAX step, which takes its state's buffers)
    lpipe, lstate, lstep = _port_setup(Config(lora_dict), jpipe, jstate, True)

    # the JAX step on a data=2 x model=2 mesh: rows over "data", the rules' weights over "model"
    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    with mesh:
        jstate_m = shard_pytree(jstate, mesh, decoder_param_spec)
        rows = NamedSharding(mesh, JaxP("data"))
        jstate_m, jm = jstep(jstate_m, jax.device_put(wave, rows), jax.device_put(x0, rows),
                             key, True)
    jax_out = {"metrics": {k: float(v) for k, v in jm.items()},
               "grads": [g for _, _, g in _named(state, jstate_m.opt_state[0])]}

    # the port in one process
    loss, _ = step.forward(state, wave, x0, True, **draws)
    loss.backward()
    one_grads = [p.grad.clone() for p in state.optimizer.params]
    metrics = step(state, wave, x0, True, **draws)
    one = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": one_grads,
           "params": [p.detach().clone() for p in state.optimizer.params]}
    with lstep.merged(lstate):
        loss, _ = lstep.forward(lstate, wave, x0, True, **draws)
        loss.backward()
    lora = {"grads": [p.grad.clone() for p in lstate.optimizer.params],
            "metrics": [{k: float(v) for k, v in lstep(lstate, wave, x0, True, **draws).items()}
                        for _ in range(2)],
            "params": [p.detach().clone() for p in lstate.optimizer.params]}

    ids = {}
    for name, c in cfgs.items():
        p1 = FDDMPipeline.from_config(Config(c), ckpt_path=ckpt, tokenizer=_Chars(),
                                      wavlm_state_dict=wavlm, device="cpu")
        ids[name] = [r[1] for r in p1.transcribe_with_ids(infer_wave, seq_len=SEQ,
                                                          x_init=x_init, T_infer=4, r=2,
                                                          greedy=True)]
    jax_ids = {name: _jax_ids(c, (dec, enc), infer_wave, x_init).tolist()
               for name, c in cfgs.items()}
    one_cfg = _run_cfg(corpus, f"run_one_{os.path.basename(root)}")
    one_run = TL.run_training(Config(one_cfg), raw_cfg=one_cfg, export_pt=True, device="cpu")
    return {"tp2": collect(procs["tp2"], "tp2", root), "tp4": collect(procs["tp4"], "tp4", root),
            "jax": jax_out, "one": one, "lora": lora, "ids": ids, "jax_ids": jax_ids,
            "run": run, "one_run": one_run, "one_run_cfg": one_cfg, "infer_wave": infer_wave,
            "x_init": x_init}


# --------------------------------------------------------------------- the rules
def _jax_axis(name: str, weight: torch.Tensor, size: int):
    """The port axis of parameter `name` that `decoder_param_spec` and
    `shard_pytree`'s divisibility give its JAX counterpart, None (whole)."""
    module, leaf = name.rsplit(".", 1)
    if leaf.startswith("in_proj_"):  # the packed q/k/v: its q_proj's spec stands for all three
        module, leaf = f"{module}.q_proj", leaf[len("in_proj_"):]
    jleaf = {"weight": "embedding" if module.endswith("emb") else "kernel", "bias": "bias"}.get(
        leaf, leaf)
    spec = tuple(decoder_param_spec(jax_path(module, jleaf)))
    if not spec or all(a is None for a in spec):
        return None
    shape = tuple(weight.shape[::-1]) if jleaf == "kernel" else tuple(weight.shape)
    if name.endswith("in_proj_weight") or name.endswith("in_proj_bias"):
        shape = (shape[0], shape[1] // 3) if jleaf == "kernel" else (shape[0] // 3,)
    axis = [i for i, a in enumerate(spec) if a is not None][0]
    if shape[axis] % size:
        return None
    if "in_proj" in name:
        return T.HEADS
    if jleaf == "embedding":
        return T.VOCAB
    return T.COLUMN if (jleaf == "bias" or axis == 1) else T.ROW


@pytest.mark.parametrize("size", [2, 3])
def test_rules_are_the_jax_rules(size):
    """Each parameter of the decoder and the encoder shards on the axis its
    JAX counterpart does; at model=3 the widths 4 heads and 64 features do
    not divide, so those layers stay whole and the 96-token vocabulary
    alone shards."""
    pipe = FDDMPipeline.from_config(Config(INFER_CFG), tokenizer=_Chars(), device="cpu")
    for module in (pipe.decoder, pipe.encoder):
        plan = T.shard_plan(module, size)
        for name, p in module.named_parameters():
            assert plan.get(name) == _jax_axis(name, p, size), name
    dec_plan = T.shard_plan(pipe.decoder, size)
    kinds = {a for a in dec_plan.values()}
    assert kinds == ({T.HEADS, T.ROW, T.COLUMN, T.VOCAB} if size == 2 else {T.COLUMN, T.VOCAB})
    assert not T.shard_plan(pipe.encoder, 3)


def test_gather_state_round_trips(tp):
    for group in ("tp2", "tp4"):
        for out in tp[group]:
            assert out["infer"]["float32_round_trip"] and out["infer"]["int8_round_trip"]


def test_local_and_gathered_slices_of_each_axis():
    """local_tensor cuts each axis as the layers read it: HEADS takes the
    rank's rows of each of q, k and v."""
    full = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 4)
    got = T.local_tensor(full, T.HEADS, 1, 2)
    assert torch.equal(got, full[[1, 3, 5]])
    assert torch.equal(T.local_tensor(full, T.ROW, 1, 2), full[:, 2:])
    assert torch.equal(T.local_tensor(full, T.COLUMN, 0, 3), full[:2])
    assert torch.equal(T.local_tensor(full[:, 0], T.COLUMN, 2, 3), full[4:, 0])


# -------------------------------------------------------------------- inference
@pytest.mark.parametrize("name", ["float32", "int8"])
def test_ids_equal_one_process_and_jax(tp, name):
    want = tp["ids"][name]
    assert want == tp["jax_ids"][name]
    for group in ("tp2", "tp4"):
        for r, out in enumerate(tp[group]):
            assert out["infer"][name] == want, f"{group} rank {r}"


# --------------------------------------------------------------------- the step
@pytest.mark.parametrize("group", ["tp2", "tp4"])
def test_step_matches_one_process_and_jax(tp, group):
    one, jx = tp["one"], tp["jax"]
    scale = max(float(g.abs().max()) for g in one["grads"])
    resolved = _resolved(jx["grads"], scale)
    for r, rank in enumerate(tp[group]):
        out = rank["step"]
        for k in jx["metrics"]:
            np.testing.assert_allclose(out["metrics"][k], one["metrics"][k], rtol=1e-5,
                                       err_msg=f"{group} rank {r} {k}")
            np.testing.assert_allclose(out["metrics"][k], jx["metrics"][k], rtol=1e-5,
                                       err_msg=f"{group} rank {r} {k} vs JAX")
        for i, (got, want) in enumerate(zip(out["grads"], one["grads"])):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{group} rank {r} grad {i}")
            np.testing.assert_allclose(got.numpy(), jx["grads"][i], rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{group} rank {r} grad {i} vs JAX")
        for i, (got, want, res) in enumerate(zip(out["params"], one["params"], resolved)):
            diff = np.abs(got.numpy() - want.numpy())
            assert diff[res].max(initial=0) <= 2e-5, f"{group} rank {r} param {i}"
            assert diff.max() <= 2.1e-3, f"{group} rank {r} param {i}"
        for a, b in zip(out["params"], tp[group][0]["step"]["params"]):
            assert torch.equal(a, b)  # every rank holds the same model


def test_sliced_gradients_need_no_sum_over_model(tp):
    """Rank by rank before the reduction, at model=2: a sliced weight's
    gradient is already the one process's (gathered), a whole weight's is
    the same on both ranks, and the rel_attn_embed gradient is each rank's
    heads' part (zero on the other heads)."""
    ranks = [out["step"] for out in tp["tp2"]]
    one = tp["one"]["grads"]
    scale = max(float(g.abs().max()) for g in one)
    n_main = ranks[0]["n_main"]
    for i in range(n_main):  # the decoder and the heads
        a, b = ranks[0]["local_grads"][i], ranks[1]["local_grads"][i]
        if a.shape == one[i].shape:  # whole
            assert torch.allclose(a, b, atol=1e-6 * scale, rtol=0), i
    rel = [i for i, g in enumerate(one) if g.dim() == 2 and g.shape[1] == 4 and g.shape[0] == 32]
    assert rel, "rel_attn_embed's gradient [buckets, heads]"
    for i in rel:
        a, b = ranks[0]["local_grads"][i], ranks[1]["local_grads"][i]
        assert float(a[:, 2:].abs().max()) == 0.0 and float(b[:, :2].abs().max()) == 0.0
        np.testing.assert_allclose((a + b).numpy(), one[i].numpy(), rtol=0, atol=1e-5 * scale)


def test_lora_step_matches_one_process(tp):
    one = tp["lora"]
    scale = max(float(g.abs().max()) for g in one["grads"])
    for r, rank in enumerate(tp["tp2"]):
        out = rank["lora"]
        for k, want in one["metrics"][0].items():
            np.testing.assert_allclose(out["metrics"][k], want, rtol=1e-5, err_msg=f"rank {r} {k}")
        for k, want in one["metrics"][1].items():  # B != 0: the slices of (A B)^T in the forward
            np.testing.assert_allclose(out["metrics_after"][0][k], want, rtol=1e-5,
                                       err_msg=f"rank {r} second step {k}")
        for i, (got, want) in enumerate(zip(out["grads"], one["grads"])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"rank {r} grad {i}")
        # after two updates, each of which may differ by twice lr (1e-3) where a
        # gradient's sign is not resolved (Adam's first steps, as the step test)
        for got, want in zip(out["params"], one["params"]):
            assert float((got - want).abs().max()) <= 4.2e-3


# ---------------------------------------------------------------- training runs
def test_run_writes_one_process_checkpoints_and_resumes(tp):
    ranks = tp["tp2"]
    for out in ranks:
        assert out["run"] == ranks[0]["run"]
    np.testing.assert_allclose(ranks[0]["run"]["train_loss"], tp["one_run"]["train_loss"],
                               rtol=1e-5)
    ckpt_dir = tp["run"]["log"]["ckpt_dir"]
    with open(os.path.join(ckpt_dir, "metrics.jsonl"), encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    steps = [r["step"] for r in records if r["kind"] == "step"]
    assert steps == [1, 2, 3, 4]  # rank 0's alone, the resumed epoch continuing
    assert [r["epoch"] for r in records if r["kind"] == "epoch"] == [1, 2]
    assert ranks[0]["resumed"]["epoch"] == 2
    # the format of one process: the same keys and shapes in every file
    one_dir = tp["one_run_cfg"]["log"]["ckpt_dir"]
    for suffix in (".pt", ".encoder.pt", ".state.pt"):
        got = torch.load(os.path.join(ckpt_dir, "ep001" + suffix), weights_only=True)
        want = torch.load(os.path.join(one_dir, "ep001" + suffix), weights_only=True)
        flat_got, flat_want = _shapes(got), _shapes(want)
        assert flat_got == flat_want, suffix
    # one process loads the checkpoint and gives the mesh's ids
    cfg = tp["run"]
    pipe = FDDMPipeline.from_config(
        Config(cfg), ckpt_path=os.path.join(ckpt_dir, "ep001.pt"), tokenizer=_Chars(),
        encoder_state_dict=torch.load(os.path.join(ckpt_dir, "ep001.encoder.pt")),
        device="cpu")
    rows = pipe.transcribe_with_ids(tp["infer_wave"], seq_len=SEQ, x_init=tp["x_init"],
                                    T_infer=4, r=2, greedy=True)
    for out in ranks:
        assert out["ckpt_ids"] == [r[1] for r in rows]


def _shapes(obj, prefix=""):
    """{path: shape} of the tensors in a nested checkpoint, and the other
    leaves' types (config dicts and counts are not compared by value)."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k in ("config", "log"):
                continue
            out.update(_shapes(v, f"{prefix}/{k}"))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(_shapes(v, f"{prefix}/{i}"))
    elif torch.is_tensor(obj):
        out[prefix] = (tuple(obj.shape), obj.dtype)
    else:
        out[prefix] = type(obj).__name__
    return out
