# -*- coding: utf-8 -*-
"""The multi-process layer on the card.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_parallel_cuda.py

* The ring (`ops/ring_attention.py`) at ring 2, its two ranks sharing the
  card over gloo (`tests/torch_parallel_worker.py`, case `ring_cuda`), at
  WavLM-large's heads (H = 16, dh = 64, L = 1024, float32, ragged key
  masks and one all-masked row): its output within 2e-5 of the plain
  attention and within 1e-4 of the forward kernel on one rank, and the
  gradients of sum(out * dout) within 1e-4 (of the largest) of the
  kernels' backward (B3, B4, B5) on one rank.
* The fine-tune step on a data=1 mesh over NCCL at world size 1 (its
  gradients through the NCCL all-reduce) against the bare step: the same
  metrics, gradients and updated parameters (as phase 6 holds the card to
  the CPU) and the same kernel launches.
"""
import os
import socket

import numpy as np
import pytest
import torch

from fddm_asr_tpu_torch import parallel as P
from fddm_asr_tpu_torch import train_lib as TL
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.ops import flash_attention as FA
from fddm_asr_tpu_torch.ops import kernel_wrappers
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from torch_parallel_worker import collect, launch  # tests/ is on the path

pytestmark = pytest.mark.cuda
B, L, H, DH = 2, 1024, 16, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _ring_inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    normal = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    mask = torch.ones(B, L, dtype=torch.bool)
    mask[0, 999:] = False
    mask[1] = False  # no key kept: the uniform average
    return {"q": normal(B, L, H, DH), "k": normal(B, L, H, DH), "v": normal(B, L, H, DH),
            "bias": normal(H, L, L), "gate": 1.0 + torch.from_numpy(
                rng.random((B, H, L)).astype(np.float32)), "mask": mask,
            "dout": normal(B, L, H, DH)}


def test_ring_matches_the_single_rank_kernels(cuda_device, tmp_path):
    case = _ring_inputs(0)
    torch.save({"ragged": case}, os.path.join(tmp_path, "ring_inputs.pt"))
    procs = launch("ring_cuda", str(tmp_path), 2, {"FDDM_BACKEND": "gloo",
                                                   "FDDM_DEVICE": "cuda:0"})
    dev = {k: v.to(cuda_device) for k, v in case.items()}
    packed = lambda t: t.reshape(B, L, H * DH)  # noqa: E731
    leaves = [packed(dev[k]).clone().requires_grad_(True) for k in ("q", "k", "v")]
    leaves += [dev["bias"].clone().requires_grad_(True), dev["gate"].clone().requires_grad_(True)]
    for w in kernel_wrappers().values():
        w.launches = 0
    ref = FA.wavlm_gated_attention_heads_packed_trainable(*leaves, dev["mask"], num_heads=H)
    (ref * packed(dev["dout"])).sum().backward()
    counts = {k: w.launches for k, w in kernel_wrappers().items()}
    assert counts["fwd_lse"] == counts["bwd_dq"] == counts["bwd_dkv"] == 1
    with torch.no_grad():
        plain = FA.wavlm_gated_attention_plain(*(packed(dev[k]) for k in ("q", "k", "v")),
                                               dev["bias"], dev["gate"], dev["mask"],
                                               num_heads=H)
    want = {"dq": leaves[0].grad.reshape(B, L, H, DH), "dk": leaves[1].grad.reshape(B, L, H, DH),
            "dv": leaves[2].grad.reshape(B, L, H, DH), "dbias": leaves[3].grad,
            "dgate": leaves[4].grad}
    ranks = collect(procs, "ring_cuda", str(tmp_path))
    join = {"out": 1, "dq": 1, "dk": 1, "dv": 1, "dbias": 1, "dgate": 2}
    got = {k: torch.cat([r["ragged/ring2"][k] for r in ranks], dim=axis).to(cuda_device)
           for k, axis in join.items()}
    out = got["out"].reshape(B, L, H * DH)
    assert float((out - plain).abs().max()) <= 2e-5
    assert float((out - ref.detach()).abs().max()) <= 1e-4
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= 1e-4 * float(w.abs().max()), k


def _small_config() -> Config:
    """A float32 fine-tune step whose WavLM heads are 64 wide (the kernels),
    every dropout off (its masks come from the device's default generator)."""
    return Config({
        "seed": 0,
        "data": {"vocab_size": 64, "pad_id": 3, "max_len": 16, "tokenizer_path": None},
        "model": {"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192, "dropout": 0.0,
                  "dtype": "float32", "projector": {"d_proj": 32},
                  "encoder": {"wavlm_name": "tiny", "freeze": False, "mask_time_prob": 0.2,
                              "mask_time_length": 3,
                              "wavlm_config": {"hidden_size": 128, "num_attention_heads": 2,
                                               "intermediate_size": 256,
                                               "attention_dropout": 0.0, "hidden_dropout": 0.0,
                                               "activation_dropout": 0.0}}},
        "diffusion": {"T": 200, "beta_max": 0.2},
        "optim": {"batch_size": 3, "lr": 1e-3, "encoder_lr": 3e-4, "dtype": "float32",
                  "ema_decay": 0.999},
        "lfd": {"n_step_fd": 2},
    })


def _steps(cfg, mesh) -> dict:
    """Two steps (L_fd on the first); the first step's gradients as the
    optimizer got them and the parameters after it."""
    class Tok:
        def encode(self, text):
            return [5, 6, 7]

    pipe = FDDMPipeline.from_config(cfg, tokenizer=Tok(), device="cuda")
    state = TL.init_train_state(pipe, cfg, generator=torch.Generator(device="cuda").manual_seed(5),
                                mesh=mesh)
    step = TL.make_train_step(pipe, cfg, train_encoder=True, mesh=mesh)
    out = {}
    reduce = state.optimizer.reduce

    def reduce_and_keep(grads):
        grads = grads if reduce is None else reduce(grads)
        out.setdefault("grads", [g.clone() for g in grads])
        return grads

    state.optimizer.reduce = reduce_and_keep
    rng = np.random.default_rng(4)
    wav = rng.standard_normal((3, 16000)).astype(np.float32)
    x0 = rng.integers(4, 64, (3, 16))
    x0[1, 10:] = 3
    gen = torch.Generator(device="cuda").manual_seed(8)
    for w in kernel_wrappers().values():
        w.launches = 0
    out["metrics"] = []
    for lfd in (True, False):
        out["metrics"].append({k: float(v) for k, v in step(state, wav, x0, lfd,
                                                              generator=gen).items()})
        out.setdefault("params", [p.detach().clone() for p in state.optimizer.params])
    torch.cuda.synchronize()
    out["launches"] = {k: w.launches for k, w in kernel_wrappers().items()}
    return out


def test_world_size_one_nccl_step_matches_the_bare_step(cuda_device):
    """As chip_smoke.py phase 20 (a) and phase 6: the metrics within rtol
    1e-5, the gradients within 1e-5 of the largest (the card's convolution
    backward need not repeat bit for bit), the updated parameters within
    1e-6 where the gradient's sign is resolved and 2.1 lr anywhere."""
    cfg = _small_config()
    bare = _steps(cfg, None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    P.initialize(P.DistributedConfig(f"127.0.0.1:{port}", 1, 0, backend="nccl"))
    try:
        mesh = P.make_mesh(P.MeshSpec(data=1, model=1))
        assert mesh.distributed and mesh.data_group is not None
        nccl = _steps(cfg, mesh)
    finally:
        P.shutdown()
    for got, want in zip(nccl["metrics"], bare["metrics"]):
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    scale = max(float(g.abs().max()) for g in bare["grads"])
    for g, w, p, q in zip(nccl["grads"], bare["grads"], nccl["params"], bare["params"]):
        assert float((g - w).abs().max()) <= 1e-5 * scale
        diff = (p - q).abs()
        resolved = w.abs() > 2e-4 * scale
        if resolved.any():
            assert float(diff[resolved].max()) <= 1e-6
        assert float(diff.max()) <= 2.1 * 1e-3
    assert nccl["launches"] == bare["launches"] and bare["launches"]["bwd_dq"] > 0
