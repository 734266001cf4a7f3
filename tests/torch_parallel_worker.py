# -*- coding: utf-8 -*-
"""One rank of a CPU process group (gloo) for the port's multi-process tests.

Run by `tests/test_torch_parallel.py` and `tests/test_torch_ring_attention.py`,
never under pytest itself:

    FDDM_COORDINATOR=127.0.0.1:PORT FDDM_NUM_PROCESSES=N FDDM_PROCESS_ID=R \\
        python tests/torch_parallel_worker.py CASE DIR

It imports torch and the port only (no JAX), reads its inputs from DIR
(written by the test from a seed) and writes `DIR/CASE.rank<R>.pt`.

  ring  4 ranks: `ops/ring_attention.ring_gated_attention` at ring 4 (the
        world) and ring 2 (ranks {0, 1} and {2, 3}): each case's output
        block and the gradients of sum(out * dout)
  ring_cuda  the same at ring 2 on the card (FDDM_DEVICE, FDDM_BACKEND)
  dp    2 ranks, mesh data=2: the fine-tune step (its gradients before and
        after the reduction, then the step's metrics and parameters) on
        injected global draws, and a training run (`train_lib.run_training`)
  sp    4 ranks, mesh data=2 x model=2, sequence parallel: the same step and
        run, and `FDDMPipeline.apply_mesh(seq_parallel=True)` ids
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import socket  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

from fddm_asr_tpu_torch import parallel as P  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(case: str, root: str, world: int, env_extra: dict = None) -> list:
    """Start the `world` ranks of CASE on DIR (one thread each, `env_extra`
    added to their environment) and return their processes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = {**os.environ, "FDDM_COORDINATOR": f"127.0.0.1:{port}",
               "FDDM_NUM_PROCESSES": str(world), "FDDM_PROCESS_ID": str(rank),
               "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu", **(env_extra or {})}
        # a log file each: a rank blocked on a full pipe would stall its peers
        with open(os.path.join(root, f"{case}.rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"), case,
                 root], env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
    return procs


def collect(procs: list, case: str, root: str, timeout: float = 300) -> list:
    """Each rank's output, in rank order, once all have exited; raises with
    the log of a rank that failed (and stops the others)."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(root, f"{case}.rank{rank}.log")) as f:
                log = [line for line in f if not line.startswith("[W")]
            raise RuntimeError(f"{case} rank {rank} exited {p.returncode}:\n"
                               + "".join(log)[-4000:])
    return [torch.load(os.path.join(root, f"{case}.rank{r}.pt")) for r in range(len(procs))]


def ring_case(root: str, rank: int, device: torch.device) -> dict:
    import torch.distributed as dist

    from fddm_asr_tpu_torch.ops.ring_attention import ring_gated_attention

    cases = torch.load(os.path.join(root, "ring_inputs.pt"))
    world = dist.get_world_size()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])] if world == 4 else None
    out = {}
    for name, case in cases.items():
        case = {k: v.to(device) for k, v in case.items()}
        for ring in ((2, 4) if world == 4 else (2,)):
            group = None if ring == world else pairs[rank // 2]
            me = rank % ring
            L = case["q"].shape[1]
            l = L // ring
            blk = slice(me * l, (me + 1) * l)
            leaf = {k: case[k][:, blk].clone().requires_grad_(True) for k in ("q", "k", "v")}
            bias = case["bias"][:, blk].clone().requires_grad_(True)
            gate = case["gate"][:, :, blk].clone().requires_grad_(True)
            got = ring_gated_attention(leaf["q"], leaf["k"], leaf["v"], bias, gate,
                                       case["mask"][:, blk],
                                       group if group is not None else dist.group.WORLD)
            (got * case["dout"][:, blk]).sum().backward()
            out[f"{name}/ring{ring}"] = {k: t.detach().cpu() for k, t in (
                ("out", got), ("dq", leaf["q"].grad), ("dk", leaf["k"].grad),
                ("dv", leaf["v"].grad), ("dbias", bias.grad), ("dgate", gate.grad))}
    return out


def step_case(root: str, mesh) -> dict:
    """The fine-tune step of `step_inputs.pt` on this rank's rows."""
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline

    spec = torch.load(os.path.join(root, "step_inputs.pt"))
    cfg = Config(spec["cfg"])

    class Tok:
        def encode(self, text):
            return [5, 6, 7]

    pipe = FDDMPipeline.from_config(cfg, tokenizer=Tok(), device="cpu")
    pipe.decoder.load_state_dict(spec["decoder"])
    pipe.encoder.load_state_dict(spec["encoder"])
    pipe.enable_seq_parallel(mesh)
    heads = TL.make_projection_heads(cfg, "cpu", torch.float32)
    for head, sd in zip(heads, spec["heads"]):
        head.load_state_dict(sd)
    state = TL.init_train_state(pipe, cfg, train_encoder=True, heads=heads, mesh=mesh)
    step = TL.make_train_step(pipe, cfg, train_encoder=True, mesh=mesh)
    b = spec["wave"].shape[0] // mesh.shape["data"]
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    wave, x0 = spec["wave"][rows], spec["x0"][rows]
    draws = spec["draws"]
    loss, _ = step.forward(state, wave, x0, True, **draws)
    loss.backward()
    local = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for p in state.optimizer.params]
    grads = state.optimizer.reduce([g.clone() for g in local])
    metrics = step(state, wave, x0, True, **draws)
    return {"local_grads": local, "grads": grads, "n_main": len(state.optimizer.groups[0][0]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": [p.detach().clone() for p in state.optimizer.params]}


def run_case(root: str, mesh, name: str) -> dict:
    """`train_lib.run_training` of DIR/<name>.json's config on `mesh`."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.train_lib import run_training

    with open(os.path.join(root, f"{name}.json"), encoding="utf-8") as f:
        raw = json.load(f)
    summary = run_training(Config(raw), raw_cfg=raw, export_pt=False, device="cpu", mesh=mesh)
    return {k: summary[k] for k in ("train_loss", "val_cer", "val_loss", "test_cer")}


def infer_case(root: str, mesh) -> dict:
    """apply_mesh(seq_parallel=True): encode the global batch, sample this
    rank's rows, gather them."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline

    spec = torch.load(os.path.join(root, "infer_inputs.pt"))

    class Tok:
        def DecodeIds(self, ids):
            return "".join(chr(97 + (i % 26)) for i in ids)

    pipe = FDDMPipeline.from_config(Config(spec["cfg"]), tokenizer=Tok(), device="cpu")
    pipe.apply_mesh(mesh, seq_parallel=True)
    c, c_mask = pipe.encode_waveform(spec["wave"].numpy())
    ids, _ = pipe.sample(c, 8, c_mask, generator=torch.Generator().manual_seed(0),
                         T_infer=4, r=2, greedy=True)
    rows = pipe.transcribe_with_ids(spec["wave"].numpy(), seq_len=8,
                                    generator=torch.Generator().manual_seed(0),
                                    T_infer=4, r=2, greedy=True)
    return {"ids": pipe._gathered(ids), "transcribed": [r[1] for r in rows]}


def main() -> int:
    case, root = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    device = "cuda" if case == "ring_cuda" else "cpu"
    dist_cfg = P.DistributedConfig.from_env()
    rank, world = P.initialize(dist_cfg, device=device)
    try:
        if case in ("ring", "ring_cuda"):
            out = ring_case(root, rank, dist_cfg.rank_device(device))
        elif case == "dp":
            mesh = P.make_mesh(P.MeshSpec(data=2, model=1))
            out = {"step": step_case(root, mesh), "run": run_case(root, mesh, "run_dp")}
        elif case == "sp":
            mesh = P.make_mesh(P.MeshSpec(data=2, model=2))
            out = {"step": step_case(root, mesh), "run": run_case(root, mesh, "run_sp"),
                   "infer": infer_case(root, mesh)}
        else:
            raise ValueError(f"unknown case {case!r}")
        torch.save(out, os.path.join(root, f"{case}.rank{rank}.pt"))
    finally:
        P.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
