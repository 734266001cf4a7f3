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
  tp2   2 ranks, mesh model=2, tensor parallel: the step and a LoRA step
        (gradients and parameters gathered whole), `apply_mesh` ids in float32
        and int8, a training run, its checkpoint's ids, and its resume
  tp4   4 ranks, mesh data=2 x model=2, tensor parallel: the step and the ids
  aot_m2  2 ranks: `export_model.main --mesh model=2`, then with
        `--seq-parallel`, each artifact loaded in these ranks and its rows
        at DIR/aot_mesh.json's calls; the first call's rows again once a
        data=2 mesh has been made
  aot_d2m2  4 ranks: `export_model.main --mesh data=2,model=2`
  aot_fresh  4 ranks that import no model code: the data=2 x model=2
        artifact loaded once written, its rows at the calls; then it is
        served by `serve.main` on every rank (rank 0 serving, the others
        following) for DIR/aot_mesh.json's uploads
  aot_cuda  2 ranks sharing the card over gloo (FDDM_DEVICE, FDDM_BACKEND): a
        small pipeline at model=2 exported, loaded and run, with B1's launches
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


def step_case(root: str, mesh, inputs: str = "step_inputs.pt", tensor: bool = False) -> dict:
    """The fine-tune step of DIR/`inputs` on this rank's rows: sequence
    parallel over "model", or with `tensor` tensor parallel (its gradients,
    reduced, and its parameters after the step gathered whole).  A config
    with model.encoder.lora_rank takes the LoRA step."""
    from fddm_asr_tpu_torch import train_lib as TL
    from fddm_asr_tpu_torch.checkpoint import _by_name
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline

    spec = torch.load(os.path.join(root, inputs))
    cfg = Config(spec["cfg"])

    class Tok:
        def encode(self, text):
            return [5, 6, 7]

    pipe = FDDMPipeline.from_config(cfg, tokenizer=Tok(), device="cpu")
    pipe.decoder.load_state_dict(spec["decoder"])
    pipe.encoder.load_state_dict(spec["encoder"])
    if tensor:
        pipe.enable_tensor_parallel(mesh)
    else:
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
    with step.merged(state):
        loss, _ = step.forward(state, wave, x0, True, **draws)
        loss.backward()
    local = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for p in state.optimizer.params]
    grads = state.optimizer.reduce([g.clone() for g in local])
    metrics = step(state, wave, x0, True, **draws)
    # more steps on the same batch (a LoRA run's second reads B != 0)
    after = [{k: float(v) for k, v in step(state, wave, x0, True, **draws).items()}
             for _ in range(spec.get("more_steps", 0))]
    params = [p.detach().clone() for p in state.optimizer.params]
    if tensor:  # every tensor whole, as one process holds it
        full = _by_name(state, full=True)
        names = state.param_names()
        grads = [full(k, n, g) for (k, n), g in zip(names, grads)]
        params = [full(k, n, p) for (k, n), p in zip(names, params)]
    return {"local_grads": local, "grads": grads, "n_main": len(state.optimizer.groups[0][0]),
            "metrics": {k: float(v) for k, v in metrics.items()}, "metrics_after": after,
            "params": params}


def run_case(root: str, mesh, name: str, export_pt: bool = False) -> dict:
    """`train_lib.run_training` of DIR/<name>.json's config on `mesh`."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.train_lib import run_training

    with open(os.path.join(root, f"{name}.json"), encoding="utf-8") as f:
        raw = json.load(f)
    summary = run_training(Config(raw), raw_cfg=raw, export_pt=export_pt, device="cpu",
                           mesh=mesh)
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


def tp_infer_case(root: str, mesh) -> dict:
    """`apply_mesh` (tensor parallel) ids of DIR/tp_infer.pt's pipeline at
    its injected x_init, in float32 and under int8."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline

    from fddm_asr_tpu_torch.parallel.tensor import gather_state, local_state

    spec = torch.load(os.path.join(root, "tp_infer.pt"))
    out = {}
    for name, cfg in spec["cfgs"].items():
        pipe = FDDMPipeline.from_config(Config(cfg), ckpt_path=spec["ckpt"], tokenizer=_Chars(),
                                        wavlm_state_dict=spec["wavlm"], device="cpu")
        whole = {m: {k: v.clone() for k, v in getattr(pipe, m).state_dict().items()}
                 for m in ("decoder", "encoder")}
        pipe.apply_mesh(mesh)
        # gather_state(shard_module(m)) is m's state, bit for bit; local_state cuts it back
        out[f"{name}_round_trip"] = all(
            set(gathered) == set(whole[m]) and all(torch.equal(gathered[k], whole[m][k])
                                                   for k in gathered)
            and all(torch.equal(v, getattr(pipe, m).state_dict()[k])
                    for k, v in local_state(getattr(pipe, m), whole[m]).items())
            for m, gathered in ((m, gather_state(getattr(pipe, m))) for m in whole))
        rows = pipe.transcribe_with_ids(spec["wave"].numpy(), seq_len=spec["x_init"].shape[1],
                                        x_init=spec["x_init"], T_infer=4, r=2, greedy=True)
        out[name] = [r[1] for r in rows]
    return out


class _Chars:
    def DecodeIds(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


def tp_run_case(root: str, mesh) -> dict:
    """A tensor-parallel `run_training` of DIR/run_tp.json; the ids of its
    ep001 checkpoint (decoder .pt and .encoder.pt) loaded into a
    tensor-parallel pipeline; then `--resume ep001.state.pt` for a second
    epoch."""
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.train_lib import run_training

    out = {"run": run_case(root, mesh, "run_tp", export_pt=True)}
    with open(os.path.join(root, "run_tp.json"), encoding="utf-8") as f:
        raw = json.load(f)
    ckpt = raw["log"]["ckpt_dir"]
    spec = torch.load(os.path.join(root, "tp_infer.pt"))
    pipe = FDDMPipeline.from_config(
        Config(raw), ckpt_path=os.path.join(ckpt, "ep001.pt"), tokenizer=_Chars(),
        encoder_state_dict=torch.load(os.path.join(ckpt, "ep001.encoder.pt")), device="cpu")
    pipe.apply_mesh(mesh)
    rows = pipe.transcribe_with_ids(spec["wave"].numpy(), seq_len=spec["x_init"].shape[1],
                                    x_init=spec["x_init"], T_infer=4, r=2, greedy=True)
    out["ckpt_ids"] = [r[1] for r in rows]
    raw["optim"]["num_epochs"] = 2
    resumed = run_training(Config(raw), raw_cfg=raw, export_pt=False, device="cpu", mesh=mesh,
                           resume=os.path.join(ckpt, "ep001.state.pt"))
    out["resumed"] = {k: resumed[k] for k in ("train_loss", "epoch") if k in resumed}
    return out


def _exported_rows(ep, calls) -> list:
    """[(ids, conf) a row] of each call (wave .npy, lengths, seed) of `ep`."""
    import numpy as np

    return [[(ids, conf) for _, ids, conf in ep.transcribe_with_ids(
        np.load(wave), np.asarray(lengths), seed=seed, with_confidence=True)]
        for wave, lengths, seed in calls]


def aot_m2_case(root: str) -> dict:
    """The model=2 artifacts, tensor parallel and on the ring, exported by
    the CLI in these ranks and loaded here."""
    from fddm_asr_tpu_torch import export_model
    from fddm_asr_tpu_torch.aot import ExportedPipeline

    with open(os.path.join(root, "aot_mesh.json")) as f:
        spec = json.load(f)
    out, loaded = {}, {}
    for name, flags in (("tp", ["--mesh", "model=2"]),
                        ("ring", ["--mesh", "model=2", "--seq-parallel"])):
        art = os.path.join(root, f"art_{name}")
        export_model.main([*spec["cli"], "--out", art, *flags])
        ep = loaded[name] = ExportedPipeline.load(art, device="cpu")
        out[name] = {"rows": _exported_rows(ep, spec["calls"]), "execution": ep.execution,
                     "eager_reason": ep.eager_reason, "native": len(ep.native)}
    # a mesh made after a load, whose "model" groups are of one rank each: the
    # loaded program's collectives stay on the artifact's mesh
    P.make_mesh(P.MeshSpec(data=2))
    out["tp"]["rows_after_another_mesh"] = _exported_rows(loaded["tp"], spec["calls"][:1])
    return out


def aot_d2m2_case(root: str, rank: int) -> dict:
    """The data=2 x model=2 artifact exported by the CLI; rank 0 marks it
    done (DIR/art_d2m2.done) once every rank's program is written."""
    from fddm_asr_tpu_torch import export_model

    with open(os.path.join(root, "aot_mesh.json")) as f:
        spec = json.load(f)
    art = os.path.join(root, "art_d2m2")
    export_model.main([*spec["cli"], "--out", art, "--mesh", "data=2,model=2"])
    if rank == 0:
        with open(art + ".done", "w"):
            pass
    return {}


def aot_fresh_case(root: str, rank: int) -> dict:
    """The data=2 x model=2 artifact, once `aot_d2m2` has written it, loaded
    in ranks whose imports of model code (and of JAX) raise, and its rows at
    the calls; then served by the entry point on every rank (`serve.main
    --exported` on the loaded artifact, rank 0 serving, the others following
    its dispatches): rank 0's server, kept from its `_serve`, takes the
    uploads one at a time and its `/healthz` is read, then it is shut down,
    which sends the stop op to the other ranks."""
    import builtins
    import threading
    import time
    import urllib.request

    import numpy as np

    real_import = builtins.__import__

    def guard(name, *a, **k):
        if name.startswith(("fddm_asr_tpu_torch.models", "jax", "fddm_asr_tpu.")):
            raise ImportError(f"model code imported at serving time: {name}")
        return real_import(name, *a, **k)

    builtins.__import__ = guard
    from fddm_asr_tpu_torch import aot

    with open(os.path.join(root, "aot_mesh.json")) as f:
        spec = json.load(f)
    art = os.path.join(root, "art_d2m2")
    t0 = time.time()
    while not os.path.exists(art + ".done"):
        if time.time() - t0 > 240:
            raise TimeoutError(f"{art} was not written")
        time.sleep(0.1)
    ep = aot.ExportedPipeline.load(art, device="cpu")
    out = {"rows": _exported_rows(ep, spec["calls"]),
           "models_imported": [m for m in sys.modules
                               if m.startswith("fddm_asr_tpu_torch.models")],
           "mesh": dict(ep.mesh.shape)}
    builtins.__import__ = real_import  # the server's module imports model code

    from fddm_asr_tpu_torch import serve as S

    aot.ExportedPipeline.load = staticmethod(lambda path, device=None: ep)  # loaded once
    argv = ["--exported", art, "--device", "cpu", "--port", "0", "--max-wait-ms", "5"]
    if rank != 0:
        S.main(argv)
        return out
    servers = []
    serve = S._serve
    S._serve = lambda server, host: servers.append(server) or serve(server, host)
    thread = threading.Thread(target=S.main, args=(argv,), daemon=True)
    thread.start()
    while not servers:
        if not thread.is_alive():
            raise RuntimeError("serve.main returned before serving")
        thread.join(timeout=0.05)
    srv = servers[0]
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=60) as r:
            health = json.loads(r.read())
        engine = srv.engine
        served = [engine.submit(np.load(path), f"u{i}") for i, path in enumerate(spec["uploads"])]
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    out.update(batch_multiple=engine.batch_multiple, max_batch=engine.max_batch, health=health,
               served=[r["ids"] for r in served], stopped=not thread.is_alive())
    return out


def aot_cuda_case(root: str, device: torch.device) -> dict:
    """A small float32 pipeline (64-wide WavLM heads, so attention takes
    B1) at model=2 on the card: exported, loaded (eager over gloo) and run
    at the seed of DIR/aot_cuda.json, B1's launches a call."""
    import numpy as np

    from fddm_asr_tpu_torch import aot
    from fddm_asr_tpu_torch.config import Config
    from fddm_asr_tpu_torch.ops import flash_attention as FA
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline

    with open(os.path.join(root, "aot_cuda.json")) as f:
        spec = json.load(f)
    pipe = FDDMPipeline.from_config(Config(spec["cfg"]), tokenizer=_Chars(), device=device)
    pipe.apply_mesh(P.make_mesh(P.MeshSpec(data=1, model=2), device))
    art = os.path.join(root, "art_cuda")
    aot.save_artifact(pipe, art, [tuple(b) for b in spec["buckets"]], spec["seq_len"],
                      spec["sampling"], spec["tokenizer"])
    ep = aot.ExportedPipeline.load(art, device=str(device))
    before = FA.wavlm_gated_attention_cuda.launches
    rows = ep.transcribe_with_ids(np.load(spec["wave"]), seed=spec["seed"])
    return {"ids": [ids for _, ids in rows], "execution": ep.execution,
            "eager_reason": ep.eager_reason,
            "b1_launches": FA.wavlm_gated_attention_cuda.launches - before}


def main() -> int:
    case, root = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    device = "cuda" if case in ("ring_cuda", "aot_cuda") else "cpu"
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
        elif case in ("tp2", "tp4"):
            mesh = P.make_mesh(P.MeshSpec(data=world // 2, model=2))
            out = {"step": step_case(root, mesh, "tp_step_inputs.pt", tensor=True),
                   "infer": tp_infer_case(root, mesh)}
            if case == "tp2":
                out["lora"] = step_case(root, mesh, "tp_lora_inputs.pt", tensor=True)
                out.update(tp_run_case(root, mesh))
        elif case == "aot_m2":
            out = aot_m2_case(root)
        elif case == "aot_d2m2":
            out = aot_d2m2_case(root, rank)
        elif case == "aot_fresh":
            out = aot_fresh_case(root, rank)
        elif case == "aot_cuda":
            out = aot_cuda_case(root, dist_cfg.rank_device(device))
        else:
            raise ValueError(f"unknown case {case!r}")
        torch.save(out, os.path.join(root, f"{case}.rank{rank}.pt"))
    finally:
        P.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
