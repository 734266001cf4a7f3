# -*- coding: utf-8 -*-
"""AOT deployment artifacts on PyTorch: the fused encode+sample transcribe
step as `torch.export` programs for a grid of (batch, samples) buckets, in
a directory that serves WITHOUT the model code; on CUDA each bucket is
captured at load and replayed as one CUDA graph.

Counterpart of `fddm_asr_tpu/aot.py` (the same names, meta keys and bucket
rules).  Artifact layout (a directory)::

    meta.json               format, bucket and sampling metadata (the JAX
                            meta's keys, plus "program": "torch.export",
                            "torch_version", and for a mesh "seq_parallel",
                            "program_per_model_rank" and "sharded")
    module_n{N}.pt2         `torch.export.save` of the program of every
                            bucket of N samples, its batch dimension dynamic
                            (one trace per N: a trace of WavLM-large and
                            four decoder calls takes tens of seconds); the
                            weights are inputs, so no file holds them
    module_n{N}_model{m}.pt2
                            the same, one a "model" rank, for a mesh with a
                            model axis (the ranks' programs always differ:
                            their vocabulary offsets, the ring's blocks)
    params.npz              the encoder's and decoder's parameters and
                            buffers, `enc/<name>` and `dec/<name>` by their
                            state-dict names, raw bytes a tensor (bfloat16
                            round-trips bit for bit); whole, also for a mesh
    tokenizer/<file>        the tokenizer (+ its .vocab / vocab.json sidecars)

Calling convention (fixed across buckets)::

    program(enc_params, dec_params, x_T int64 [B, seq_len],
            wave [B, N] in the wire dtype, lengths int64 [B][, noise f32 [S, B, seq_len]])
        -> (ids int64 [B, seq_len], p_x0 f32 [B, seq_len, K], conf f32 [B])

x_T is an input, not a seed: the loader draws it as the live sampler does,
`torch.randint(0, K, (B, seq_len))` from `torch.Generator(device)` seeded
with the caller's seed (or from the caller's generator), so at the same
padded batch the program's ids are the live `FDDMPipeline`'s.  A non-greedy
artifact also takes the S steps' uniforms (`sampler.categorical`), drawn
after x_T from the same generator.  `lengths` is read only when the
pipeline was built with `use_condition_mask`.  conf is the decoded-span
confidence, reduced inside the program, so only ids and conf reach the host.

The gated attention, and under `quant_dense: int8_fused` / `fused_frontend`
the fused int8 matmul and conv front-end, are `torch.ops.fddm` nodes of the
program: their Hopper kernels on CUDA, their plain versions on the CPU.  A
program runs on the device type it was exported on ("platforms").

Sharded artifacts.  A pipeline over a mesh (`FDDMPipeline.apply_mesh`,
one process a GPU under torchrun) exports programs of one rank each: a
data rank's rows (the bucket's batch over "data", which must divide it)
and a model rank's weight slices (tensor parallelism) or frames (the
sequence-parallel ring, weights whole).  Their collectives are ops of the
program (`fddm::all_reduce`, `fddm::all_gather`, `fddm::ring_shift`,
`parallel/distributed.py`), keyed by the mesh axis they run over.  The
ranks of data index 0 trace; `meta["mesh"]` is the JAX meta's
{"axis_names": ["data", "model"], "shape": [D, M]}; params.npz holds the
whole weights (`parallel.tensor.gather_state`) and meta the axis of every
sliced one.  The loader joins a process group of D x M ranks (torchrun's
environment; another size raises), rebuilds the mesh, cuts the weights to
its slices once (`tensor.local_state`), draws x_T for the whole padded
batch from the caller's seed as one process does, runs its data rank's
rows and gathers ids and conf over "data".  Every rank makes the same
calls with the same arguments, as over a live mesh.

On CUDA, `ExportedPipeline` runs every bucket's program once (which builds
and loads the kernel libraries), then captures one `torch.cuda.CUDAGraph` a
bucket over static input buffers, all in one memory pool; a call copies its
batch into the bucket's buffers, replays the graph and copies ids and conf
to pinned host memory in stream order, before any other replay can reuse
the pool.  A capture that fails raises, naming the bucket; nothing falls
back to eager execution.  `native` is the set of captured buckets (the
counterpart of the JAX artifact's native executables).  The programs run
eagerly, `native` empty and `eager_reason` saying why, on the CPU and over
a gloo mesh (ranks sharing a card: gloo's collectives run on the host,
where no graph can capture them), decided from the device and the backend
before any call.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD
from fddm_asr_tpu_torch.config import resolve_device
from fddm_asr_tpu_torch.data.wire import decode_wire, encode_wire, silence_value, wire_dtype
from fddm_asr_tpu_torch.eval import batch_confidence, ids_to_text
from fddm_asr_tpu_torch.sampler import SamplerConfig, make_sample_fn, sampling_draws

FORMAT_VERSION = 1
PROGRAM = "torch.export"
_META = "meta.json"
_PARAMS = "params.npz"
_TOKDIR = "tokenizer"
# per-module caches that hold tensors made from the weights: a traced copy
# of a module starts them empty
_CACHES = ("_int8_cache", "_kernel_weight", "_relative_buckets")


# --------------------------------------------------------------------------
# parameters <-> npz (raw bytes a tensor: numpy has no bfloat16)
# --------------------------------------------------------------------------
def module_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A module's parameters and buffers by their state-dict names: what a
    program takes in place of them."""
    return {name: t.detach() for name, t in
            [*module.named_parameters(), *module.named_buffers()]}


def save_params_npz(path: str, enc_params: Dict[str, torch.Tensor],
                    dec_params: Dict[str, torch.Tensor]) -> None:
    flat = {f"enc/{k}": v for k, v in enc_params.items()}
    flat.update({f"dec/{k}": v for k, v in dec_params.items()})
    spec = {k: {"dtype": str(t.dtype).replace("torch.", ""), "shape": list(t.shape)}
            for k, t in flat.items()}
    payload = {k: t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
               for k, t in flat.items()}
    payload["__spec__"] = np.frombuffer(json.dumps(spec).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **payload)


def load_params_npz(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(enc_params, dec_params) as CPU tensors of the dtypes they were saved in."""
    out: Dict[str, Dict[str, torch.Tensor]] = {"enc": {}, "dec": {}}
    with np.load(path) as z:
        spec = json.loads(bytes(z["__spec__"]).decode("utf-8"))
        for name, info in spec.items():
            raw = torch.from_numpy(np.array(z[name], dtype=np.uint8))
            tensor = raw.view(getattr(torch, info["dtype"])).reshape(info["shape"])
            part, key = name.split("/", 1)
            out[part][key] = tensor
    return out["enc"], out["dec"]


# --------------------------------------------------------------------------
# export side
# --------------------------------------------------------------------------
def resolve_sampling(sampling: Dict[str, Any]) -> Dict[str, Any]:
    """Every sampling default the program bakes in, so the meta records
    exactly what it runs (the JAX package's dict)."""
    return {
        "T_infer": int(sampling.get("T_infer", 20)),
        "r": int(sampling.get("r", 5)),
        "greedy": bool(sampling.get("greedy", True)),
        "posterior_mode": sampling.get("posterior_mode", "map"),
        "sampling_mode": sampling.get("sampling_mode", "exact"),
        "temperature": float(sampling.get("temperature", 1.0)),
        "ref_compat": bool(sampling.get("ref_compat", True)),
        "repeat_penalty": float(sampling.get("repeat_penalty", 0.0)),
    }


def _sampler_config(pipeline, sampling: Dict[str, Any]) -> SamplerConfig:
    s = resolve_sampling(sampling)
    return SamplerConfig(K=pipeline.cfg.data.vocab_size, T_train=pipeline.cfg.diffusion["T"],
                         **s)


def _meta_copy(module: nn.Module) -> nn.Module:
    """A copy of `module` whose parameters and buffers live on the meta
    device and whose weight caches are empty: the template a program is
    traced from, with the real weights passed in."""
    memo: Dict[int, Any] = {}
    for t in [*module.parameters(), *module.buffers()]:
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = nn.Parameter(meta, t.requires_grad) if isinstance(t, nn.Parameter) else meta
    shared = (functools.partial, torch.distributed.ProcessGroup)
    for m in module.modules():
        for name in _CACHES:
            if name in vars(m):
                memo[id(vars(m)[name])] = {}
        # a mesh's marks (`parallel/tensor.py`'s Shards, the ring's group and
        # its attention function) hold process groups: shared, not copied
        for name, value in vars(m).items():
            if name.startswith("_tp") or isinstance(value, shared):
                memo[id(value)] = value
    return copy.deepcopy(module, memo)


class TranscribeStep(nn.Module):
    """The fused transcribe step with the artifact's calling convention
    (module docstring).  Holds meta-device copies of the encoder and the
    decoder, not as submodules: the weights come in as the first two inputs
    (`torch.func.functional_call`), so a program traced from this module
    holds none of them."""

    def __init__(self, pipeline, seq_len: int, sampling: Dict[str, Any]):
        super().__init__()
        object.__setattr__(self, "encoder", _meta_copy(pipeline.encoder))
        object.__setattr__(self, "decoder", _meta_copy(pipeline.decoder))
        self.sched = pipeline.sched
        self.scfg = _sampler_config(pipeline, sampling)
        self.seq_len = int(seq_len)
        self.use_condition_mask = bool(pipeline.use_condition_mask)
        self.pad_id = pipeline.pad_id
        self.special_ids = dict(pipeline.special_ids)

    def forward(self, enc_params: Dict[str, torch.Tensor], dec_params: Dict[str, torch.Tensor],
                x_T: torch.Tensor, wave: torch.Tensor, lengths: torch.Tensor,
                noise: Optional[torch.Tensor] = None):
        from torch.func import functional_call

        lengths = lengths if self.use_condition_mask else None
        feats, feat_mask, _ = functional_call(self.encoder, enc_params,
                                              (decode_wire(wave), lengths))
        c_mask = feat_mask if self.use_condition_mask else None

        def decoder_apply(xt, t, c, cm):
            return functional_call(self.decoder, dec_params, (xt, t, c, None, cm))

        sample = make_sample_fn(decoder_apply, self.sched, self.scfg)
        ids, p = sample(feats, self.seq_len, c_mask, x_init=x_T, noise=noise)
        return ids, p, batch_confidence(ids, p, self.pad_id, self.special_ids)


def build_transcribe_fn(pipeline, seq_len: int, sampling: Dict[str, Any],
                        input_encoding: str = "f32") -> TranscribeStep:
    """The fused encode+sample step of a live `FDDMPipeline` as a module
    with the fixed calling convention; `input_encoding` is the wire dtype
    of its wave input (f32, pcm16 or mulaw8, decoded as its first step)."""
    wire_dtype(input_encoding)  # validate
    return TranscribeStep(pipeline, seq_len, sampling)


def _wire_tensor_dtype(encoding: str) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, wire_dtype(encoding))).dtype


def _bucket_inputs(pipeline, step: TranscribeStep, batch: int, num_samples: int,
                   input_encoding: str) -> tuple:
    dev = pipeline.device
    wave = torch.full((batch, num_samples), silence_value(input_encoding),
                      dtype=_wire_tensor_dtype(input_encoding), device=dev)
    args = (module_params(pipeline.encoder), module_params(pipeline.decoder),
            torch.zeros(batch, step.seq_len, dtype=torch.long, device=dev), wave,
            torch.full((batch,), num_samples, dtype=torch.long, device=dev))
    draws = sampling_draws(step.scfg)
    if draws:
        args += (torch.zeros(draws, batch, step.seq_len, device=dev),)
    return args


def _mesh_of(pipeline):
    """The mesh `apply_mesh` spread the pipeline over; None in one process."""
    mesh = getattr(pipeline, "applied_mesh", None)
    return mesh if mesh is not None and mesh.size > 1 else None


def _check_divisible(mesh, batch: int) -> None:
    data = mesh.shape["data"]
    if batch % data:
        raise ValueError(f"bucket batch {batch} must be divisible by the mesh data-axis size "
                         f"{data}")


def export_transcribe(pipeline, batch: int, num_samples: int, seq_len: int,
                      sampling: Dict[str, Any],
                      input_encoding: str = "f32") -> torch.export.ExportedProgram:
    """Trace the program of `num_samples`-sample buckets on the pipeline's
    device, at an example batch of `batch` rows; it takes any batch.  Over a
    mesh it is this rank's program: `batch` (divisible by the data axis)
    over the data ranks, the weights and collectives of this model rank.
    The program keeps neither its example inputs (the weights among them)
    nor the source lines of its nodes."""
    mesh = _mesh_of(pipeline)
    rows = batch
    if mesh is not None:
        _check_divisible(mesh, batch)
        rows = batch // mesh.shape["data"]
    step = build_transcribe_fn(pipeline, seq_len, sampling, input_encoding)
    # the position-bucket table of this length, a constant of the program
    step.encoder.backbone.prepare_position_bias(num_samples, pipeline.device)
    # an example dimension of 1 would be traced as a constant
    args = _bucket_inputs(pipeline, step, max(rows, 2), num_samples, input_encoding)
    rows = torch.export.Dim("batch", min=1, max=4096)
    dynamic = ({k: None for k in args[0]}, {k: None for k in args[1]},
               *({0: rows},) * 3, *(({1: rows},) if len(args) > 5 else ()))
    # the collectives record "data" and "model", this pipeline's mesh's axes
    with torch.no_grad(), (contextlib.nullcontext() if mesh is None else mesh.axes()):
        program = torch.export.export(step, args, dynamic_shapes=dynamic)
    program.example_inputs = None
    for node in program.graph.nodes:
        node.meta.pop("stack_trace", None)
    return program


def _module_file(n: int, model_rank: Optional[int] = None) -> str:
    return f"module_n{n}.pt2" if model_rank is None else f"module_n{n}_model{model_rank}.pt2"


def _per_model_rank(mesh) -> bool:
    """Whether an artifact over `mesh` holds one program a model rank."""
    return mesh is not None and mesh.shape["model"] > 1


def _whole_params(module: nn.Module) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """A module's parameters and buffers whole (its tensor-parallel slices
    gathered over "model": every model rank calls it), and {name: axis} of
    the sliced ones."""
    from fddm_asr_tpu_torch.parallel.tensor import gather_state, is_sharded, sharded_axes

    params = module_params(module)
    if not is_sharded(module):
        return params, {}
    full = gather_state(module)
    return ({k: full.get(k, v) for k, v in params.items()},
            {name: axis for name, (axis, _) in sharded_axes(module).items()})


def save_artifact(pipeline, out_dir: str, buckets: Sequence[Tuple[int, int]], seq_len: int,
                  sampling: Dict[str, Any], tokenizer_path: str,
                  input_encoding: str = "f32") -> Dict[str, Any]:
    """Export every bucket, the parameters and the tokenizer into `out_dir`;
    returns the meta dict.  One program a sample count serves its buckets
    of every batch; it runs on the pipeline's device type ("platforms").

    Over a mesh every rank calls it: the ranks of data index 0 trace their
    programs (one file a duration and model rank), rank 0 writes meta,
    params and the tokenizer, and all meet at a barrier before it returns."""
    from fddm_asr_tpu_torch.parallel.distributed import barrier, broadcast_object, is_primary

    mesh = _mesh_of(pipeline)
    if mesh is not None:
        for b, _ in buckets:
            _check_divisible(mesh, int(b))
    tracer = mesh is None or mesh.data_rank == 0
    os.makedirs(out_dir, exist_ok=True)
    programs: Dict[int, torch.export.ExportedProgram] = {}
    export_seconds = []
    if tracer:
        for n in sorted({int(n) for _, n in buckets}):
            t0 = time.perf_counter()
            batch = max(int(b) for b, m in buckets if m == n)
            programs[n] = export_transcribe(pipeline, batch, n, seq_len, sampling,
                                            input_encoding)
            export_seconds.append([n, time.perf_counter() - t0])
    # with a model axis, one program a model rank: the ranks' programs always
    # differ (their vocabulary offsets, the ring's blocks)
    per_rank = _per_model_rank(mesh)
    for n, program in programs.items():
        torch.export.save(program, os.path.join(
            out_dir, _module_file(n, mesh.model_rank if per_rank else None)))
    if tracer:
        enc, enc_axes = _whole_params(pipeline.encoder)
        dec, dec_axes = _whole_params(pipeline.decoder)
    if mesh is not None and not is_primary():
        barrier()
        return broadcast_object(None)
    save_params_npz(os.path.join(out_dir, _PARAMS), enc, dec)

    tokdir = os.path.join(out_dir, _TOKDIR)
    os.makedirs(tokdir, exist_ok=True)
    tok_file = os.path.basename(tokenizer_path)
    shutil.copy2(tokenizer_path, os.path.join(tokdir, tok_file))
    # sidecars the loader falls back to (.vocab / vocab.json next to .model)
    stem = os.path.splitext(tokenizer_path)[0]
    for side in (stem + ".vocab", os.path.join(os.path.dirname(tokenizer_path), "vocab.json")):
        if os.path.exists(side):
            shutil.copy2(side, os.path.join(tokdir, os.path.basename(side)))

    meta = {
        "format_version": FORMAT_VERSION,
        "program": PROGRAM,
        "torch_version": torch.__version__,
        "jax_version": None,
        "mesh": None if mesh is None else {"axis_names": ["data", "model"],
                                           "shape": [mesh.shape["data"], mesh.shape["model"]]},
        "platforms": [torch.device(pipeline.device).type],
        "seq_len": int(seq_len),
        "sampling": resolve_sampling(sampling),
        "buckets": [[int(b), int(n)] for b, n in sorted(buckets)],
        "vocab_size": int(pipeline.cfg.data.vocab_size),
        "special_ids": {k: (None if v is None else int(v))
                        for k, v in pipeline.special_ids.items()},
        "use_condition_mask": bool(pipeline.use_condition_mask),
        "device_confidence": True,
        "input_encoding": input_encoding,
        "tokenizer_file": tok_file,
        "dynamic_batch": True,
        "export_seconds": export_seconds,  # [samples, seconds] a program (rank 0's)
    }
    if mesh is not None:
        meta.update(seq_parallel=bool(pipeline.seq_parallel), program_per_model_rank=per_rank,
                    sharded={"enc": enc_axes, "dec": dec_axes})
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    if mesh is not None:
        barrier()
        broadcast_object(meta)
    return meta


# --------------------------------------------------------------------------
# serving side: needs NO model code
# --------------------------------------------------------------------------
class _BucketGraph:
    """One bucket's CUDA graph: its static inputs, its static outputs, and
    the kernel launches one replay makes (wrapper -> count)."""

    def __init__(self, graph, inputs: tuple, outputs: tuple, launches: Dict[Any, int]):
        self.graph = graph
        self.inputs = inputs      # (x_T, wave, lengths[, noise])
        self.outputs = outputs    # (ids, p_x0, conf)
        self.launches = launches


def read_meta(path: str) -> Dict[str, Any]:
    """An artifact directory's meta.json."""
    with open(os.path.join(path, _META)) as f:
        return json.load(f)


class ExportedPipeline:
    """Loads an artifact and transcribes.  Buckets are picked as the
    smallest (batch, samples) that fit; waveforms are padded into the
    bucket.  Transcripts depend on the padded batch SHAPE (x_T is drawn per
    padded row), as for the live engine, so the buckets are part of the
    artifact's observable behaviour."""

    def __init__(self, path: str, device: Optional[str] = None):
        self.meta = read_meta(path)
        if self.meta.get("program") != PROGRAM:
            raise ValueError(
                f"{path} is not a torch.export artifact (meta 'program' "
                f"{self.meta.get('program')!r}): a JAX artifact (*.jaxexport) needs the JAX "
                "package; export the model for this package with "
                "`python -m fddm_asr_tpu_torch.export_model`")
        if self.meta["format_version"] > FORMAT_VERSION:
            raise ValueError(f"artifact format {self.meta['format_version']} is newer than "
                             f"this loader ({FORMAT_VERSION})")
        self.mesh = None
        if self.meta.get("mesh"):
            self.mesh = self._join_mesh(self.meta["mesh"], device)  # sets self.device
        else:
            self.device = resolve_device(device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(f"the artifact's programs run on {self.meta['platforms']}, not "
                             f"{self.device.type}: export it on this device type")
        # the kernels' and the collectives' ops must be registered before a
        # program naming them loads
        from fddm_asr_tpu_torch.ops import conv_frontend, flash_attention, quant  # noqa: F401
        from fddm_asr_tpu_torch.parallel import distributed  # noqa: F401

        self.buckets = [tuple(bn) for bn in self.meta["buckets"]]
        model_rank = self.mesh.model_rank if _per_model_rank(self.mesh) else None
        self._programs = {
            n: torch.export.load(os.path.join(path, _module_file(n, model_rank))).module()
            for n in sorted({n for _, n in self.buckets})}
        enc, dec = load_params_npz(os.path.join(path, _PARAMS))
        if self.mesh is not None and self.meta.get("sharded"):
            # this rank's slices of the whole weights, cut once
            from fddm_asr_tpu_torch.parallel.tensor import local_state

            rank, size = self.mesh.model_rank, self.mesh.shape["model"]
            enc = local_state(self.meta["sharded"]["enc"], enc, rank, size)
            dec = local_state(self.meta["sharded"]["dec"], dec, rank, size)
        self.enc_params = {k: v.to(self.device) for k, v in enc.items()}
        self.dec_params = {k: v.to(self.device) for k, v in dec.items()}
        from fddm_asr_tpu_torch.tokenizer import load_tokenizer

        self.tokenizer = load_tokenizer(os.path.join(path, _TOKDIR, self.meta["tokenizer_file"]))
        self.special_ids = self.meta["special_ids"]
        self.pad_id = self.special_ids["pad_id"]
        self.seq_len = int(self.meta["seq_len"])
        self.vocab_size = int(self.meta["vocab_size"])
        self.input_encoding = self.meta.get("input_encoding", "f32")
        self._wire = _wire_tensor_dtype(self.input_encoding)
        s = self.meta["sampling"]
        self.draws = sampling_draws(SamplerConfig(K=self.vocab_size, T_train=1, **s))
        self._lock = threading.Lock()
        self._last = None  # the event of the last queued call (replays run one at a time)
        self.native: Dict[Tuple[int, int], _BucketGraph] = {}
        self.warmup_s = self.capture_s = None
        # why the programs run eagerly (None: every bucket a CUDA graph),
        # decided before any call
        self.eager_reason = None
        if self.mesh is not None and torch.distributed.get_backend() == "gloo":
            self.eager_reason = "gloo: no graph capture"
        elif self.device.type != "cuda":
            self.eager_reason = f"{self.device.type}: no CUDA graphs"
        else:
            self._capture()

    @classmethod
    def load(cls, path: str, device: Optional[str] = None) -> "ExportedPipeline":
        return cls(path, device)

    @property
    def execution(self) -> str:
        return "eager" if self.eager_reason else "cuda graphs"

    def _join_mesh(self, mesh_meta: Dict[str, Any], device: Optional[str]):
        """A sharded artifact's mesh: the process group joined (torchrun's or
        the FDDM_* environment; a no-op once joined), this rank's device,
        and the mesh over the group, which must hold data x model ranks."""
        from fddm_asr_tpu_torch import parallel as P

        if list(mesh_meta["axis_names"]) != ["data", "model"]:
            raise ValueError(f"mesh axes {mesh_meta['axis_names']}: this loader knows "
                             "('data', 'model')")
        data, model = (int(x) for x in mesh_meta["shape"])
        dist_cfg = P.DistributedConfig.from_env()
        P.initialize(dist_cfg, device=device or "cuda")
        self.device = dist_cfg.rank_device(device or "cuda")
        return P.make_mesh(P.MeshSpec(data=data, model=model), self.device)

    def _static_inputs(self, b: int, n: int) -> tuple:
        """Fresh inputs of a (b, n) bucket: this data rank's rows of it."""
        dev = self.device
        b //= 1 if self.mesh is None else self.mesh.shape["data"]
        inputs = (torch.zeros(b, self.seq_len, dtype=torch.long, device=dev),
                  torch.full((b, n), silence_value(self.input_encoding), dtype=self._wire,
                             device=dev),
                  torch.full((b,), n, dtype=torch.long, device=dev))
        if self.draws:
            inputs += (torch.zeros(self.draws, b, self.seq_len, device=dev),)
        return inputs

    def _call(self, bucket, inputs: tuple):
        """Run a bucket's program; its collectives over this artifact's mesh,
        whatever mesh the process made after loading it."""
        x_T, wave, lengths, *noise = inputs
        with contextlib.nullcontext() if self.mesh is None else self.mesh.axes():
            return self._programs[bucket[1]](self.enc_params, self.dec_params, x_T, wave,
                                             lengths, *noise)

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of `x`, in global batch order."""
        if self.mesh is None or self.mesh.shape["data"] == 1:
            return x
        from fddm_asr_tpu_torch.parallel.distributed import all_gather

        return all_gather(x, self.mesh.data_group)

    def _capture(self) -> None:
        """Run each bucket once on a side stream (kernel libraries built and
        loaded, workspaces set up), then capture one graph a bucket into
        one shared pool (replays never overlap).  The kernel launches a
        capture records are counted when a replay makes them."""
        from fddm_asr_tpu_torch.ops import kernel_wrappers

        wrappers = list(kernel_wrappers().values())
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        inputs = {bn: self._static_inputs(*bn) for bn in self.buckets}
        t0 = time.perf_counter()
        with torch.cuda.device(self.device), torch.cuda.stream(stream), torch.inference_mode():
            for bn in self.buckets:
                self._call(bn, inputs[bn])
        stream.synchronize()
        self.warmup_s = time.perf_counter() - t0
        pool = torch.cuda.graph_pool_handle()
        self.capture_s = {}
        for bn in self.buckets:
            t0 = time.perf_counter()
            before = [w.launches for w in wrappers]
            # the captured graph is kept beside its executable, so that its
            # kernel nodes can be listed (`CUDAGraph.debug_dump`)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.device(self.device), torch.inference_mode(), \
                        torch.cuda.graph(graph, pool=pool, stream=stream):
                    outputs = self._call(bn, inputs[bn])
                graph.instantiate()
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture failed for bucket (batch {bn[0]}, "
                                   f"samples {bn[1]}): {e}") from e
            launches = {}
            for w, n in zip(wrappers, before):
                if w.launches != n:  # recorded into the graph, not launched
                    launches[w] = w.launches - n
                    w.launches = n
            self.native[bn] = _BucketGraph(graph, inputs[bn], tuple(outputs), launches)
            self.capture_s[bn] = time.perf_counter() - t0

    # ------------------------------------------------------------- buckets
    def pick_bucket(self, rows: int, samples: int) -> Tuple[int, int]:
        fits = [(b, n) for b, n in self.buckets if b >= rows and n >= samples]
        if not fits:
            raise ValueError(f"no exported bucket fits batch={rows} samples={samples}; "
                             f"available: {sorted(self.buckets)}")
        return min(fits, key=lambda bn: (bn[1], bn[0]))

    # ----------------------------------------------------------------- api
    def transcribe_with_ids(self, wave, lengths=None, seed: int = 0,
                            with_confidence: bool = False,
                            generator: Optional[torch.Generator] = None) -> List[tuple]:
        return self.transcribe_with_ids_async(wave, lengths, seed=seed,
                                              with_confidence=with_confidence,
                                              generator=generator)()

    def _wire_input(self, wave):
        """`wave` [rows, samples] (or one row) in the wire dtype: a tensor
        already in it stays where it is; anything else is encoded on the
        host (lossless for 16-bit PCM sources under pcm16)."""
        if torch.is_tensor(wave) and wave.dtype == self._wire:
            return wave if wave.dim() == 2 else wave[None]
        wave = np.asarray(wave.cpu() if torch.is_tensor(wave) else wave)
        if wave.dtype != wire_dtype(self.input_encoding):
            wave = encode_wire(np.asarray(wave, np.float32), self.input_encoding)
        wave = torch.from_numpy(np.ascontiguousarray(wave if wave.ndim == 2 else wave[None]))
        return wave.pin_memory() if self.device.type == "cuda" else wave

    def transcribe_with_ids_async(self, wave, lengths=None, seed: int = 0,
                                  with_confidence: bool = False,
                                  generator: Optional[torch.Generator] = None
                                  ) -> Callable[[], List[tuple]]:
        """Queue one call and return a `finalize()` that waits for it and
        builds [(text, ids[, confidence])] a row.  x_T (and a non-greedy
        artifact's uniforms) are drawn from `generator`, else from a
        generator on the device seeded with `seed`, at the bucket's batch.
        Over a mesh every rank makes the call with the same arguments and
        runs its data rank's rows of the bucket; each gets every row."""
        wave = self._wire_input(wave)
        rows, samples = wave.shape
        b, n = self.pick_bucket(rows, samples)
        # this data rank's rows of the bucket: [lo, lo + local), `mine` of them the caller's
        local = b if self.mesh is None else b // self.mesh.shape["data"]
        lo = 0 if self.mesh is None else self.mesh.data_rank * local
        mine = max(0, min(rows, lo + local) - lo)
        # one conv receptive field at least (fewer samples give no encoder
        # frame, whose all-masked attention row would reach the decoder);
        # the bucket's pad rows get the same floor
        floor = min(CONV_RECEPTIVE_FIELD, n)
        if lengths is None:
            lengths = torch.full((rows,), samples, dtype=torch.long)
        elif not torch.is_tensor(lengths):
            lengths = torch.as_tensor(np.asarray(lengths, np.int64))
        lengths = lengths.clamp(min=floor)
        if self.device.type == "cuda" and lengths.device.type == "cpu":
            lengths = lengths.pin_memory()  # a pageable copy would wait for the stream
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with self._lock:
            stream = torch.cuda.current_stream(self.device) if self.native else None
            if stream is not None and self._last is not None:
                stream.wait_event(self._last)
            x_T = torch.randint(0, self.vocab_size, (b, self.seq_len), generator=generator,
                                device=self.device)
            noise = [torch.rand((b, self.seq_len), generator=generator, device=self.device)
                     for _ in range(self.draws)]
            graph = self.native.get((b, n))
            inputs = graph.inputs if graph is not None else self._static_inputs(b, n)
            static_x, static_wave, static_len, *static_noise = inputs
            static_x.copy_(x_T[lo:lo + local])
            if noise:
                static_noise[0].copy_(torch.stack(noise)[:, lo:lo + local])
            static_wave.fill_(silence_value(self.input_encoding))
            static_wave[:mine, :samples].copy_(wave[lo:lo + mine], non_blocking=True)
            static_len.fill_(floor)
            static_len[:mine].copy_(lengths[lo:lo + mine], non_blocking=True)
            if graph is None:
                with torch.inference_mode():
                    ids, _p, conf = self._call((b, n), inputs)
                    ids, conf = self._gathered(ids), self._gathered(conf)
                done = None
            else:
                graph.graph.replay()
                for w, count in graph.launches.items():
                    w.launches += count
                with torch.inference_mode():
                    out_ids, out_conf = (self._gathered(graph.outputs[0]),
                                         self._gathered(graph.outputs[2]))
                # out of the pool before the next replay can reuse it
                ids = torch.empty((b, self.seq_len), dtype=torch.long, pin_memory=True)
                conf = torch.empty((b,), dtype=torch.float32, pin_memory=True)
                ids.copy_(out_ids, non_blocking=True)
                conf.copy_(out_conf, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
                self._last = done

        def finalize() -> List[tuple]:
            if done is not None:
                done.synchronize()
            ids_np = ids[:rows].cpu().numpy()
            conf_np = conf[:rows].cpu().numpy()
            out = []
            for i, row in enumerate(ids_np):
                entry = (ids_to_text(row, self.tokenizer, self.pad_id,
                                     self.special_ids.get("bos_id"),
                                     self.special_ids.get("eos_id")), row.tolist())
                if with_confidence:
                    entry = entry + (float(conf_np[i]),)
                out.append(entry)
            return out

        return finalize

    def transcribe(self, wave, lengths=None, seed: int = 0) -> List[str]:
        return [t for t, _ in self.transcribe_with_ids(wave, lengths, seed=seed)]
