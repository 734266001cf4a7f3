# -*- coding: utf-8 -*-
"""FDDM-ASR inference CLI on PyTorch (jumpy sampling + greedy decoding).

    python -m fddm_asr_tpu_torch.inference --wav path.wav --ckpt ckpts/ep001.pt \
        --main-config configs/fddm_zhTW_base.yaml \
        --diffusion-config configs/diffusion.yaml \
        --tokenizer data/tokenizer/zh-TW_A/spm_zhTW_A.model \
        --wavlm-ckpt path/to/wavlm-large --T-infer 20 --r 5 --greedy

    python -m fddm_asr_tpu_torch.inference --csv test.csv ... --out-json out.json

    torchrun --nproc_per_node 4 -m fddm_asr_tpu_torch.inference --csv test.csv ... \
        --mesh data=2,model=2 --seq-parallel
    torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.inference --csv test.csv ... \
        --mesh model=2

Counterpart of the repository's `inference.py`: the same flags with the same
defaults and the same result JSON, {wav, text, ids, T_infer, r, greedy,
posterior_mode[, confidence]} a row; a CSV with a reference column (`--ref-
column`, else `text` or `sentence`) adds {ref, cer} to each row and ends
with {"summary": "cer", "avg_cer", "utterances"}; `--chunk-seconds` gives one
result for a long WAV with {chunks, chunk_seconds, chunk_align} and its
confidence the mean of the windows' in log space.  Runs on CUDA; without a GPU it raises unless `--device cpu` is given.
`--gpu` is accepted and ignored.  The sampling generator is seeded by
`--seed` and, as the JAX CLI splits its key, a step generator is split off
it for every CSV batch and every batch of windows.

Several GPUs (one process each, under torchrun or FDDM_COORDINATOR /
FDDM_NUM_PROCESSES / FDDM_PROCESS_ID): `--mesh data=D,model=M` splits each
batch's rows over D ranks (`FDDMPipeline.apply_mesh`; under a mesh a batch's
rows pad to `--batch-size`, as the JAX CLI pads them), and over M ranks
either each utterance's encoder frames (`--seq-parallel`: a long `--wav`
over the ring) or, without it, the weights of the attention heads, the FFNs
and the vocabulary (tensor parallelism, `parallel/tensor.py`).  Every rank
reads the inputs; the primary rank alone prints and writes the results, the
same as one process's.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD
from fddm_asr_tpu_torch.convert import add_encoder_weight_args, load_encoder_weights


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FDDM-ASR inference on PyTorch (jumpy sampling)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--wav", type=str, help="single WAV file")
    src.add_argument("--csv", type=str, help="batch CSV with a `path` column")
    p.add_argument("--ckpt", type=str, required=True,
                   help="reference-format .pt decoder checkpoint")
    add_encoder_weight_args(p)
    p.add_argument("--main-config", type=str, required=True)
    p.add_argument("--diffusion-config", type=str, required=True)
    p.add_argument("--tokenizer", type=str, required=True,
                   help="SentencePiece .model/.vocab path")
    p.add_argument("--T-infer", type=int, default=20)
    p.add_argument("--r", type=int, default=5)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--posterior-mode", type=str, default="average", choices=["average", "max"])
    p.add_argument("--sampling-mode", type=str, default="exact", choices=["exact", "fast"])
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--gpu", type=int, default=None,
                   help="accepted for the reference CLI's sake and ignored; see --device")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) | cpu")
    p.add_argument("--batch-size", type=int, default=8,
                   help="CSV mode: utterances per batch; chunk mode: windows per batch")
    p.add_argument("--chunk-align", choices=["silence", "fixed"], default="silence",
                   help="long-form cuts: 'silence' at the quietest 25 ms frame in each "
                        "window's last second, 'fixed' at the window edges")
    p.add_argument("--chunk-seconds", type=float, default=0.0,
                   help="single-WAV mode: transcribe in windows of this many seconds, "
                        "batched and condition-masked, and join the texts; 0 = whole file")
    p.add_argument("--mesh", type=str, default="",
                   help="multi-GPU inference over the process group, e.g. data=2 or "
                        "data=2,model=2 (one process a GPU: torchrun)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="split each utterance's encoder frames over the mesh's model ranks "
                        "(ring attention)")
    p.add_argument("--corrected-posterior", action="store_true",
                   help="the exact multi-step posterior instead of the reference's "
                        "recurrence (ref_compat=False)")
    p.add_argument("--repeat-penalty", type=float, default=0.0,
                   help="subtract this from each position's log p(x0) of the token the "
                        "previous position decoded to; 0 = plain argmax")
    p.add_argument("--confidence", action="store_true",
                   help="add each utterance's confidence to its result")
    p.add_argument("--num-candidates", type=int, default=1,
                   help="best-of-N: N trajectories per utterance, the most confident kept")
    p.add_argument("--dtype", choices=["config", "bfloat16", "float32"], default="config",
                   help="compute dtype; config honours the YAML's model.dtype")
    p.add_argument("--bucket-seconds", type=float, default=1.0,
                   help="CSV mode, with the condition mask on: pad each batch's audio to a "
                        "multiple of this many seconds and its rows to --batch-size; "
                        "0 disables")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--condition-mask", type=str, default="auto", choices=["auto", "on", "off"],
                   help="mask padded audio frames in cross-attention; auto = on for a "
                        "batched CSV, off for one WAV (reference parity)")
    p.add_argument("--out-json", type=str, default=None)
    p.add_argument("--ref-column", type=str, default=None,
                   help="CSV mode: reference-text column (default: text or sentence, when "
                        "present); adds per-row CER and a summary line")
    p.add_argument("--stats-json", type=str, default=None,
                   help="write the pipeline's build seconds, the transcription's wall "
                        "seconds and each CUDA kernel's launches in it to this file")
    return p.parse_args(argv)


def build_pipeline(args):
    from fddm_asr_tpu_torch.config import load_config, load_yaml
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    main_cfg = load_config(args.main_config)
    diff = load_yaml(args.diffusion_config).get("diffusion", {})
    cfg = main_cfg.updated({"diffusion": {
        "T": diff.get("T", main_cfg.diffusion["T"]),
        "beta_max": diff.get("beta_max", main_cfg.diffusion.get("beta_max", 0.2)),
    }})
    wavlm_sd, encoder_sd = load_encoder_weights(args.wavlm_ckpt, args.encoder_ckpt)
    return FDDMPipeline.from_config(
        cfg, ckpt_path=args.ckpt, wavlm_state_dict=wavlm_sd, encoder_state_dict=encoder_sd,
        tokenizer=load_tokenizer(args.tokenizer), device=args.device,
        dtype=None if args.dtype == "config" else args.dtype)


def sampling_kwargs(args) -> Dict[str, Any]:
    return dict(T_infer=args.T_infer, r=args.r, greedy=args.greedy,
                posterior_mode=args.posterior_mode, sampling_mode=args.sampling_mode,
                ref_compat=not args.corrected_posterior, repeat_penalty=args.repeat_penalty)


def _transcribe(pipeline, batch, lengths, args, generator):
    return pipeline.transcribe_with_ids(
        batch, lengths, seq_len=args.seq_len or 64, generator=generator,
        with_confidence=args.confidence, num_candidates=max(1, int(args.num_candidates)),
        **sampling_kwargs(args))


def _result(path: str, text: str, ids, args) -> Dict[str, Any]:
    return {"wav": path, "text": text, "ids": ids, "T_infer": args.T_infer, "r": args.r,
            "greedy": args.greedy, "posterior_mode": args.posterior_mode}


def infer_batch(pipeline, wav_paths: List[str], args, generator,
                pad_rows_to: int = 0) -> List[Dict[str, Any]]:
    """Transcribe WAVs as one batch, padded to the longest; a file that
    cannot be read gets an error record.  With `--bucket-seconds` and the
    condition mask on, the padded length rounds up to a multiple of the
    bucket and the rows to `pad_rows_to`, with dummy rows of one conv
    receptive field (a shorter one would give no frame and an all-masked
    row); without the mask, appended silence would be conditioning, so the
    batch stays at the longest file."""
    from fddm_asr_tpu_torch.data.audio_io import load_audio

    out: List[Optional[Dict[str, Any]]] = [None] * len(wav_paths)
    waves, ok = [], []
    for i, path in enumerate(wav_paths):
        try:
            waves.append(load_audio(path, target_sr=16000, mono=True)[0])
            ok.append(i)
        except (OSError, ValueError, RuntimeError) as e:
            out[i] = {"wav": path, "error": str(e)}
    if waves:
        lengths = [max(len(w), CONV_RECEPTIVE_FIELD) for w in waves]
        T = max(lengths)
        bucket = int(round(float(args.bucket_seconds or 0) * 16000))
        if bucket > 0 and pipeline.use_condition_mask:
            T = -(-T // bucket) * bucket
        # a fixed row count: the bucket's, and a mesh's data ranks need rows to split
        if (bucket > 0 and pipeline.use_condition_mask) or pipeline.mesh is not None:
            lengths += [CONV_RECEPTIVE_FIELD] * max(0, pad_rows_to - len(waves))
        batch = np.zeros((len(lengths), T), np.float32)
        for j, w in enumerate(waves):
            batch[j, :len(w)] = w
        rows = _transcribe(pipeline, batch, np.asarray(lengths), args, generator)
        for i, row in zip(ok, rows):
            out[i] = _result(wav_paths[i], row[0], row[1], args)
            if len(row) > 2:
                out[i]["confidence"] = round(row[2], 6)
    return out  # type: ignore[return-value]


def chunk_spans(wav: np.ndarray, win: int, align: str) -> List[tuple]:
    """The windows of a long recording: silence-aligned cuts
    (`plan_silence_chunks`) or fixed ones every `win` samples."""
    if align == "silence":
        from fddm_asr_tpu_torch.data.audio_io import plan_silence_chunks

        return plan_silence_chunks(wav, win)
    return [(i * win, min((i + 1) * win, len(wav))) for i in range(max(1, -(-len(wav) // win)))]


def infer_long(pipeline, path: str, args, generator) -> Dict[str, Any]:
    """One long WAV in `--chunk-seconds` windows, `--batch-size` windows a
    batch, each batch [rows, window] with its real lengths masked, and a
    step generator split off `generator` per batch; the window texts are
    joined."""
    from fddm_asr_tpu_torch.data.audio_io import load_audio
    from fddm_asr_tpu_torch.sampler import split_generator

    wav, _ = load_audio(path, target_sr=16000, mono=True)
    win = max(CONV_RECEPTIVE_FIELD, int(args.chunk_seconds * 16000))
    spans = chunk_spans(wav, win, args.chunk_align)
    texts, ids, confs = [], [], []
    bs = max(1, args.batch_size)
    for start in range(0, len(spans), bs):
        rows = spans[start:start + bs]
        batch = np.zeros((_padded_rows(pipeline, len(rows)), win), np.float32)
        for j, (s, e) in enumerate(rows):
            batch[j, :e - s] = wav[s:e]
        lengths = np.asarray([max(e - s, CONV_RECEPTIVE_FIELD) for s, e in rows]
                             + [CONV_RECEPTIVE_FIELD] * (len(batch) - len(rows)))
        for row in _transcribe(pipeline, batch, lengths, args,
                               split_generator(generator))[:len(rows)]:
            texts.append(row[0])
            ids.append(row[1])
            if len(row) > 2:
                confs.append(row[2])
    result = {**_result(path, "".join(texts), ids, args), "chunks": texts,
              "chunk_seconds": args.chunk_seconds, "chunk_align": args.chunk_align}
    if confs:  # per-window geometric means combine as their mean in log space
        result["confidence"] = round(
            float(np.exp(np.mean(np.log(np.maximum(confs, 1e-12))))), 6)
    return result


def _padded_rows(pipeline, n: int) -> int:
    """n rows, rounded up to a multiple of the mesh's data ranks."""
    D = pipeline.mesh.shape["data"] if pipeline.mesh is not None else 1
    return -(-n // D) * D


def read_csv(path: str, ref_column: Optional[str]):
    """(paths, references or None) of a CSV; the reference column is
    `ref_column`, else `text` or `sentence` where present.  Cells are read as
    the strings they are (an empty cell is "")."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        columns = reader.fieldnames or []
    if ref_column is None:
        ref_column = next((c for c in ("text", "sentence") if c in columns), None)
    refs = [row[ref_column] or "" for row in rows] if ref_column else None
    return [row["path"] for row in rows], refs


def transcribe(pipeline, args, emit=lambda record: None) -> List[Dict[str, Any]]:
    """What the CLI does with a built pipeline: sets the condition mask
    from `--condition-mask`, seeds a generator from `--seed`, and
    transcribes the one WAV (whole, or in windows with the mask on) or the
    CSV in `--batch-size` batches, a step generator each, with per-row CER
    where there are references.  `emit` gets each record as it is made, the
    CSV's closing summary included; the records are returned without it."""
    from fddm_asr_tpu_torch.eval import calculate_cer
    from fddm_asr_tpu_torch.sampler import split_generator

    if args.condition_mask == "auto":
        pipeline.use_condition_mask = (pipeline.use_condition_mask
                                       or (bool(args.csv) and args.batch_size > 1))
    else:
        pipeline.use_condition_mask = args.condition_mask == "on"
    generator = torch.Generator(device=pipeline.device).manual_seed(args.seed)
    if args.wav:
        if args.chunk_seconds and args.chunk_seconds > 0:
            pipeline.use_condition_mask = True  # windows are zero-padded batches
            res = infer_long(pipeline, args.wav, args, generator)
        else:
            res = infer_batch(pipeline, [args.wav], args, generator,
                              pad_rows_to=_padded_rows(pipeline, 1))[0]
        emit(res)
        return [res]
    results: List[Dict[str, Any]] = []
    paths, refs = read_csv(args.csv, args.ref_column)
    bs = max(1, args.batch_size)
    cer_sum, cer_n = 0.0, 0
    for start in range(0, len(paths), bs):
        chunk = infer_batch(pipeline, paths[start:start + bs], args,
                            split_generator(generator), pad_rows_to=bs)
        for j, res in enumerate(chunk):
            if refs is not None and "text" in res:
                res["ref"] = refs[start + j]
                res["cer"] = calculate_cer(res["ref"], res["text"])
                cer_sum += res["cer"]
                cer_n += 1
            results.append(res)
            emit(res)
    if cer_n:
        emit({"summary": "cer", "avg_cer": cer_sum / cer_n, "utterances": cer_n})
    return results


def join_mesh(args):
    """The mesh of `--mesh` over the process group (joined here, from
    torchrun's or the FDDM_* environment), `args.device` set to this rank's
    device; None without `--mesh` / `--seq-parallel`."""
    from fddm_asr_tpu_torch import parallel as P

    if not (args.mesh or args.seq_parallel):
        return None
    spec = P.parse_mesh(args.mesh)
    dist_cfg = P.DistributedConfig.from_env()
    P.initialize(dist_cfg, device=args.device)
    dev = dist_cfg.rank_device(args.device)
    args.device = str(dev)
    return P.make_mesh(spec, dev)


def check_seq_parallel(mesh, seq_parallel: bool) -> None:
    """The server's and the export CLI's rule: `--seq-parallel` needs a
    model axis to spread each utterance's frames over."""
    if seq_parallel and mesh.shape["model"] <= 1:
        raise SystemExit("--seq-parallel splits each utterance's encoder frames over the "
                         "mesh's model ranks: give --mesh model=N (N > 1) under torchrun")


def main(argv=None):
    args = parse_args(argv)
    from fddm_asr_tpu_torch import parallel as P

    mesh = join_mesh(args)
    try:
        _main(args, mesh, P.is_primary())
    finally:
        if mesh is not None:
            P.shutdown()


def _main(args, mesh, primary: bool) -> None:
    from fddm_asr_tpu_torch.ops import kernel_wrappers

    t0 = time.time()
    pipeline = build_pipeline(args)
    if mesh is not None:
        pipeline.apply_mesh(mesh, seq_parallel=args.seq_parallel)
    build_s = time.time() - t0
    wrappers = kernel_wrappers()
    for f in wrappers.values():
        f.launches = 0
    indent = 2 if args.wav else None

    def emit(record):
        if primary:
            print(json.dumps(record, ensure_ascii=False, indent=indent))

    t0 = time.time()
    results = transcribe(pipeline, args, emit)
    transcribe_s = time.time() - t0
    if not primary:
        return
    if args.out_json:
        os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
        with open(args.out_json, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
    if args.stats_json:
        with open(args.stats_json, "w", encoding="utf-8") as f:
            json.dump({"build_s": build_s, "transcribe_s": transcribe_s,
                       "launches": {k: w.launches for k, w in wrappers.items()}}, f)


if __name__ == "__main__":
    main()
