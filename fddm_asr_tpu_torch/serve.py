# -*- coding: utf-8 -*-
"""Batching HTTP inference server on PyTorch.

    python -m fddm_asr_tpu_torch.serve --config configs/fddm_zhTW_base.yaml \
        --ckpt ckpts/best_model.pt --tokenizer spm.model \
        [--encoder-ckpt ckpts/best_model.encoder.pt] [--wavlm-ckpt DIR] \
        [--port 8080] [--max-batch 16] [--max-wait-ms 20] [--device cpu]

Counterpart of the repository's `serve.py` (its live-pipeline half): the
same classes, endpoints, flags and result JSON.  HTTP threads enqueue
requests; one background thread owns the device, gathers requests into
batches padded to power-of-two batch sizes and whole duration buckets,
windows long recordings at silences (`plan_silence_chunks`), and keeps up to
`--pipeline-depth` batches in flight over
`FDDMPipeline.transcribe_with_ids_async`.

Endpoints:
  POST /v1/transcribe   body = WAV bytes, or JSON {"path": "/abs/file.wav"}
                        (WAV, or MP3/MP2 through libmpg123 or ffmpeg);
                        ?stream=1 streams NDJSON over chunked transfer, one
                        line per long-form window, then the aggregate.
  POST /v1/transcribe/stream
                        raw pcm16/f32 audio pushed chunked or fixed-length;
                        NDJSON partial transcripts flow back while later
                        audio still uploads.  ?format=pcm16|f32,
                        ?window-seconds=<float>.
  GET  /healthz         liveness and the served configuration
  GET  /stats           request counts, latency percentiles, batch sizes,
                        audio seconds served, RTFx, mean stage times

Batch n samples its x_T from `torch.Generator(device).manual_seed(n)`, a
fresh generator a batch; warm-up samples with seed 0 and leaves the counter
alone, so a warmed server and a cold one give the same transcripts at the
same counter.  On CUDA the padded batch and its lengths go to the device
from pinned host buffers with non-blocking copies, so dispatching batch
n + 1 does not wait for batch n.  Runs on CUDA; without a GPU it raises
unless `--device cpu` is given.  `--exported DIR` serves an AOT artifact
(`aot.py`, from `python -m fddm_asr_tpu_torch.export_model`) instead of the
live pipeline: its buckets, sampling, wire dtype and weights come from the
artifact (so `--wavlm-ckpt` / `--encoder-ckpt` beside it raise), and on CUDA
every bucket is a CUDA graph replay.  The live pipeline's encoder weights
load as the inference CLI loads them (`convert.load_encoder_weights`): a
fine-tuned model is `{prefix}.pt` with `--encoder-ckpt {prefix}.encoder.pt`.

Over a mesh (`--mesh data=D,model=M [--seq-parallel]`, one process a GPU
under torchrun): every rank builds the pipeline over the mesh
(`FDDMPipeline.apply_mesh`); rank 0 alone serves HTTP and runs the engine,
whose batch buckets round up to a multiple of D (`--max-batch` must be
one), and each dispatch sends its header, wave and lengths to the others
(`MeshDispatch`), which make the same call (`follow`).  A failed batch
fails the server; stopping rank 0 (SIGINT) sends the stop op.  A sharded
`--exported` artifact (`export_model --mesh`) is served the same way: its
meta names the mesh (so `--mesh` beside `--exported` raises), every rank
loads it (`aot.ExportedPipeline`, a process group of data x model ranks),
and the engine's batch buckets round up to the artifact's data axis.  Over
gloo (ranks sharing a card) its programs run eagerly, which `/healthz`
reports; over NCCL, one card a rank, each bucket is a CUDA graph.

    torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.serve --config C.yaml \
        --ckpt D.pt --tokenizer T.vocab --mesh model=2
    torchrun --nproc_per_node 2 -m fddm_asr_tpu_torch.serve --exported ART
"""
from __future__ import annotations

import argparse
import collections
import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from fddm_asr_tpu_torch import CONV_RECEPTIVE_FIELD
from fddm_asr_tpu_torch.convert import add_encoder_weight_args
from fddm_asr_tpu_torch.data.audio_io import (load_audio, load_wav, plan_silence_chunks,
                                              resample, silence_cut)
from fddm_asr_tpu_torch.data.wire import encode_wire, silence_value, wire_dtype

class FDDMHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursty clients:
    socketserver's default of 5 resets the connections of a burst of more
    simultaneous connects before accept() sees them."""

    request_queue_size = 128


class _Request:
    __slots__ = ("wave", "name", "done", "result", "t_enqueue")

    def __init__(self, wave: np.ndarray, name: str):
        self.wave = wave
        self.name = name
        self.done = threading.Event()
        self.result = None
        self.t_enqueue = time.perf_counter()


def _engine_device(pipeline) -> torch.device:
    """The pipeline's device, with its CUDA index fixed in the calling
    thread (the engine's thread must select the same card)."""
    dev = torch.device(pipeline.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class BatchingEngine:
    """Gathers requests into bucketed device batches and transcribes them.

    One background thread owns the device; HTTP threads only enqueue and
    wait."""

    def __init__(self, pipeline, sampling: dict, seq_len: int,
                 max_batch: int = 16, max_wait_ms: float = 20.0,
                 bucket_seconds: float = 1.0, max_seconds: float = 30.0,
                 request_timeout_s: float = 600.0, pipeline_depth: int = 2,
                 batch_multiple: int = 1, on_fatal=None):
        self.pipeline = pipeline
        self.request_timeout_s = request_timeout_s
        self.sampling = sampling
        self.seq_len = seq_len
        self.max_batch = max_batch
        # a mesh's data axis: batch buckets round up to a multiple of it, so a
        # batch's rows split evenly over the data ranks
        self.batch_multiple = max(1, int(batch_multiple))
        if max_batch % self.batch_multiple:
            raise ValueError(f"--max-batch {max_batch} must be a multiple of the mesh "
                             f"data-axis size {self.batch_multiple}")
        # on_fatal(error): a failed batch fails the server (over a mesh, where
        # the ranks' collectives cannot carry on past it); None isolates it
        self.on_fatal = on_fatal
        self.fatal_error: Optional[BaseException] = None
        self.max_wait_s = max_wait_ms / 1e3
        # batches in flight at once (>= 1): while the oldest is copied back,
        # decoded and answered, younger ones keep the device busy
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.bucket = int(bucket_seconds * 16000)
        self.max_samples = int(max_seconds * 16000)
        self.device = _engine_device(pipeline)
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.stats_lock = threading.Lock()
        self.stats = {
            "requests": 0, "errors": 0, "batches": 0,
            "audio_seconds": 0.0, "device_seconds": 0.0,
            "batch_size_sum": 0,
            # per-batch stage sums (s): pad + host-to-device copy, the
            # dispatch call, the wait for results, decode + respond
            "t_pad": 0.0, "t_dispatch": 0.0, "t_wait": 0.0, "t_respond": 0.0,
            "latencies_ms": collections.deque(maxlen=1000),  # the most recent window
        }
        self._stop = threading.Event()
        self._rng_counter = 0
        # (Bp, T) shapes dispatched at least once; a batch of another shape
        # answers everything in flight before it is dispatched (see _loop)
        self._warm_shapes: set = set()
        # end of the last finalized window: device_seconds is the union of
        # in-flight windows, not their overlapping sum
        self._busy_until = 0.0
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _bucket_batch_size(self, n: int) -> int:
        """Padded batch size for n queued requests: the next power of two,
        rounded up to a multiple of batch_multiple, capped at max_batch (a
        multiple of it)."""
        pow2 = 1 << max(0, (n - 1).bit_length())
        bm = self.batch_multiple
        return min(self.max_batch, -(-max(pow2, bm) // bm) * bm)

    # ------------------------------------------------------------------ api
    def _plan_requests(self, wave: np.ndarray, name: str) -> List[_Request]:
        """Split audio longer than max_samples into windows cut at the
        quietest 25 ms frame near each edge; they batch with other traffic."""
        wave = np.asarray(wave, np.float32)
        if len(wave) <= self.max_samples:
            chunks = [wave]
        else:
            chunks = [wave[s:e] for s, e in plan_silence_chunks(wave, self.max_samples)]
        return [_Request(self._to_wire(c), name if len(chunks) == 1 else f"{name}#chunk{i}")
                for i, c in enumerate(chunks)]

    def _to_wire(self, wave: np.ndarray) -> np.ndarray:
        """Float audio in the pipeline's wire dtype, encoded as the request
        arrives (in its HTTP thread, not in the engine's loop)."""
        enc = self.pipeline.input_encoding
        return wave if enc == "f32" else encode_wire(wave, enc)

    def _enqueue(self, reqs: List[_Request]) -> None:
        for r in reqs:
            self.q.put(r)
        if self._stop.is_set():
            # raced with shutdown(), whose one drain may have passed
            for r in reqs:
                if not r.done.is_set():
                    r.result = {"wav": r.name, "error": "server shutting down"}
                    r.done.set()

    def _aggregate(self, name: str, results: List[dict],
                   window_samples: Optional[int] = None) -> dict:
        errs = [r for r in results if "error" in r]
        if errs:
            return {"wav": name, "error": errs[0]["error"]}
        if len(results) == 1:
            return results[0]
        first = results[0]
        # the window actually used: a StreamingSession may commit smaller ones
        win = self.max_samples if window_samples is None else window_samples
        return {
            "wav": name,
            "text": "".join(r["text"] for r in results),
            "chunks": [r["text"] for r in results],
            "ids": [r["ids"] for r in results],
            "chunk_seconds": win / 16000.0,
            "T_infer": first["T_infer"], "r": first["r"],
            "greedy": first["greedy"],
            "posterior_mode": first["posterior_mode"],
        }

    def submit(self, wave: np.ndarray, name: str,
               timeout_s: Optional[float] = None) -> dict:
        """Transcribe one utterance (blocking); long audio is windowed and
        the window texts joined."""
        timeout_s = self.request_timeout_s if timeout_s is None else timeout_s
        if self._stop.is_set():
            return {"wav": name, "error": "server shutting down"}
        reqs = self._plan_requests(wave, name)
        self._enqueue(reqs)
        for r in reqs:
            if not r.done.wait(timeout=timeout_s):
                return {"wav": name, "error": f"timed out after {timeout_s}s"}
        return self._aggregate(name, [r.result for r in reqs])

    def submit_stream(self, wave: np.ndarray, name: str,
                      timeout_s: Optional[float] = None):
        """Yields one result per window in order as windows complete (each
        tagged chunk_index/chunk_count), then submit()'s aggregate."""
        timeout_s = self.request_timeout_s if timeout_s is None else timeout_s
        if self._stop.is_set():
            yield {"wav": name, "error": "server shutting down"}
            return
        reqs = self._plan_requests(wave, name)
        self._enqueue(reqs)
        results = []
        for i, r in enumerate(reqs):
            if not r.done.wait(timeout=timeout_s):
                yield {"wav": name, "error": f"timed out after {timeout_s}s"}
                return
            results.append(r.result)
            if "error" in r.result:
                break
            yield {**r.result, "chunk_index": i, "chunk_count": len(reqs)}
        yield self._aggregate(name, results)

    def shutdown(self):
        self._stop.set()
        self.thread.join(timeout=5)
        # answer anything still queued so no HTTP thread hangs
        while True:
            try:
                req = self.q.get_nowait()
            except queue.Empty:
                break
            req.result = {"wav": req.name, "error": "server shutting down"}
            req.done.set()

    # ------------------------------------------------------------ internals
    def _gather(self, first_timeout: float = 0.2) -> List[_Request]:
        try:
            first = self.q.get(timeout=first_timeout)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _plan_shape(self, batch: List[_Request]) -> tuple:
        """Padded (Bp, T) of a gathered batch: the longest request's duration
        bucket, at least one conv receptive field, clamped to the largest
        window (requests are already windowed to at most max_samples)."""
        longest = max(len(r.wave) for r in batch)
        T = max(-(-max(longest, 1) // self.bucket) * self.bucket, CONV_RECEPTIVE_FIELD)
        T = min(T, max(self.max_samples, CONV_RECEPTIVE_FIELD))
        return self._bucket_batch_size(len(batch)), T

    def _inputs(self, wave: np.ndarray, lengths: np.ndarray) -> tuple:
        """(wave, lengths) as the pipeline takes them, and the host buffers to
        keep until the batch is finalized.  On CUDA: copied into pinned
        memory and sent with non-blocking copies, which do not synchronize
        the stream as a copy from pageable memory does."""
        if self.device.type != "cuda":
            return wave, lengths, ()
        host = [torch.from_numpy(a).pin_memory() for a in (wave, lengths)]
        dev = [h.to(self.device, non_blocking=True) for h in host]
        return dev[0], dev[1], host

    def _dispatch(self, batch: List[_Request]):
        """Pad a gathered batch to its (Bp, T) and queue it on the device;
        returns (finalize, host buffers).  Pad rows carry 0.1 s of silence
        (never all-masked) and are sliced off at finalize."""
        t_start = time.perf_counter()
        Bp, T = self._plan_shape(batch)
        enc = self.pipeline.input_encoding
        # NOT zeros in mulaw8: a zero byte is -1.0 full-scale DC
        wave = np.full((Bp, T), silence_value(enc), wire_dtype(enc))
        for i, r in enumerate(batch):
            wave[i, :len(r.wave)] = r.wave  # wire-encoded at arrival (_to_wire)
        lengths = np.full((Bp,), min(1600, T), np.int64)
        for i, r in enumerate(batch):
            # one conv receptive field at least: fewer samples give no frame
            lengths[i] = max(len(r.wave), CONV_RECEPTIVE_FIELD)
        self._rng_counter += 1
        generator = torch.Generator(device=self.device).manual_seed(self._rng_counter)
        wave, lengths, host = self._inputs(wave, lengths)
        t_pad = time.perf_counter()
        kw = dict(seq_len=self.seq_len, generator=generator, with_confidence=True,
                  **self.sampling)
        fin = self.pipeline.transcribe_with_ids_async(wave, lengths, **kw)
        t_disp = time.perf_counter()
        with self.stats_lock:
            self.stats["t_pad"] += t_pad - t_start
            self.stats["t_dispatch"] += t_disp - t_pad
        return fin, host

    def _finalize(self, batch: List[_Request], fin, t0: float, host=()) -> None:
        """Read a dispatched batch's results and answer its requests.  `host`:
        its pinned input buffers, kept alive (in the in-flight entry) until
        now."""
        try:
            t_call = time.perf_counter()
            texts_ids = fin()[:len(batch)]
            now = time.perf_counter()
            t_wait = now - t_call
            device_s = now - max(t0, self._busy_until)  # union of in-flight windows
            self._busy_until = now
            for r, (text, ids, conf) in zip(batch, texts_ids):
                r.result = {
                    "wav": r.name, "text": text,
                    "ids": ids,
                    "confidence": round(conf, 6),
                    "T_infer": self.sampling.get("T_infer"),
                    "r": self.sampling.get("r"),
                    "greedy": self.sampling.get("greedy", True),
                    "posterior_mode": self.sampling.get("posterior_mode", "average"),
                }
                if self.sampling.get("num_candidates", 1) > 1:
                    r.result["num_candidates"] = self.sampling["num_candidates"]
                r.done.set()
            with self.stats_lock:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["audio_seconds"] += sum(len(r.wave) for r in batch) / 16000.0
                self.stats["device_seconds"] += device_s
                self.stats["batch_size_sum"] += len(batch)
                self.stats["t_wait"] += t_wait
                self.stats["t_respond"] += time.perf_counter() - now
                self.stats["latencies_ms"].extend((now - r.t_enqueue) * 1e3 for r in batch)
        except Exception as e:  # noqa: BLE001 - per-batch fault isolation
            self._fail(batch, e)

    def _fail(self, batch: List[_Request], e: Exception) -> None:
        for r in batch:
            if not r.done.is_set():
                r.result = {"wav": r.name, "error": str(e)}
                r.done.set()
        with self.stats_lock:
            self.stats["errors"] += len(batch)
        if self.on_fatal is not None and self.fatal_error is None:
            self.fatal_error = e
            self._stop.set()
            self.on_fatal(e)

    def _loop(self):
        # Up to pipeline_depth batches are queued on the device before the
        # oldest one's results are waited for, so device work overlaps the
        # host's gather, pad, decode and HTTP work; results are finalized in
        # dispatch order.
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        inflight = collections.deque()  # of (batch, finalize, t0, host buffers)
        while not self._stop.is_set():
            # with batches in flight, their finalize is the priority
            batch = self._gather(first_timeout=0.005 if inflight else 0.2)
            if batch:
                if inflight and self._plan_shape(batch) not in self._warm_shapes:
                    # a cold shape may block its dispatch (first calls at a
                    # new shape): answer everything in flight first
                    while inflight:
                        self._finalize(*inflight.popleft())
                t0 = time.perf_counter()
                try:
                    fin, host = self._dispatch(batch)
                    inflight.append((batch, fin, t0, host))
                    self._warm_shapes.add(self._plan_shape(batch))
                except Exception as e:  # noqa: BLE001 - per-batch isolation
                    self._fail(batch, e)
            # drain one batch an iteration: when the pipe is full, or when no
            # new traffic came (answer waiting clients)
            if len(inflight) >= self.pipeline_depth or (inflight and not batch):
                self._finalize(*inflight.popleft())
        while inflight:
            self._finalize(*inflight.popleft())

    def stats_snapshot(self) -> dict:
        with self.stats_lock:
            lat = sorted(self.stats["latencies_ms"])
            snap = {
                "requests": self.stats["requests"],
                "errors": self.stats["errors"],
                "batches": self.stats["batches"],
                "audio_seconds": round(self.stats["audio_seconds"], 2),
                "mean_batch_size": (
                    round(self.stats["batch_size_sum"] / self.stats["batches"], 2)
                    if self.stats["batches"] else 0.0),
                "rtfx": (
                    round(self.stats["audio_seconds"] / self.stats["device_seconds"], 1)
                    if self.stats["device_seconds"] > 0 else None),
                # mean per-batch stage times: where an engine cycle goes
                "stage_ms": (
                    {k: round(1e3 * self.stats["t_" + k] / self.stats["batches"], 1)
                     for k in ("pad", "dispatch", "wait", "respond")}
                    if self.stats["batches"] else None),
            }
            if lat:
                snap["latency_ms"] = {
                    "p50": round(lat[len(lat) // 2], 1),
                    "p95": round(lat[int(len(lat) * 0.95)], 1),
                    "max": round(lat[-1], 1),
                }
            return snap


class StreamingSession:
    """Incremental recognition over the batching engine.

    `feed(samples)` buffers 16 kHz float audio as it arrives; whenever more
    than one window is buffered, a chunk is committed at the quietest 25 ms
    frame near the window's edge, the decision `plan_silence_chunks` makes
    offline (each of its cuts needs only one window of lookahead), so a
    fully fed session at the engine's window commits the chunks
    `engine.submit` would.  Committed chunks are ordinary engine requests.
    `poll()` yields completed windows in order without blocking; `finish()`
    commits the tail, yields the remaining windows, then `submit`'s
    aggregate.  `window_seconds` is clamped to the engine's window, so
    committed chunks fit the same duration buckets."""

    _FRAME = 400  # 25 ms at 16 kHz, as plan_silence_chunks

    def __init__(self, engine: BatchingEngine, name: str,
                 window_seconds: Optional[float] = None,
                 timeout_s: Optional[float] = None):
        self.engine = engine
        self.name = name
        win = (engine.max_samples if window_seconds is None
               else int(float(window_seconds) * 16000))
        # two frames at least, so the cut search has room
        self.win = max(2 * self._FRAME, min(win, engine.max_samples))
        self.timeout_s = engine.request_timeout_s if timeout_s is None else timeout_s
        self._tail = np.zeros((0,), np.float32)
        self._reqs: List[_Request] = []
        self._emitted = 0       # windows already yielded by poll()
        self._results: List[dict] = []
        self._finished = False
        self._errored = False   # a window failed: surfaced once, as finish()'s aggregate

    # -------------------------------------------------------------- input
    def feed(self, samples: np.ndarray) -> None:
        """Append audio; commit every full window at `silence_cut`'s cut."""
        if self._finished:
            raise RuntimeError("feed() after finish()")
        if self._errored:
            # the stream already failed: spend no device time on its windows
            self._tail = np.zeros((0,), np.float32)
            return
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size:
            self._tail = np.concatenate([self._tail, samples])
        win = self.win
        while len(self._tail) > win:
            cut = silence_cut(self._tail[:win], win, frame=self._FRAME)
            self._commit(self._tail[:cut].copy())
            self._tail = self._tail[cut:]

    def _commit(self, wave: np.ndarray) -> None:
        # a cut means another chunk follows, so the name is a chunk's
        req = _Request(self.engine._to_wire(wave), f"{self.name}#chunk{len(self._reqs)}")
        self._reqs.append(req)
        self.engine._enqueue([req])

    # ------------------------------------------------------------- output
    def poll(self):
        """Yield the results of consecutively completed windows (without
        blocking).  A window's error stops the partials: it surfaces once,
        as finish()'s aggregate."""
        while (not self._errored and self._emitted < len(self._reqs)
               and self._reqs[self._emitted].done.is_set()):
            req = self._reqs[self._emitted]
            self._results.append(req.result)
            self._emitted += 1
            if "error" in req.result:
                self._errored = True
                return
            yield {**req.result, "chunk_index": self._emitted - 1}

    def finish(self):
        """Commit the buffered tail, drain the remaining windows in order,
        then yield the aggregate (`engine.submit`'s)."""
        self._finished = True
        if self._errored:
            yield self.engine._aggregate(self.name, self._results, window_samples=self.win)
            return
        if not self._reqs:
            # the only chunk: the plain name, as _plan_requests gives it
            req = _Request(self.engine._to_wire(self._tail), self.name)
            self._reqs.append(req)
            self.engine._enqueue([req])
        else:
            self._commit(self._tail)
        self._tail = np.zeros((0,), np.float32)
        n = len(self._reqs)
        while self._emitted < n:
            req = self._reqs[self._emitted]
            if not req.done.wait(timeout=self.timeout_s):
                yield {"wav": self.name, "error": f"timed out after {self.timeout_s}s"}
                return
            self._results.append(req.result)
            if "error" in req.result:
                self._emitted += 1
                break
            yield {**req.result, "chunk_index": self._emitted, "chunk_count": n}
            self._emitted += 1
        yield self.engine._aggregate(self.name, self._results, window_samples=self.win)


class _PcmStreamDecoder:
    """Incremental raw-PCM byte decoder (network chunks can split samples)."""

    def __init__(self, fmt: str):
        if fmt not in ("pcm16", "f32"):
            raise ValueError(f"unsupported stream format {fmt!r} (use pcm16 or f32)")
        self.fmt = fmt
        self.width = 2 if fmt == "pcm16" else 4
        self._carry = b""

    def decode(self, data: bytes) -> np.ndarray:
        data = self._carry + data
        usable = len(data) - len(data) % self.width
        self._carry = data[usable:]
        buf = data[:usable]
        if self.fmt == "pcm16":
            return np.frombuffer(buf, "<i2").astype(np.float32) / 32768.0
        return np.frombuffer(buf, "<f4").astype(np.float32)


def _decode_wav_bytes(body: bytes, target_sr: int = 16000) -> np.ndarray:
    """An uploaded WAV (PCM or float) -> mono float32 at `target_sr`."""
    data, sr = load_wav(io.BytesIO(body))
    if data.ndim > 1:
        data = data.mean(axis=0)
    if sr != target_sr:
        data = resample(data, sr, target_sr)
    return np.asarray(data, np.float32)


def make_handler(engine: BatchingEngine, config_echo: dict,
                 audio_root: Optional[str] = None,
                 loopback_only_paths: bool = False):
    """audio_root: the directory JSON {"path": ...} requests may read from.
    Without it, a server bound beyond loopback refuses path mode (any client
    could otherwise read and probe the server's files)."""
    root = os.path.realpath(audio_root) if audio_root else None

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, obj: dict):
            if code >= 400:
                # unread body bytes would be parsed as the next request
                # line on a kept-alive connection: close it instead
                self.close_connection = True
            payload = json.dumps(obj, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        # one chunked NDJSON writer for both streaming endpoints
        def _ndjson_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson; charset=utf-8")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _ndjson_line(self, obj: dict):
            data = (json.dumps(obj, ensure_ascii=False) + "\n").encode("utf-8")
            self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        def _ndjson_end(self):
            self.wfile.write(b"0\r\n\r\n")

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._reply(200, {"status": "ok", **config_echo})
            elif self.path.startswith("/stats"):
                self._reply(200, engine.stats_snapshot())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path.startswith("/v1/transcribe/stream"):
                self._ingest_stream_reply()
                return
            if not self.path.startswith("/v1/transcribe"):
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(n)
                ctype = (self.headers.get("Content-Type") or "").lower()
                if ctype.startswith("application/json"):
                    req = json.loads(body.decode("utf-8"))
                    path = os.path.realpath(str(req["path"]))
                    if root is not None:
                        if not (path == root or path.startswith(root + os.sep)):
                            self._reply(403, {"error": "path outside --audio-root"})
                            return
                    elif loopback_only_paths:
                        self._reply(403, {
                            "error": "path mode disabled on non-loopback bind; set "
                                     "--audio-root or upload WAV bytes"})
                        return
                    try:
                        wave, _ = load_audio(path, target_sr=16000, mono=True)
                    except Exception:  # noqa: BLE001 - leak no file system detail
                        self._reply(400, {"error": "could not read audio at requested path"})
                        return
                    name = path
                else:
                    wave = _decode_wav_bytes(body)
                    name = f"<upload:{n}B>"
            except Exception as e:  # noqa: BLE001 - bad request isolation
                self._reply(400, {"error": f"bad request: {e}"})
                return
            from urllib.parse import parse_qs, urlsplit

            query = parse_qs(urlsplit(self.path).query)
            if query.get("stream", ["0"])[-1] in ("1", "true"):
                self._stream_reply(wave, name)
                return
            result = engine.submit(wave, name)
            self._reply(200 if "error" not in result else 500, result)

        def _stream_reply(self, wave, name):
            """POST /v1/transcribe?stream=1: one NDJSON line per long-form
            window as it completes (chunk_index/chunk_count), then the
            aggregate, the object the plain endpoint returns."""
            self._ndjson_start()
            try:
                for res in engine.submit_stream(wave, name):
                    self._ndjson_line(res)
                self._ndjson_end()
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client left; the device work completes

        # ----------------------------------------------- incremental input
        def _iter_request_body(self, blocksize: int = 32768):
            """The request body in pieces as it arrives.  The base handler
            does not decode Transfer-Encoding: chunked (a live client cannot
            know its Content-Length), so the framing is parsed here."""
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                while True:
                    line = self.rfile.readline(1024).split(b";")[0].strip()
                    try:
                        size = int(line or b"0", 16)
                    except ValueError:
                        raise ValueError("malformed chunked encoding: "
                                         f"bad chunk-size line {line!r}")
                    if size < 0:
                        raise ValueError("malformed chunked encoding: negative chunk size")
                    if size == 0:
                        while self.rfile.readline(1024).strip():
                            pass  # trailers
                        return
                    remaining = size
                    while remaining:
                        data = self.rfile.read(min(blocksize, remaining))
                        if not data:
                            return
                        remaining -= len(data)
                        yield data
                    self.rfile.read(2)  # the CRLF after each chunk
            else:
                n = int(self.headers.get("Content-Length", "0"))
                while n > 0:
                    data = self.rfile.read(min(blocksize, n))
                    if not data:
                        return
                    n -= len(data)
                    yield data

        def _ingest_stream_reply(self):
            """POST /v1/transcribe/stream: the client pushes raw little-endian
            mono 16 kHz audio (format=pcm16|f32, default pcm16) and NDJSON
            results of committed windows (window-seconds=<float>, clamped to
            --max-seconds) flow back on the same response; the last line is
            the aggregate the plain endpoint would return."""
            from urllib.parse import parse_qs, urlsplit

            query = parse_qs(urlsplit(self.path).query)
            try:
                dec = _PcmStreamDecoder(query.get("format", ["pcm16"])[-1].lower())
                ws = query.get("window-seconds", [None])[-1]
                ws = None if ws is None else float(ws)
            except ValueError as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            session = StreamingSession(engine, f"<stream:{dec.fmt}>", window_seconds=ws)
            # bound every blocking read: a client stalled mid-chunk would
            # otherwise hold this thread and its buffered audio forever
            self.connection.settimeout(engine.request_timeout_s)
            self._ndjson_start()
            try:
                for data in self._iter_request_body():
                    session.feed(dec.decode(data))
                    for res in session.poll():
                        self._ndjson_line(res)
                for res in session.finish():
                    self._ndjson_line(res)
                self._ndjson_end()
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client left; committed windows complete anyway
            except (ValueError, TimeoutError) as e:
                # bad framing or a stalled upload after the 200: report it in
                # band and drop the connection (the body cannot be reused)
                self.close_connection = True
                try:
                    self._ndjson_line({"wav": session.name, "error": f"stream aborted: {e}"})
                    self._ndjson_end()
                except OSError:
                    pass

    return Handler


# the header of a dispatch over a mesh: op, B, T, seed, num_candidates, wire
# dtype, seq_len, with_confidence, has lengths
_OP_STOP, _OP_BATCH = 0, 1
_HEADER = 9
_WIRE_DTYPES = (torch.float32, torch.int16, torch.uint8)


class MeshDispatch:
    """The pipeline as rank 0's engine sees it over a mesh (`--mesh`, one
    process a GPU): each call first sends its fixed-size header, then the
    padded wave and lengths, over the world group, so the other ranks
    (`follow`) make the same `transcribe_with_ids_async` call, whose
    collectives then meet.  Calls are issued in dispatch order, one at a
    time (a lock), so `--pipeline-depth` > 1 keeps its overlap: finalize
    runs no collective.  `stop` sends the stop op."""

    def __init__(self, pipeline, mesh):
        self.pipeline = pipeline
        self.mesh = mesh
        self.input_encoding = pipeline.input_encoding
        self.device = pipeline.device
        self._lock = threading.Lock()
        self._stopped = False

    def transcribe_with_ids(self, wave, lengths=None, **kw):
        return self.transcribe_with_ids_async(wave, lengths, **kw)()

    def transcribe_with_ids_async(self, wave, lengths=None, seq_len: int = 64, generator=None,
                                  with_confidence: bool = False, num_candidates: int = 1,
                                  **sampling):
        from fddm_asr_tpu_torch.parallel.distributed import broadcast_

        dev = torch.device(self.device)
        wave = torch.as_tensor(wave).to(dev)
        lengths = None if lengths is None else torch.as_tensor(lengths).to(dev)
        seed = 0 if generator is None else generator.initial_seed()
        header = [_OP_BATCH, wave.shape[0], wave.shape[1], seed, int(num_candidates),
                  _WIRE_DTYPES.index(wave.dtype), int(seq_len), int(with_confidence),
                  int(lengths is not None)]
        with self._lock:
            if self._stopped:
                raise RuntimeError("the serving mesh was stopped")
            _send_header(header)
            broadcast_(wave)
            if lengths is not None:
                broadcast_(lengths)
            return self.pipeline.transcribe_with_ids_async(
                wave, lengths, seq_len=seq_len, generator=generator,
                with_confidence=with_confidence, num_candidates=num_candidates, **sampling)

    def stop(self) -> None:
        """The stop op, once: every other rank leaves `follow`."""
        with self._lock:
            if not self._stopped:
                self._stopped = True
                _send_header([_OP_STOP] + [0] * (_HEADER - 1))


def _send_header(values: List[int]) -> torch.Tensor:
    import torch.distributed as dist

    from fddm_asr_tpu_torch.parallel.distributed import _device_of, broadcast_

    t = torch.tensor(values, dtype=torch.int64, device=_device_of(dist.group.WORLD))
    return broadcast_(t)


def follow(pipeline, sampling: dict, pipeline_depth: int = 2) -> int:
    """A rank other than 0 of a serving mesh: receive each dispatch's header,
    wave and lengths from rank 0 and make its `transcribe_with_ids_async`
    call (x_T from a generator seeded as rank 0's), finalizing the oldest
    of `pipeline_depth` in flight; return at the stop op with the number
    of batches followed.  A failed collective raises: the rank exits and
    the server fails with it."""
    from fddm_asr_tpu_torch.parallel.distributed import broadcast_

    dev = torch.device(pipeline.device)
    inflight = collections.deque()
    n = 0
    while True:
        header = _send_header([0] * _HEADER).tolist()
        op, B, T, seed, candidates, wire, seq_len, with_conf, has_lengths = header
        if op == _OP_STOP:
            break
        wave = broadcast_(torch.empty((B, T), dtype=_WIRE_DTYPES[wire], device=dev))
        lengths = (broadcast_(torch.empty((B,), dtype=torch.int64, device=dev))
                   if has_lengths else None)
        generator = torch.Generator(device=dev).manual_seed(seed)
        kw = {k: v for k, v in sampling.items() if k != "num_candidates"}
        inflight.append(pipeline.transcribe_with_ids_async(
            wave, lengths, seq_len=seq_len, generator=generator,
            with_confidence=bool(with_conf), num_candidates=candidates, **kw))
        n += 1
        if len(inflight) >= max(1, pipeline_depth):
            inflight.popleft()()
    while inflight:
        inflight.popleft()()
    return n


class ExportedEngineAdapter:
    """`FDDMPipeline`-shaped front of an AOT artifact (`aot.ExportedPipeline`)
    for the engine.  seq_len and sampling are baked into the programs, so
    the engine's per-call values are ignored (the engine is built from the
    artifact's meta, so they agree); x_T is drawn from the generator the
    engine seeds at its counter, at the artifact bucket's batch."""

    def __init__(self, exported):
        self.ep = exported
        self.input_encoding = exported.input_encoding
        self.device = exported.device

    def transcribe_with_ids(self, wave, lengths=None, seq_len=None, generator=None,
                            with_confidence=False, **_sampling):
        return self.transcribe_with_ids_async(wave, lengths, generator=generator,
                                              with_confidence=with_confidence)()

    def transcribe_with_ids_async(self, wave, lengths=None, seq_len=None, generator=None,
                                  with_confidence=False, **_sampling):
        return self.ep.transcribe_with_ids_async(wave, lengths, generator=generator,
                                                 with_confidence=with_confidence)


def _build_exported_server(args) -> ThreadingHTTPServer:
    import warnings

    from fddm_asr_tpu_torch.aot import ExportedPipeline

    if args.num_candidates > 1:
        raise SystemExit("--num-candidates needs the live pipeline (--config/--ckpt): "
                         "exported artifacts bake their sampling and batch shapes")
    ep = ExportedPipeline.load(args.exported, device=args.device)
    meta = ep.meta
    # the artifact's baked wire dtype wins: a conflicting --wire-dtype would
    # be ignored while clients encode for it
    if args.wire_dtype != "f32" and args.wire_dtype != ep.input_encoding:
        raise SystemExit(
            f"--wire-dtype {args.wire_dtype} conflicts with the exported artifact's baked "
            f"input encoding '{ep.input_encoding}': the wire format is fixed at export time "
            "(export_model --input-encoding); drop the flag or re-export")
    if not meta.get("use_condition_mask"):
        warnings.warn("artifact was exported with --condition-mask off: co-batched padding "
                      "can alter transcripts (export serving artifacts with --condition-mask "
                      "on)", stacklevel=2)
    batches = sorted({b for b, _ in ep.buckets})
    samples = sorted({n for _, n in ep.buckets})
    s = meta["sampling"]
    sampling = {"T_infer": s["T_infer"], "r": s["r"], "greedy": s["greedy"],
                "posterior_mode": s["posterior_mode"]}
    max_batch = max(batches)
    if args.max_batch:
        if args.max_batch not in batches:
            raise SystemExit(f"--max-batch {args.max_batch} is not an exported batch bucket "
                             f"(artifact has {batches})")
        max_batch = args.max_batch
    adapter = ExportedEngineAdapter(ep)
    dispatch = MeshDispatch(adapter, ep.mesh) if ep.mesh is not None else None
    server_box = []

    def fail_server(error):  # the engine's thread: stop serving, main raises
        threading.Thread(target=server_box[0].shutdown, daemon=True).start()

    engine = BatchingEngine(
        dispatch or adapter, sampling, meta["seq_len"], max_batch=max_batch,
        max_wait_ms=args.max_wait_ms, bucket_seconds=min(samples) / 16000.0,
        max_seconds=max(samples) / 16000.0, request_timeout_s=args.request_timeout_s,
        pipeline_depth=args.pipeline_depth,
        batch_multiple=1 if ep.mesh is None else ep.mesh.shape["data"],
        on_fatal=fail_server if dispatch is not None else None)
    echo = {"model": "fddm-asr-tpu", "exported": args.exported, "seq_len": meta["seq_len"],
            **sampling, "max_batch": max_batch,
            # buckets replayed as CUDA graphs (all of them on CUDA, none on the
            # CPU or over a gloo mesh), and why not
            "native_buckets": sorted(list(bn) for bn in ep.native),
            "execution": ep.execution, "eager_reason": ep.eager_reason}
    if ep.mesh is not None:
        echo["mesh"] = {**ep.mesh.shape, "seq_parallel": bool(meta.get("seq_parallel"))}
    loopback = args.host in ("127.0.0.1", "localhost", "::1")
    server = FDDMHTTPServer(
        (args.host, args.port),
        make_handler(engine, echo, audio_root=args.audio_root, loopback_only_paths=not loopback))
    server_box.append(server)
    server.engine = engine
    server.dispatch = dispatch
    server.warmup = _warmup(engine, args.warmup_seconds, max_batch) if args.warmup_seconds else []
    return server


def join_mesh(args):
    """The mesh of `--mesh` over the process group (joined from torchrun's or
    the FDDM_* environment), `args.device` set to this rank's device; for
    `--exported`, the mesh its meta names (the group joined, the mesh built
    by the artifact's loader); None without either.  An artifact takes no
    `--mesh` and no encoder weights, and `--seq-parallel` needs a model
    axis."""
    from fddm_asr_tpu_torch.inference import check_seq_parallel
    from fddm_asr_tpu_torch.inference import join_mesh as join

    if args.exported:
        if args.wavlm_ckpt or args.encoder_ckpt:
            raise SystemExit("--wavlm-ckpt / --encoder-ckpt with --exported: an artifact "
                             "carries its own weights; pass them to python -m "
                             "fddm_asr_tpu_torch.export_model instead")
        if args.mesh or args.seq_parallel:
            raise SystemExit("--exported artifacts are pre-lowered; pass --mesh to python -m "
                             "fddm_asr_tpu_torch.export_model instead")
        from fddm_asr_tpu_torch import parallel as P
        from fddm_asr_tpu_torch.aot import read_meta

        mesh = read_meta(args.exported).get("mesh")
        if mesh:  # the group joined here (this rank's role); the loader builds the mesh
            dist_cfg = P.DistributedConfig.from_env()
            P.initialize(dist_cfg, device=args.device)
            args.device = str(dist_cfg.rank_device(args.device))
        return mesh
    if not (args.mesh or args.seq_parallel):
        return None
    mesh = join(args)
    check_seq_parallel(mesh, args.seq_parallel)
    return mesh


def _live_pipeline(args, mesh):
    """(pipeline, sampling, seq_len) of --config/--ckpt and the encoder
    weights on --device, over `mesh` when one is given."""
    from fddm_asr_tpu_torch.config import load_config
    from fddm_asr_tpu_torch.convert import load_encoder_weights
    from fddm_asr_tpu_torch.pipeline import FDDMPipeline
    from fddm_asr_tpu_torch.tokenizer import load_tokenizer

    cfg = load_config(args.config)
    tokenizer = load_tokenizer(args.tokenizer or cfg.data.tokenizer_path)
    wavlm_sd, encoder_sd = load_encoder_weights(args.wavlm_ckpt, args.encoder_ckpt)
    pipeline = FDDMPipeline.from_config(
        cfg, ckpt_path=args.ckpt, wavlm_state_dict=wavlm_sd, encoder_state_dict=encoder_sd,
        tokenizer=tokenizer, device=args.device,
        use_condition_mask=True,  # bucket padding must not alter transcripts
        dtype=None if args.dtype == "config" else args.dtype)
    pipeline.input_encoding = args.wire_dtype
    if mesh is not None:
        pipeline.apply_mesh(mesh, seq_parallel=args.seq_parallel)
    inf = cfg.get("inference", {})
    sampling = {
        "T_infer": args.T_infer or inf.get("T_infer", 20),
        "r": args.r or inf.get("r", 5),
        "greedy": True,
        # passed to the sampler and echoed in results
        "posterior_mode": inf.get("posterior_mode", "average"),
    }
    if float(inf.get("repeat_penalty", 0.0)) > 0.0:
        sampling["repeat_penalty"] = float(inf["repeat_penalty"])
    if args.num_candidates > 1:
        # best-of-N: candidates fold into the device batch, the most confident wins
        sampling["num_candidates"] = int(args.num_candidates)
    return pipeline, sampling, args.seq_len or cfg.data.get("max_len", 64)


def build_server(args, mesh=None) -> ThreadingHTTPServer:
    """The pipeline from --config/--ckpt and the encoder weights of
    --wavlm-ckpt/--encoder-ckpt (or the artifact --exported) on
    --device, its engine and the HTTP server bound to --host/--port (not yet
    serving), warmed up when --warmup-seconds is given.  With --mesh
    (`mesh`, or joined here) this is rank 0's server: its engine's calls
    reach the other ranks through `MeshDispatch` (`server.dispatch`), and
    a failed batch fails the server."""
    if mesh is None:
        mesh = join_mesh(args)
    if args.exported:
        return _build_exported_server(args)
    if not (args.config and args.ckpt):
        raise SystemExit("either --exported or both --config and --ckpt are required")
    pipeline, sampling, seq_len = _live_pipeline(args, mesh)
    max_batch = args.max_batch or 16
    dispatch = None
    batch_multiple = 1
    if mesh is not None and mesh.size > 1:
        dispatch = MeshDispatch(pipeline, mesh)
        batch_multiple = mesh.shape["data"]
    server_box = []

    def fail_server(error):  # the engine's thread: stop serving, main raises
        threading.Thread(target=server_box[0].shutdown, daemon=True).start()

    engine = BatchingEngine(
        dispatch or pipeline, sampling, seq_len, max_batch=max_batch,
        max_wait_ms=args.max_wait_ms, bucket_seconds=args.bucket_seconds,
        max_seconds=args.max_seconds, request_timeout_s=args.request_timeout_s,
        pipeline_depth=args.pipeline_depth, batch_multiple=batch_multiple,
        on_fatal=fail_server if dispatch is not None else None)
    echo = {"model": "fddm-asr-tpu", "seq_len": seq_len, **sampling, "max_batch": max_batch}
    if mesh is not None:
        echo["mesh"] = {**mesh.shape, "seq_parallel": bool(args.seq_parallel)}
    # '' binds every interface: not loopback
    loopback = args.host in ("127.0.0.1", "localhost", "::1")
    server = FDDMHTTPServer(
        (args.host, args.port),
        make_handler(engine, echo, audio_root=args.audio_root,
                     loopback_only_paths=not loopback))
    server_box.append(server)
    server.engine = engine
    server.dispatch = dispatch
    server.warmup = _warmup(engine, args.warmup_seconds, max_batch) if args.warmup_seconds else []
    return server


def _warmup(engine: BatchingEngine, seconds_list: str, max_batch: int) -> list:
    """Run one silent batch at every batch size the engine can produce for
    each duration bucket in the comma-separated list, as `_dispatch` runs
    it (wire dtype, pinned inputs, with confidence): it builds the kernels,
    sets up the libraries and fills the allocator's caches before traffic.
    Seed 0, the counter untouched.  Returns and prints each call's seconds;
    an error (a kernel that does not build or launch) raises."""
    enc = engine.pipeline.input_encoding
    out = []
    for sec in (float(s) for s in str(seconds_list).split(",") if s):
        T = min(-(-int(sec * 16000) // engine.bucket) * engine.bucket,
                max(engine.max_samples, CONV_RECEPTIVE_FIELD))
        for B in sorted({engine._bucket_batch_size(n) for n in range(1, max_batch + 1)}):
            t0 = time.perf_counter()
            wave, lengths, _ = engine._inputs(np.full((B, T), silence_value(enc), wire_dtype(enc)),
                                              np.full((B,), min(1600, T), np.int64))
            engine.pipeline.transcribe_with_ids(
                wave, lengths, seq_len=engine.seq_len,
                generator=torch.Generator(device=engine.device).manual_seed(0),
                with_confidence=True, **engine.sampling)
            engine._warm_shapes.add((B, T))
            s = time.perf_counter() - t0
            out.append({"B": B, "T": T, "seconds": s})
            print(f"warmup B={B} T={T / 16000:.0f}s: {s:.1f}s", flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="FDDM-ASR inference server on PyTorch")
    ap.add_argument("--config", default=None, help="the model's YAML config")
    ap.add_argument("--ckpt", default=None, help="reference-format .pt decoder checkpoint")
    add_encoder_weight_args(ap)
    ap.add_argument("--exported", default=None,
                    help="serve an AOT artifact directory (python -m "
                         "fddm_asr_tpu_torch.export_model) instead of --config/--ckpt; a "
                         "sharded one under torchrun with as many ranks as its mesh")
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="largest device batch (default 16)")
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="device batches in flight at once (1 = no overlap, 2 = double "
                         "buffering)")
    ap.add_argument("--bucket-seconds", type=float, default=1.0)
    ap.add_argument("--max-seconds", type=float, default=30.0,
                    help="long-form window: longer uploads are split into windows of this "
                         "size, cut at the quietest 25 ms frame near each edge, batched "
                         "with other traffic, and the texts joined")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="tokens decoded a window (default: the config's data.max_len)")
    ap.add_argument("--T-infer", type=int, default=None)
    ap.add_argument("--r", type=int, default=None)
    ap.add_argument("--num-candidates", type=int, default=1,
                    help="best-of-N: N trajectories an utterance, the most confident served")
    ap.add_argument("--mesh", default="",
                    help="serve over a mesh of one process a GPU (torchrun), e.g. model=2 or "
                         "data=2,model=2; --max-batch must be a multiple of the data axis")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="with --mesh model=N > 1: each utterance's encoder frames over the "
                         "model ranks (ring attention) instead of the weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--wire-dtype", choices=["f32", "pcm16", "mulaw8"], default="f32",
                    help="dtype the batch audio crosses to the device in: pcm16 halves, "
                         "mulaw8 quarters the bytes (data/wire.py)")
    ap.add_argument("--dtype", choices=["config", "bfloat16", "float32"], default="config",
                    help="compute dtype; config honours the YAML's model.dtype")
    ap.add_argument("--request-timeout-s", type=float, default=600.0)
    ap.add_argument("--warmup-seconds", default=None,
                    help="comma-separated duration buckets (e.g. '5,20') to run once at "
                         "every batch size up to --max-batch before serving")
    ap.add_argument("--audio-root", default=None,
                    help="directory JSON {'path': ...} requests may read; without it path "
                         "mode only works on a loopback bind")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from fddm_asr_tpu_torch import parallel as P

    mesh = join_mesh(args)
    try:
        if mesh is not None and not P.is_primary():
            if args.exported:
                from fddm_asr_tpu_torch.aot import ExportedPipeline

                follow(ExportedEngineAdapter(ExportedPipeline.load(args.exported, args.device)),
                       {}, args.pipeline_depth)
                return
            pipeline, sampling, _ = _live_pipeline(args, mesh)
            follow(pipeline, sampling, args.pipeline_depth)
            return
        _serve(build_server(args, mesh), args.host)
    finally:
        if mesh is not None:
            P.shutdown()


def _serve(server, host: str) -> None:
    print(json.dumps({"serving": f"http://{host}:{server.server_address[1]}",
                      "endpoints": ["/v1/transcribe", "/v1/transcribe/stream",
                                    "/healthz", "/stats"], "pid": os.getpid()}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.engine.shutdown()
        if server.dispatch is not None and server.engine.fatal_error is None:
            server.dispatch.stop()
    if server.engine.fatal_error is not None:
        raise RuntimeError("a batch failed on the serving mesh: its ranks cannot carry on "
                           "past it") from server.engine.fatal_error


if __name__ == "__main__":
    main()
