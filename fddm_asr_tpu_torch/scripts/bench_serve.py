# -*- coding: utf-8 -*-
"""Serving load benchmark: saturated RTFx and request latency under
concurrent traffic through the real HTTP stack.

    python -m fddm_asr_tpu_torch.scripts.bench_serve --config C.yaml --ckpt D.pt \\
        [--concurrency 8] [--duration-s 30] [--audio-seconds 10] [--device cpu] \\
        [--stream [--pace 1.0] [--window-seconds 2.0] [--chunk-ms 100]] \\
        [--direct] [--repeats N] [--concurrency-sweep 1,2,4,8]
    python -m fddm_asr_tpu_torch.scripts.bench_serve --exported ART ...

Counterpart of `scripts/bench_serve.py`: stands up the port's server
(`serve.parse_args` + `serve.build_server`) in this process and fires
closed-loop clients at it for a fixed window, after warming every batch
bucket (a warm-up failure aborts).  Prints one JSON line in the JAX
script's keys ("serve_rtfx": wall-clock audio s/s, per-window values and
their IQR, the engine's device RTFx, stage times, latency, mean batch
size, cold start, errors); --stream benches POST /v1/transcribe/stream
(time to the first partial, finalization after the last byte) and
--direct the engine alone (no HTTP, no WAV decode).  `--mesh` runs under
torchrun: rank 0 serves, the other ranks follow.  Runs on CUDA unless
given --device cpu.

`stream_post` is the duplex streaming client (http.client cannot read a
response while its request body is still uploading, so the socket is
hand-rolled); `stream_client` uses it too.
"""
from __future__ import annotations

import argparse
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request
import wave as wave_mod

import numpy as np

__all__ = ["stream_post", "main"]


def _wav_bytes(seconds: float, seed: int, sr: int = 16000) -> bytes:
    pcm = (np.random.default_rng(seed).standard_normal(int(seconds * sr)) * 3000).astype("<i2")
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _percentiles(vals, pts=(50, 95)) -> dict:
    if not vals:
        return {f"p{p}": None for p in pts}
    return {f"p{p}": round(float(np.percentile(vals, p)), 1) for p in pts}


def stream_post(host: str, port: int, pcm: bytes, *, window_seconds=None, pace: float = 0.0,
                chunk_ms: float = 100.0, timeout_s: float = 300.0, fmt: str = "pcm16",
                on_line=None) -> dict:
    """One POST /v1/transcribe/stream over a raw socket, reading the NDJSON
    partials while the chunked upload goes on.  `pcm`: little-endian int16
    mono 16 kHz (or float32 with fmt="f32"); `pace` throttles the upload to
    pace x real time (0: as fast as it goes); `on_line(obj)` sees each line
    as it arrives.  Returns the time to the first partial from the first
    byte sent (ms), the final line's latency after the last byte (ms), the
    upload seconds, the count of partials and the final aggregate; raises
    on an error reply, a dropped connection or a final line with an error."""
    path = f"/v1/transcribe/stream?format={fmt}"
    if window_seconds is not None:
        path += f"&window-seconds={window_seconds}"
    byte_rate = 32000 if fmt == "pcm16" else 64000  # 16 kHz mono
    sock = socket.create_connection((host, port), timeout=timeout_s)
    try:
        sock.sendall((f"POST {path} HTTP/1.1\r\n"
                      f"Host: {host}\r\n"
                      "Transfer-Encoding: chunked\r\n"
                      "Content-Type: application/octet-stream\r\n\r\n").encode())
        rec = {"lines": [], "t_lines": [], "status": None, "complete": False,
               "error_body": None}

        def reader():
            f = sock.makefile("rb")
            status = f.readline()
            rec["status"] = int(status.split()[1]) if status else None
            headers = {}
            while True:
                h = f.readline().strip()
                if not h:
                    break
                k, _, v = h.partition(b":")
                headers[k.strip().lower()] = v.strip()
            chunked = headers.get(b"transfer-encoding", b"").lower() == b"chunked"
            if rec["status"] != 200 or not chunked:
                # an error reply has a Content-Length body: keep it to report
                n = int(headers.get(b"content-length", b"0") or b"0")
                rec["error_body"] = f.read(n).decode("utf-8", "replace")
                return
            buf = b""  # the server frames one NDJSON line a chunk
            while True:
                size_line = f.readline()
                if not size_line:
                    break  # EOF before the terminal chunk: incomplete
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    rec["complete"] = True
                    break
                buf += f.read(size)
                f.read(2)  # CRLF
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        rec["t_lines"].append(time.perf_counter())
                        obj = json.loads(line)
                        rec["lines"].append(obj)
                        if on_line is not None:
                            on_line(obj)

        rt = threading.Thread(target=reader, daemon=True)
        t0 = time.perf_counter()
        rt.start()
        width = 2 if fmt == "pcm16" else 4
        step = max(width, int(byte_rate * chunk_ms / 1000.0) // width * width)
        try:
            for i in range(0, len(pcm), step):
                blk = pcm[i:i + step]
                sock.sendall(b"%X\r\n" % len(blk) + blk + b"\r\n")
                if pace > 0:  # sleep off what is left of this slice's real time
                    delay = t0 + (i + len(blk)) / byte_rate / pace - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
            sock.sendall(b"0\r\n\r\n")
        except OSError:
            # the server answered early and closed: its reply says why
            rt.join(timeout=10.0)
            raise RuntimeError(f"server closed stream: status={rec['status']} "
                               f"body={rec['error_body'] or rec['lines'][-1:]}") from None
        t_eos = time.perf_counter()
        rt.join(timeout=timeout_s)
        if rt.is_alive():
            raise TimeoutError("streaming response did not finish")
        if rec["status"] != 200 or rec["error_body"] is not None:
            raise RuntimeError(f"stream failed: status={rec['status']} "
                               f"body={rec['error_body']!r}")
        if not rec["complete"]:
            # the last partial is not a final aggregate
            raise RuntimeError("stream ended without terminal chunk (connection dropped); "
                               f"got {len(rec['lines'])} lines")
        if not rec["lines"]:
            raise RuntimeError("stream failed: no response lines")
        final = rec["lines"][-1]
        if "error" in final:
            raise RuntimeError(f"stream error: {final['error']}")
        partials = rec["lines"][:-1]
        return {"first_partial_ms": (rec["t_lines"][0] - t0) * 1e3 if partials else None,
                "final_after_eos_ms": (rec["t_lines"][-1] - t_eos) * 1e3,
                "upload_s": t_eos - t0, "partials": len(partials), "final": final}
    finally:
        sock.close()


def _server_argv(args, ap, timeout_s: float) -> list:
    """The serve.py flags of this benchmark's flags."""
    device = ["--device", args.device] if args.device else []
    if args.exported:
        return (["--exported", args.exported, "--port", "0", "--max-wait-ms",
                 str(args.max_wait_ms), "--pipeline-depth", str(args.pipeline_depth),
                 "--request-timeout-s", str(timeout_s)]
                + (["--max-batch", str(args.max_batch)] if args.max_batch else []) + device)
    if args.config and args.ckpt:
        return (["--config", args.config, "--ckpt", args.ckpt, "--port", "0",
                 "--max-batch", str(args.max_batch or 16), "--max-wait-ms",
                 str(args.max_wait_ms), "--pipeline-depth", str(args.pipeline_depth),
                 "--request-timeout-s", str(timeout_s)]
                + (["--tokenizer", args.tokenizer] if args.tokenizer else [])
                + (["--seq-len", str(args.seq_len)] if args.seq_len else [])
                + (["--T-infer", str(args.T_infer)] if args.T_infer else [])
                + (["--r", str(args.r)] if args.r else [])
                + (["--mesh", args.mesh] if args.mesh else [])
                + (["--seq-parallel"] if args.seq_parallel else [])
                # every batch bucket at this duration before traffic: a cold
                # bucket would first run mid-window
                + ["--warmup-seconds", str(args.audio_seconds)] + device)
    ap.error("either --exported or both --config and --ckpt")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--exported", default=None,
                    help="bench an AOT artifact (serve --exported) instead of --config/--ckpt; "
                         "cold_start_s then measures its load instead of the model's build")
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--concurrency", type=int, default=8,
                    help="closed-loop clients (each fires its next request as soon as the "
                         "previous returns)")
    ap.add_argument("--duration-s", type=float, default=30.0,
                    help="measurement window after warmup")
    ap.add_argument("--audio-seconds", type=float, default=10.0)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="serve --max-batch (default: 16 live, the artifact's largest bucket "
                         "for --exported)")
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="engine batches in flight at once (serve --pipeline-depth)")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--T-infer", type=int, default=None)
    ap.add_argument("--r", type=int, default=None)
    ap.add_argument("--mesh", default="")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--direct", action="store_true",
                    help="drive BatchingEngine.submit directly (no HTTP, no WAV decode): the "
                         "engine and device capacity without the Python HTTP stack")
    ap.add_argument("--stream", action="store_true",
                    help="bench POST /v1/transcribe/stream (duplex chunked upload + NDJSON "
                         "partials) instead of the batch endpoint")
    ap.add_argument("--pace", type=float, default=0.0,
                    help="throttle each upload to PACE x real time (0 = as fast as "
                         "possible); 1.0 emulates live microphone audio")
    ap.add_argument("--window-seconds", type=float, default=None,
                    help="streaming commit window; must be < --audio-seconds for partials to "
                         "exist (defaults to the server's max window)")
    ap.add_argument("--chunk-ms", type=float, default=100.0,
                    help="upload slice size in audio milliseconds")
    ap.add_argument("--repeats", type=int, default=1,
                    help="N consecutive measured windows on the same warm server; reports "
                         "per-window values + median/IQR")
    ap.add_argument("--concurrency-sweep", default=None,
                    help="comma list of offered concurrencies (e.g. '1,2,4,8,16'): one result "
                         "row each at fixed pipeline depth.  Overrides --concurrency")
    args = ap.parse_args(argv)
    if args.exported and (args.config or args.ckpt):
        ap.error("--exported and --config/--ckpt are mutually exclusive "
                 "(they select different serving paths)")

    import torch

    from fddm_asr_tpu_torch import parallel as P
    from fddm_asr_tpu_torch import serve

    timeout_s = 1800.0  # the first request waits for the build of every kernel
    srv_args = serve.parse_args(_server_argv(args, ap, timeout_s))
    mesh = serve.join_mesh(srv_args)
    if mesh is not None and not P.is_primary():
        try:
            pipeline, sampling, _ = serve._live_pipeline(srv_args, mesh)
            serve.follow(pipeline, sampling, srv_args.pipeline_depth)
        finally:
            P.shutdown()
        return []
    platform = torch.device(srv_args.device or "cuda").type
    t_boot = time.perf_counter()
    srv = serve.build_server(srv_args, mesh)
    build_s = time.perf_counter() - t_boot
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        if args.stream:
            return [_bench_stream(args, srv, t_boot, build_s, timeout_s, platform)]
        if args.direct:
            return [_bench_direct(args, srv, t_boot, build_s, platform)]
        return _bench_http(args, srv, t_boot, build_s, timeout_s, platform)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.engine.shutdown()
        if srv.dispatch is not None:
            srv.dispatch.stop()
        if mesh is not None:
            P.shutdown()


def _warm(args, fn, what: str) -> None:
    """One wave of `args.concurrency` concurrent calls of `fn`; a failure
    aborts before the measured window (a cold bucket would poison it)."""
    errors = []

    def one():
        try:
            fn()
        except Exception as e:  # noqa: BLE001  collected and raised below
            errors.append(str(e))

    threads = [threading.Thread(target=one) for _ in range(args.concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"{len(errors)} warm-phase {what}(s) failed — buckets are cold, "
                           f"aborting before the measured window: {errors[0]}")


def _cold_start(build_s: float, first_request_s: float) -> dict:
    return {"build": round(build_s, 2), "first_request": round(first_request_s, 2)}


def _bench_http(args, srv, t_boot, build_s, timeout_s, platform) -> list:
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    body = _wav_bytes(args.audio_seconds, seed=0)

    def post():
        req = urllib.request.Request(base + "/v1/transcribe", data=body,
                                     headers={"Content-Type": "audio/wav"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:  # the engine's error body, not "HTTP 500"
            raise RuntimeError(f"server returned {e.code}: {e.read().decode('utf-8')}") from None

    # one solo request (the cold start), then one full-concurrency wave
    post()
    first_request_s = time.perf_counter() - t_boot
    _warm(args, post, "request")
    sweep = ([int(c) for c in args.concurrency_sweep.split(",")]
             if args.concurrency_sweep else [args.concurrency])
    results = []
    for concurrency in sweep:
        windows = [_measured_window(post, srv, concurrency, args.duration_s)
                   for _ in range(max(1, args.repeats))]
        vals = sorted(w["value"] for w in windows)
        n = len(vals)
        snap = srv.engine.stats_snapshot()
        result = {
            "metric": "serve_rtfx",
            # wall-clock audio s/s of the whole stack under load; the median
            # window with --repeats > 1
            "value": vals[n // 2],
            "unit": "audio_s/s",
            "windows": [w["value"] for w in windows],
            "window_wait_ms": [w.get("wait_ms") for w in windows],
            "iqr": [vals[n // 4], vals[(3 * n) // 4]] if n >= 4 else None,
            "engine_rtfx_device": snap.get("rtfx"),
            "stage_ms": snap.get("stage_ms"),
            "latency_ms": snap.get("latency_ms"),
            "mean_batch_size": snap.get("mean_batch_size"),
            "requests": sum(w["requests"] for w in windows),
            "errors": sum(w["errors"] for w in windows),
            "offered_concurrency": concurrency,
            "pipeline_depth": args.pipeline_depth,
            "audio_seconds_per_request": args.audio_seconds,
            "cold_start_s": _cold_start(build_s, first_request_s),
            "serving": "exported" if args.exported else "live",
            "platform": platform,
        }
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


def _stage_sum_ms(snap: dict, stage: str) -> float:
    """A stage's summed ms from a snapshot (which holds the mean a batch)."""
    if not snap.get("stage_ms") or not snap.get("batches"):
        return 0.0
    return snap["stage_ms"].get(stage, 0.0) * snap["batches"]


def _measured_window(post, srv, concurrency: int, duration_s: float) -> dict:
    """One window at `concurrency` clients: its wall-clock audio s/s,
    requests, errors and mean device wait a batch (ms)."""
    baseline = srv.engine.stats_snapshot()
    stop = time.time() + duration_s

    def client():
        while time.time() < stop:
            post()

    clients = [threading.Thread(target=client) for _ in range(concurrency)]
    t0 = time.time()
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    wall = time.time() - t0
    snap = srv.engine.stats_snapshot()
    audio_s = snap["audio_seconds"] - baseline["audio_seconds"]
    d_batches = snap["batches"] - baseline["batches"]
    d_wait = _stage_sum_ms(snap, "wait") - _stage_sum_ms(baseline, "wait")
    return {"value": round(audio_s / wall, 1) if wall > 0 else 0.0,
            "requests": snap["requests"] - baseline["requests"],
            "errors": snap["errors"] - baseline["errors"],
            "wait_ms": round(d_wait / d_batches, 1) if d_batches else None}


def _bench_stream(args, srv, t_boot, build_s, timeout_s, platform) -> dict:
    """Closed-loop streaming load: each client streams one utterance after
    another through /v1/transcribe/stream, reading partials while it
    uploads."""
    pcm = (np.random.default_rng(0).standard_normal(int(args.audio_seconds * 16000))
           * 3000).astype("<i2").tobytes()
    host, port = "127.0.0.1", srv.server_address[1]
    kw = dict(window_seconds=args.window_seconds, pace=args.pace, chunk_ms=args.chunk_ms,
              timeout_s=timeout_s)
    stream_post(host, port, pcm, **kw)
    first_request_s = time.perf_counter() - t_boot
    _warm(args, lambda: stream_post(host, port, pcm, **kw), "stream")
    baseline = srv.engine.stats_snapshot()

    stop = time.time() + args.duration_s
    records, errors = [], []
    lock = threading.Lock()

    def client():
        while time.time() < stop:
            try:
                r = stream_post(host, port, pcm, **kw)
                with lock:
                    records.append(r)
            except Exception as e:  # noqa: BLE001  counted in the window's errors
                with lock:
                    errors.append(str(e))

    clients = [threading.Thread(target=client) for _ in range(args.concurrency)]
    t0 = time.time()
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    wall = time.time() - t0
    snap = srv.engine.stats_snapshot()
    audio_s = snap["audio_seconds"] - baseline["audio_seconds"]
    first = [r["first_partial_ms"] for r in records if r["first_partial_ms"] is not None]
    result = {
        "metric": "serve_stream_rtfx",
        "value": round(audio_s / wall, 1) if wall > 0 else 0.0,
        "unit": "audio_s/s",
        # what a live-audio user feels: the first partial after the stream
        # starts, and the final transcript's wait once the audio ends
        "first_partial_ms": _percentiles(first),
        "final_after_eos_ms": _percentiles([r["final_after_eos_ms"] for r in records]),
        "partials_per_stream": (round(float(np.mean([r["partials"] for r in records])), 2)
                                if records else None),
        "streams": len(records),
        "errors": len(errors) + (snap["errors"] - baseline["errors"]),
        "mean_batch_size": snap.get("mean_batch_size"),
        "offered_concurrency": args.concurrency,
        "audio_seconds_per_request": args.audio_seconds,
        "pace": args.pace,
        "window_seconds": args.window_seconds,
        "cold_start_s": _cold_start(build_s, first_request_s),
        "serving": "exported" if args.exported else "live",
        "platform": platform,
    }
    if errors:
        result["first_error"] = errors[0]
    print(json.dumps(result), flush=True)
    return result


def _bench_direct(args, srv, t_boot, build_s, platform) -> dict:
    """Engine-level load: `concurrency` threads call engine.submit with
    decoded float32 audio; no sockets, no WAV parse, no JSON.  The gap to
    the HTTP mode is the Python web stack's cost on this host."""
    eng = srv.engine
    wave = (np.random.default_rng(0).standard_normal(int(args.audio_seconds * 16000))
            * 0.1).astype(np.float32)

    def submit(name: str):
        r = eng.submit(wave, name)
        if "error" in r:
            raise RuntimeError(r["error"])

    submit("warm0.wav")
    first_request_s = time.perf_counter() - t_boot
    _warm(args, lambda: submit("warm.wav"), "request")
    baseline = eng.stats_snapshot()
    stop = time.time() + args.duration_s
    failures = []

    def client(i):
        try:
            while time.time() < stop:
                submit(f"c{i}.wav")
        except RuntimeError as e:
            failures.append(e)

    clients = [threading.Thread(target=client, args=(i,)) for i in range(args.concurrency)]
    t0 = time.time()
    for t in clients:
        t.start()
    for t in clients:
        t.join()
    wall = time.time() - t0
    if failures:
        raise failures[0]
    snap = eng.stats_snapshot()
    audio_s = snap["audio_seconds"] - baseline["audio_seconds"]
    result = {
        "metric": "serve_direct_rtfx",
        "value": round(audio_s / wall, 1) if wall > 0 else 0.0,
        "unit": "audio_s/s",
        "stage_ms": snap.get("stage_ms"),
        "latency_ms": snap.get("latency_ms"),
        "mean_batch_size": snap.get("mean_batch_size"),
        "requests": snap["requests"] - baseline["requests"],
        "errors": snap["errors"] - baseline["errors"],
        "offered_concurrency": args.concurrency,
        "audio_seconds_per_request": args.audio_seconds,
        "pipeline_depth": args.pipeline_depth,
        "max_batch": args.max_batch,
        "cold_start_s": _cold_start(build_s, first_request_s),
        "serving": ("exported" if args.exported else "live") + "+direct",
        "platform": platform,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
