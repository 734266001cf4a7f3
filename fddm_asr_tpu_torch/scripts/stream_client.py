# -*- coding: utf-8 -*-
"""Client for the streaming endpoint (POST /v1/transcribe/stream).

    python -m fddm_asr_tpu_torch.scripts.stream_client --url http://127.0.0.1:8000 \\
        --wav clip.wav [--pace 1.0] [--window-seconds 5] [--chunk-ms 100]

Counterpart of `scripts/stream_client.py`: streams a WAV (any rate,
resampled to 16 kHz mono) to the server as pcm16 over a chunked upload,
paced at a real-time factor to stand in for a microphone, and prints each
NDJSON partial on stdout the moment it arrives, then the final aggregate.
The timing summary (time to the first partial, the final's latency after
the last byte) goes to stderr, so stdout stays machine-readable.  The
socket code is `bench_serve.stream_post`.  Host only.
"""
from __future__ import annotations

import argparse
import json
import sys
from urllib.parse import urlsplit

import numpy as np

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", required=True, help="server base URL, e.g. http://127.0.0.1:8000")
    ap.add_argument("--wav", required=True,
                    help="input WAV (any sample rate; resampled to 16 kHz mono before upload)")
    ap.add_argument("--pace", type=float, default=1.0,
                    help="upload at PACE x real time (0 = as fast as possible); default 1.0 "
                         "emulates live audio")
    ap.add_argument("--window-seconds", type=float, default=None,
                    help="commit window (server clamps to its max)")
    ap.add_argument("--chunk-ms", type=float, default=100.0,
                    help="upload slice size in audio milliseconds")
    ap.add_argument("--timeout-s", type=float, default=600.0)
    args = ap.parse_args(argv)

    from fddm_asr_tpu_torch.data.audio_io import load_audio
    from fddm_asr_tpu_torch.scripts.bench_serve import stream_post

    samples, _sr = load_audio(args.wav, target_sr=16000)
    pcm = (np.clip(samples, -1.0, 1.0) * 32767).astype("<i2").tobytes()
    u = urlsplit(args.url)

    def show(obj):
        print(json.dumps(obj, ensure_ascii=False), flush=True)

    rec = stream_post(u.hostname, u.port or 80, pcm, window_seconds=args.window_seconds,
                      pace=args.pace, chunk_ms=args.chunk_ms, timeout_s=args.timeout_s,
                      on_line=show)
    print(json.dumps({
        "audio_s": round(len(samples) / 16000.0, 2),
        "upload_s": round(rec["upload_s"], 2),
        "partials": rec["partials"],
        "first_partial_ms": (None if rec["first_partial_ms"] is None
                             else round(rec["first_partial_ms"], 1)),
        "final_after_eos_ms": round(rec["final_after_eos_ms"], 1),
    }), file=sys.stderr)
    return rec["final"]


if __name__ == "__main__":
    main()
