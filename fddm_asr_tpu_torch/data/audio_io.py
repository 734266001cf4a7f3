# -*- coding: utf-8 -*-
"""Audio reading and writing, resampling and long-form chunk planning without audio wheels.

Counterpart of `fddm_asr_tpu/data/audio_io.py`: PCM WAV (8/16/24/32-bit
int) through the stdlib `wave` module, 32/64-bit float and
WAVE_FORMAT_EXTENSIBLE through a minimal RIFF parser, from a path or a
binary file object (an upload); MP3/MP2 through libmpg123 (`data/mp3.py`),
then ffmpeg when it is on PATH, which also takes any other format; 16-bit
PCM writing, polyphase resampling with scipy, and the silence-aligned split
of a long recording into windows.
"""
from __future__ import annotations

import math
import os
import shutil
import struct
import subprocess
import wave
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

__all__ = ["load_wav", "save_wav", "resample", "load_audio", "to_wav_16k_mono",
           "silence_cut", "plan_silence_chunks"]


def _decode_pcm_int(raw: bytes, width: int, path: str) -> np.ndarray:
    if width == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if width == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    if width == 1:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    if width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (a[:, 0].astype(np.int32) | (a[:, 1].astype(np.int32) << 8)
                | (a[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        return ints.astype(np.float32) / float(1 << 23)
    raise ValueError(f"unsupported WAV sample width {width} in {path}")


def _load_wav_riff(src: Union[str, BinaryIO]) -> Tuple[np.ndarray, int]:
    """RIFF parser for the WAVs stdlib `wave` rejects: IEEE float (format
    tag 3) and WAVE_FORMAT_EXTENSIBLE wrapping float or PCM.  `src` is a
    path or a seekable binary file object, read from its start."""
    if hasattr(src, "read"):
        src.seek(0)
        buf, path = src.read(), "<bytes>"
    else:
        with open(src, "rb") as f:
            buf, path = f.read(), src
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(buf):
        cid = buf[pos:pos + 4]
        (size,) = struct.unpack("<I", buf[pos + 4:pos + 8])
        body = buf[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or data is None or len(fmt) < 16:
        raise ValueError(f"missing fmt/data chunk in {path}")
    tag, channels, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == 0xFFFE and len(fmt) >= 26:
        (tag,) = struct.unpack("<H", fmt[24:26])  # the SubFormat's format tag
    width = bits // 8
    frame = max(1, width * max(1, channels))
    data = data[: (len(data) // frame) * frame]
    if tag == 3:
        if width not in (4, 8):
            raise ValueError(f"unsupported float WAV width {bits} in {path}")
        samples = np.frombuffer(data, "<f4" if width == 4 else "<f8").astype(np.float32)
    elif tag == 1:
        samples = _decode_pcm_int(data, width, path)
    else:
        raise ValueError(f"unsupported WAV format tag {tag} in {path}")
    if channels > 1:
        samples = samples.reshape(-1, channels).T  # [C, T]
    return samples, int(sr)


def load_wav(src: Union[str, BinaryIO]) -> Tuple[np.ndarray, int]:
    """Read a WAV, from a path or a seekable binary file object -> (float32
    samples, [T] mono or [C, T], sample rate)."""
    try:
        with wave.open(src, "rb") as w:
            sr = w.getframerate()
            channels = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
    except wave.Error:
        return _load_wav_riff(src)
    data = _decode_pcm_int(raw, width, src if isinstance(src, str) else "<bytes>")
    if channels > 1:
        data = data.reshape(-1, channels).T
    return data, sr


def save_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """Write float samples in [-1, 1] ([T], or [C, T] mixed down to mono) as
    16-bit PCM: round(x * 32767), clipped."""
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 2:
        samples = samples.mean(axis=0)
    pcm = np.clip(np.round(samples * 32767.0), -32768, 32767).astype("<i2")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample(samples: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase windowed-sinc resampling (scipy.signal.resample_poly)."""
    if orig_sr == target_sr:
        return np.asarray(samples, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(np.asarray(samples, np.float64), target_sr // g, orig_sr // g,
                         axis=-1).astype(np.float32)


MPEG_EXTENSIONS = (".mp3", ".mp2", ".mpga")


def load_audio(path: str, target_sr: Optional[int] = None,
               mono: bool = True) -> Tuple[np.ndarray, int]:
    """Load a WAV natively, MP3/MP2 through libmpg123 (else ffmpeg), any
    other format through ffmpeg; mix down to mono and resample on request.
    Raises RuntimeError when no decoder for the format is present."""
    ext = os.path.splitext(path)[1].lower()
    ffmpeg = shutil.which("ffmpeg")
    if ext == ".wav":
        data, sr = load_wav(path)
    elif ext in MPEG_EXTENSIONS:
        from fddm_asr_tpu_torch.data.mp3 import decode_mp3, mpg123_available

        if mpg123_available():
            data, sr = decode_mp3(path)
        elif ffmpeg:
            return _load_via_ffmpeg(ffmpeg, path, target_sr, mono)
        else:
            raise RuntimeError(f"cannot decode {ext}: neither libmpg123 nor ffmpeg is "
                               f"available; convert {path} to WAV first")
    elif ffmpeg:
        return _load_via_ffmpeg(ffmpeg, path, target_sr, mono)
    else:
        raise RuntimeError(f"cannot decode {ext} without ffmpeg; convert {path} to WAV first")
    if mono and data.ndim == 2:
        data = data.mean(axis=0)
    if target_sr and sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return data, sr


def _load_via_ffmpeg(ffmpeg: str, path: str, target_sr: Optional[int],
                     mono: bool) -> Tuple[np.ndarray, int]:
    out_sr = target_sr or 16000
    proc = subprocess.run([ffmpeg, "-v", "error", "-i", path, "-f", "f32le",
                           "-ac", "1" if mono else "2", "-ar", str(out_sr), "-"],
                          capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg could not decode {path}: "
                           f"{proc.stderr.decode(errors='replace').strip()[-500:]}")
    data = np.frombuffer(proc.stdout, np.float32).copy()
    if not mono:
        data = data.reshape(-1, 2).T  # interleaved -> [C, T], as the WAV branch gives
    return data, out_sr


def to_wav_16k_mono(src: str, dst: str) -> float:
    """Convert any readable audio file to a 16 kHz mono 16-bit WAV at `dst`;
    returns its duration in seconds, or -1.0 when `src` cannot be read or
    `dst` written (preprocessing drops that clip)."""
    try:
        data, _ = load_audio(src, target_sr=16000, mono=True)
        save_wav(dst, data, 16000)
        return float(len(data)) / 16000.0
    except Exception:
        return -1.0


def silence_cut(window: np.ndarray, win: int, search: int = 16000, frame: int = 400) -> int:
    """Cut offset, window-relative in [frame, win], for one window holding at
    least `win` samples: the centre of the quietest `frame`-sample (25 ms)
    RMS frame inside the trailing `search` samples (clamped to win / 4 so
    short windows do not fragment)."""
    search = max(frame, min(search, win // 4))
    lo = max(frame, win - search)
    seg = np.asarray(window[lo:win], np.float32)
    nf = len(seg) // frame
    if nf >= 1:
        rms = np.sqrt(np.mean(seg[: nf * frame].reshape(nf, frame) ** 2, axis=1))
        cut = lo + int(np.argmin(rms)) * frame + frame // 2
    else:
        cut = win
    return max(frame, min(cut, win))  # forward progress, span <= win


def plan_silence_chunks(samples: np.ndarray, win: int, search: int = 16000,
                        frame: int = 400) -> list:
    """Long-form spans [(start, end)], each at most `win` samples, every cut
    at the quietest 25 ms frame in the last `search` samples of its window
    (`silence_cut`) rather than at the window's edge, so a cut falls in a
    pause and not mid-word.  Every window keeps the [rows, win] shape; only
    the lengths vary.  The last span may be shorter than 400 samples:
    callers clamp lengths to one conv receptive field."""
    n = len(samples)
    if n <= win:
        return [(0, n)]
    bounds = [0]
    pos = 0
    while n - pos > win:
        cut = pos + silence_cut(samples[pos:pos + win], win, search, frame)
        bounds.append(cut)
        pos = cut
    bounds.append(n)
    return list(zip(bounds[:-1], bounds[1:]))
