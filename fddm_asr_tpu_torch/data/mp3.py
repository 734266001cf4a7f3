# -*- coding: utf-8 -*-
"""MPEG audio (MP3, MP2) decoding through the system's libmpg123, by ctypes.

Counterpart of the decode side of `fddm_asr_tpu/data/mp3.py`: no wheel and
no ffmpeg, one call that returns float32 samples and the sample rate, from a
path or from bytes already read (mpg123's feed API decodes from memory).
MPEG-1/2/2.5 Layers I-III, the range Common Voice clips come in.  Where the
library is absent, `decode_mp3` raises and names it; `audio_io.load_audio`
then tries ffmpeg.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
from typing import Tuple, Union

import numpy as np

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_ENC_FLOAT_32 = 0x200
_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/usr/lib", "/usr/local/lib")

_mpg123 = None


def _find_mpg123():
    found = ctypes.util.find_library("mpg123")
    if found:
        return found
    for d in _LIB_DIRS:
        hits = sorted(glob.glob(os.path.join(d, "libmpg123.so*")))
        if hits:
            return hits[0]
    return None


def _load_mpg123():
    global _mpg123
    if _mpg123 is not None:
        return _mpg123
    path = _find_mpg123()
    if path is None:
        raise RuntimeError("libmpg123 not found: install mpg123 (or ffmpeg, which "
                           "audio_io.load_audio tries next) to decode MP3")
    lib = ctypes.CDLL(path)
    lib.mpg123_init()  # a no-op on current mpg123, required on old ones
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_getformat.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_plain_strerror.restype = ctypes.c_char_p
    lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
    _mpg123 = lib
    return lib


def mpg123_available() -> bool:
    try:
        _load_mpg123()
        return True
    except (RuntimeError, OSError):
        return False


def decode_mp3(src: Union[str, bytes, os.PathLike]) -> Tuple[np.ndarray, int]:
    """An MP3 path or its bytes -> (float32 samples in [-1, 1], sample rate):
    [n] for mono, [channels, n] otherwise, as `audio_io.load_wav` returns.

    The output stays in the library's negotiated encoding (signed 16-bit on
    common builds) and is converted here: forcing float output through the
    feed API corrupts it on some libmpg123 versions."""
    lib = _load_mpg123()
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            payload = f.read()
    else:
        payload = bytes(src)
    if not payload:
        raise ValueError("empty MP3 input")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed: {lib.mpg123_plain_strerror(err.value).decode()}")
    try:
        if lib.mpg123_open_feed(h) != _MPG123_OK:
            raise RuntimeError("mpg123_open_feed failed")
        if lib.mpg123_feed(h, payload, len(payload)) != _MPG123_OK:
            raise RuntimeError("mpg123_feed failed")
        rate, channels, enc = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
        done = ctypes.c_size_t(0)
        buf = (ctypes.c_ubyte * 65536)()
        chunks, fmt = [], None
        while True:
            ret = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[:done.value]))
            if ret == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                     ctypes.byref(enc))
                now = (rate.value, channels.value, enc.value)
                if fmt is None:
                    fmt = now
                elif now != fmt:
                    break  # a stream that changes format: keep what the first one decoded
            elif ret in (_MPG123_DONE, _MPG123_NEED_MORE):
                break  # NEED_MORE after the whole feed is the end of the stream
            elif ret != _MPG123_OK:
                raise RuntimeError(
                    f"mpg123_read failed: {lib.mpg123_plain_strerror(ret).decode()}")
        if fmt is None or not chunks:
            raise ValueError("no decodable MPEG audio frames in input")
        out_rate, out_channels, out_enc = fmt
        raw = b"".join(chunks)
        if out_enc & _ENC_FLOAT_32:
            data = np.frombuffer(raw, dtype=np.float32).astype(np.float32)
        else:
            usable = len(raw) - len(raw) % (2 * out_channels)
            data = np.frombuffer(raw[:usable], dtype="<i2").astype(np.float32) / 32768.0
        if out_channels > 1:
            data = data.reshape(-1, out_channels).T
        return np.ascontiguousarray(data), int(out_rate)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
