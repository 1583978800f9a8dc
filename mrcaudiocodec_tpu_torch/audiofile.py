"""WAV audio I/O (the port's own copy of the JAX package's spec/audiofile.py).

16/24/32-bit integer and float32 PCM WAV read; 16-bit PCM write.
Uses scipy.io.wavfile with a stdlib `wave` fallback.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def read_wav(path: str, raw_int16: bool = False):
    """-> (pcm [n, channels], fs).

    Returns float32 in [-1, 1]; with raw_int16=True, 16-bit sources are
    returned as int16 instead (the encoder converts them on the device as
    x * 2^-15: exact, and half the upload bytes)."""
    try:
        from scipy.io import wavfile
        fs, data = wavfile.read(path)
    except ImportError:                      # pragma: no cover
        import wave
        with wave.open(path, "rb") as wf:
            fs = wf.getframerate()
            raw = wf.readframes(wf.getnframes())
            data = np.frombuffer(raw, dtype=np.int16).reshape(
                -1, wf.getnchannels())
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype == np.int16:
        if raw_int16:
            return data, int(fs)
        x = data.astype(F32) / F32(32768.0)
    elif data.dtype == np.int32:
        x = data.astype(F32) / F32(2147483648.0)
    elif data.dtype == np.uint8:
        x = (data.astype(F32) - F32(128.0)) / F32(128.0)
    else:
        x = data.astype(F32)
    return x, int(fs)


def write_wav(path: str, x: np.ndarray, fs: int) -> None:
    """float32 [n] or [n, ch] in [-1, 1] (or ready int16) -> 16-bit WAV."""
    x = np.asarray(x)
    if x.dtype == np.int16:
        pcm = x
    else:
        x = x.astype(F32)
        pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
    try:
        from scipy.io import wavfile
        wavfile.write(path, fs, pcm)
    except ImportError:                      # pragma: no cover
        import wave
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        with wave.open(path, "wb") as wf:
            wf.setnchannels(pcm.shape[1])
            wf.setsampwidth(2)
            wf.setframerate(fs)
            wf.writeframes(pcm.tobytes())
